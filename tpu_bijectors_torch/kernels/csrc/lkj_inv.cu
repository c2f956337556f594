// LKJ / correlation-matrix inverse link for Hopper (sm_90a): from the
// packed unconstrained vector y (length K(K-1)/2, column-major strict upper
// triangle) of each batch element, the correlation matrix X = W'W, the
// inverse-link log-det logJ (with the VecCorr diagonal-coefficient term)
// and log diag W, where W is the upper Cholesky factor of X.
//
// Replaces the TPU kernel tpu_bijectors/kernels/lkj.py::lkj_inverse_pallas.
// Numerics are those of the plain version
// (tpu_bijectors_torch/kernels/lkj.py: _inv_link_chol_lkj_with_logdiag
// and pd_from_upper): t = tanh(y), the stable logcosh
// |y| + log1p(exp(-2|y|)) - log 2, a running sum lr = -sum logcosh down
// each column, W_ij = t_ij exp(lr before row i), W_jj = exp(lr), and
// log W_jj = lr taken from the running sum, never from log(exp(.)).
//
// Layout: y is read through its two strides (batch, slot), so a
// batch-major slice of a (B, dim) tensor and the swapped view of the
// transposed (dim, B) state are both read in place. X (B, K, K),
// log diag W (B, K) and, on request, W (B, K, K) are written batch-major.
//
// Bound on the card: memory. At K = 16 an element reads 120 floats and
// writes 256 + 16 + 1 (and 256 more with W), against 120 tanh/exp/log1p
// chains and 816 multiply-adds for X; at B = 131072 that is 206.0 MB, 61.5
// us at 3.35 TB/s (340.3 MB, 101.6 us with W), while the multiply-adds
// take about 3.2 us at the float32 peak. So the design moves the bytes well
// and keeps enough warps busy (link_tiles.cuh):
// - each element is a half-warp's (K <= 16; a warp's above), its work split
//   over the lanes: tanh and logcosh of every slot, the column running sums
//   (adds only, a lane a column), W_ij = t exp(lr) over the slots, logJ a
//   sum over the lanes;
// - its factor lives in a K x K tile of shared memory, element-major and
//   padded so that the two elements of a warp use disjoint banks: 16
//   elements take 50 KB, and four such blocks (32 warps) share an SM;
// - X is formed row by row from that tile, never mirrored (link::gram:
//   exactly symmetric), and X and W leave as whole K x K tiles, one TMA bulk
//   store each; only log diag W and logJ are written by lanes;
// - a block stays resident and walks its tiles, the next tile's y loaded
//   by cp.async (coalesced along whichever stride is 1) while it works;
// - the block size follows B: at a sampler's B = 64 a block holds two
//   elements, so the batch spreads over 32 SMs.
// Where one element's tiles pass a block's shared memory (K > 138 on the
// H100), a warp walks one element's columns with W packed in shared memory
// (K(K+1)/2 floats, within the block's 232448 bytes up to K = 340; the
// wrapper takes K <= 337) and writes X and W row by row from its lanes.

#include "link_tiles.cuh"

#include <cmath>

namespace tbt {
namespace {

using link::tri;

// X and W leave by TMA bulk stores; 16-byte stores from shared memory
// (false) are timed beside them in PERF.md
constexpr bool kBulkStore = true;

constexpr float kLog2 = 0.693147180559945309f;

__device__ __forceinline__ float logcosh(float v) {
  const float a = fabsf(v);
  return a + log1pf(expf(-2.0f * a)) - kLog2;
}

// tiles: 0 the factor W, 1 X (first the scratch of t). U's zeros below the
// diagonal are written once: no tile writes there again. KS = K when it is
// known at compile time (16, a half-warp an element): the slot loops then
// unroll, and each lane keeps in registers the tile offsets of its NM slots
// for every tile the block walks, and their t from the first pass to the
// last.
template <bool WANT_W, int KS>
__global__ void __launch_bounds__(link::kMaxThreads)
lkj_inv_tiled(const float* __restrict__ y, long long sb, long long sp,
              float* __restrict__ X, float* __restrict__ logJ,
              float* __restrict__ ldw, float* __restrict__ Wout, link::Shape s, long long B) {
  extern __shared__ __align__(16) float smem[];
  const int K = KS ? KS : s.K, Kp = KS ? KS : s.Kp, P = K * (K - 1) / 2;
  const int G = link::group_lanes(K);
  const int e = threadIdx.x / G, l = threadIdx.x % G;
  float* U = smem + e * s.Fs;
  float* Xt = smem + (s.E + e) * s.Fs;
  for (int i = threadIdx.x; i < s.E * s.Fs; i += blockDim.x) smem[i] = 0.0f;
  // slot q = l + m G is W's (i, j) at offset i Kp + j
  constexpr int NM = KS ? (KS * (KS - 1) / 2 + 15) / 16 : 1;
  int at[NM];
  float t[NM];
  if constexpr (KS > 0) {
    for (int m = 0, j = 1; m < NM; ++m) {
      const int q = min(l + m * G, P - 1);
      while (tri(j) <= q) ++j;
      at[m] = (q - tri(j - 1)) * Kp + j;
    }
  }
  link::for_each_tile<kBulkStore>(y, sb, sp, B, s, smem + 2 * s.E * s.Fs,
                      [&](float* ybuf, long long b0, int n) {
    const bool live = e < n;
    float* ys = ybuf + e * s.Pp;
    // t and logcosh of every slot; the slot then holds logcosh
    if constexpr (KS > 0) {
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int q = l + m * G;
        if (q < P) {
          const float v = ys[q];
          t[m] = tanhf(v);
          ys[q] = logcosh(v);
        }
      }
    } else {
      for (int q = l; q < P; q += G) {
        const float v = ys[q];
        Xt[q] = tanhf(v);
        ys[q] = logcosh(v);
      }
    }
    __syncwarp();
    // lane j walks column j's running sum, leaving lr before each row in its
    // slot; the diagonal and log diag W from the sum at the bottom
    float lj = 0.0f;
    for (int j = l; j < K; j += G) {
      float* col = ys + tri(j - 1);
      float lr = 0.0f;
#pragma unroll
      for (int i = 0; i < (KS ? KS - 1 : j); ++i) {
        if (i < j) {
          const float lc = col[i];
          col[i] = lr;
          lr -= lc;
          lj += lr;
        }
      }
      U[j * Kp + j] = expf(lr);
      if (live) ldw[(b0 + e) * K + j] = lr;
      lj += lr * (float)(K - j);  // the diagonal term, 1 + (K-1-j) times
    }
    lj = link::group_sum(lj, G);
    if (live && l == 0) logJ[b0 + e] = lj;
    __syncwarp();
    // W_ij = t exp(lr) over the slots (slot q of column j, row
    // i = q - tri(j-1))
    if constexpr (KS > 0) {
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int q = l + m * G;
        if (q < P) U[at[m]] = t[m] * expf(ys[q]);
      }
    } else {
      for (int q = l, j = 1; q < P; q += G) {
        while (tri(j) <= q) ++j;
        U[(q - tri(j - 1)) * Kp + j] = Xt[q] * expf(ys[q]);
      }
    }
    __syncwarp();
    link::gram<KS>(link::TileU{U, Kp}, K, l, G,
                   [&](int a, int c, float v) { Xt[a * Kp + c] = v; });
    link::tiles_written<kBulkStore>();
    link::store_tile<kBulkStore>(X, smem, 1, b0, n, s);
    if (WANT_W) link::store_tile<kBulkStore>(Wout, smem, 0, b0, n, s);
  });
}

// one warp an element, W packed by columns in shared memory
template <bool WANT_W>
__global__ void __launch_bounds__(32)
lkj_inv_packed(const float* __restrict__ y, long long sb, long long sp,
               float* __restrict__ X, float* __restrict__ logJ,
               float* __restrict__ ldw, float* __restrict__ Wout, int K) {
  extern __shared__ __align__(16) float fac[];
  const long long b = blockIdx.x;
  const int l = threadIdx.x;
  const float* yb = y + b * sb;
  float lj = 0.0f;
  for (int j = l; j < K; j += 32) {
    const long long base = tri(j - 1);
    float lr = 0.0f;
    for (int i = 0; i < j; ++i) {
      const float v = yb[(base + i) * sp];
      fac[tri(j) + i] = tanhf(v) * expf(lr);
      lr -= logcosh(v);
      lj += lr;
    }
    fac[tri(j) + j] = expf(lr);
    ldw[b * K + j] = lr;
    lj += lr * (float)(K - j);
  }
  lj = link::group_sum(lj, 32);
  if (l == 0) logJ[b] = lj;
  __syncwarp();
  const long long KK = (long long)K * K;
  float* Xb = X + b * KK;
  link::gram<0>(link::PackedU{fac, K}, K, l, 32, [&](int a, int c, float v) { Xb[a * K + c] = v; });
  if (WANT_W) {
    float* Wb = Wout + b * KK;
    for (int a = 0; a < K; ++a)
      for (int c = l; c < K; c += 32) Wb[a * K + c] = a <= c ? fac[tri(c) + a] : 0.0f;
  }
}

template <bool WANT_W>
cudaError_t launch(const float* y, long long sb, long long sp, float* X, float* logJ,
                   float* ldw, float* Wout, int K, long long B, cudaStream_t stream) {
  const link::Shape s = link::shape(K, K * (K - 1) / 2, 2, B);
  if (s.E > 0)
    return link::launch_tiles(K == 16 ? lkj_inv_tiled<WANT_W, 16> : lkj_inv_tiled<WANT_W, 0>,
                              s, B, stream, y, sb, sp, X, logJ, ldw, Wout, s, B);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t bytes = sizeof(float) * (size_t)tri(K);
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lkj_inv_packed<WANT_W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  lkj_inv_packed<WANT_W><<<(unsigned)B, 32, bytes, stream>>>(y, sb, sp, X, logJ, ldw, Wout, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tbt

extern "C" {

// y (B, K(K-1)/2) with element strides (sb, sp) -> X (B, K, K), logJ (B,),
// log diag W (B, K), and W (B, K, K) when Wout is not null; all outputs
// contiguous. Launches on `stream`, does not synchronise, returns the
// cudaError_t (cudaErrorInvalidValue where one element's factor passes the
// block's shared memory).
int tbt_lkj_inverse(const float* y, long long sb, long long sp, float* X, float* logJ,
                    float* ldw, float* Wout, int K, long long B, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (Wout) return (int)tbt::launch<true>(y, sb, sp, X, logJ, ldw, Wout, K, B, st);
  return (int)tbt::launch<false>(y, sb, sp, X, logJ, ldw, Wout, K, B, st);
}
}
