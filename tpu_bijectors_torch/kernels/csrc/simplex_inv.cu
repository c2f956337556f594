// Stick-breaking simplex inverse for Hopper (sm_90a): one pass over the
// K-1 unconstrained coordinates of each batch element gives the simplex
// point x, the inverse log-det, and optionally the Dirichlet data term
// wlog = sum_k am1[k] log(x_k + eps).
//
// Replaces two TPU kernels of tpu_bijectors/kernels/simplex.py:
// _simplex_fused_pallas (entries simplex_inverse_logdet_pallas and
// simplex_inverse_logdet_wlog_pallas; C entry tbt_simplex_inverse_logdet)
// and simplex_inverse_pallas, x alone (C entry tbt_simplex_inverse: the
// same designs without the log-det and wlog arithmetic). Numerics are those
// of the plain version (tpu_bijectors_torch/kernels/simplex.py:
// simplex_inverse_plain and _inverse_logdet_from_x): the same eps algebra,
// the same per-step clamps, the log-det from the running sum of x.
//
// Layout: y is read through its two strides (batch, coordinate), so a
// batch-major slice v[:, s:s+n] of a (B, dim) tensor and the swapped view
// vT[s:s+n, :].T of the transposed (dim, B) state are both read in place;
// it is staged in shared memory by cp.async, coalesced along whichever
// stride is 1 (link_tiles.cuh). x is written batch-major (B, K), as the
// JAX function returns it, by coalesced stores.
//
// Bound on the card: at K = 16 and B = 131072 the kernel moves 16.8 MB
// (about 5 us at 3.35 TB/s; x alone 16.3 MB, 4.9 us), but each coordinate
// takes an accurate expf, a reciprocal, two IEEE divisions and two logf (the
// log-det's three logs taken as one of their product), 150-190 SASS
// instructions in the wide design's loop (tools/sass_loops.py), so issue
// bounds it first (PERF.md). Two designs, chosen by the wrapper from the
// batch (kernels/simplex.py::simplex_design):
//
// - small (a sampler's 64 chains): a group of G lanes an element (G = 16
//   while K-1 <= 16, else a warp; above G coordinates the lanes loop over
//   chunks of G), blocks sized as link::shape does, so 64 elements spread
//   over 32 SMs. Lane k forms z_k = logistic(y_k - lc_k) (the only expf and
//   reciprocal, side by side); every lane walks the serial chain s_k -> x_k
//   on the z's gathered by shuffles, keeping its own x_k and s_k; then lane
//   k forms its log-det and wlog terms, and the group sums them by
//   link::group_sum. The chain's arithmetic is the other design's, so x is
//   the same bit for bit; ld and wlog are summed in another order.
// - wide (large B): a thread an element walks the chain in registers, as
//   the TPU kernel's lanes do, on y staged in shared memory; x goes to a
//   shared tile and leaves by coalesced 16-byte stores. Where a block of 32
//   elements does not fit in shared memory (K above about 590) the group
//   design serves.
//
// Neither design limits K: where even one element's staged y does not fit
// (K-1 above about 29000), the group design reads y from device memory.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

#include "link_tiles.cuh"

namespace tbt {
namespace {

constexpr int kWideThreads = 128;  // elements (and threads) a block of the wide design
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = FLT_EPSILON;
constexpr float kC12 = 1.0f - 2.0f * kEps;  // exact in float32
constexpr float kC1p = 1.0f + kEps;

// NaN-propagating clamp and max, as torch.clamp / torch.maximum
__device__ __forceinline__ float clamp01(float v) {
  return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
}
__device__ __forceinline__ float maxp(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// z_k = logistic(y_k - lc_k); lc[k] = log(K-1-k), rounded from double on the
// host (the plain version's table)
__device__ __forceinline__ float logistic(float y, float lc) {
  return 1.0f / (1.0f + expf(-(y - lc)));
}

// x_k from the running sum s of x_0..x_{k-1} and z_k; `first`: k = 0.
// __fmul_rn: no fused multiply-add, the plain version rounds twice.
__device__ __forceinline__ float stick(bool first, float s, float z) {
  const float q = (first ? z - kEps : kC1p - s) / kC12;
  return first ? clamp01(q) : clamp01(__fmul_rn(q, z) - kEps);
}

// coordinate k's term of the inverse log-det, from x_k and s: the plain
// version's log(max(z, eps)) + log(max(1 - z, eps)) + log(rem) as one logf of
// the product (each factor in [eps, 1], so the product in [eps^3, 1]): a
// logf is about 20 instructions, and issue bounds the wide design
__device__ __forceinline__ float ld_term(bool first, float s, float xk) {
  if (first) return logf(maxp(xk, kEps) * maxp(1.0f - xk, kEps));
  const float rem = maxp(1.0f - s, kEps);
  const float zl = xk / rem;
  return logf(maxp(zl, kEps) * maxp(1.0f - zl, kEps) * rem);
}

// The small design: lane l of the G lanes owning element b (`live`: b < B;
// a dead group computes alongside, for the shuffles, and writes nothing).
// yk(k) gives y_k; lc0 and am0 are lc[l] and am1[l], loaded once before
// the tiles. The lanes take the K coordinates of x in chunks of G, lane l
// coordinate c0 + l; each lane sums its terms in k order, then the group
// sums the lanes.
template <int G, class Y>
__device__ __forceinline__ void group_element(Y yk, const float* __restrict__ lc,
                                              const float* __restrict__ am1, float lc0,
                                              float am0, float* __restrict__ x,
                                              float* __restrict__ ld, float* __restrict__ wlog,
                                              int Km1, long long b, bool live, int l) {
  const int K = Km1 + 1;
  float s = 0.0f, lp = 0.0f, wl = 0.0f;
  for (int c0 = 0; c0 < K; c0 += G) {
    const int k = c0 + l;
    const float z = k < Km1 ? logistic(yk(k), c0 == 0 ? lc0 : __ldg(lc + k)) : 0.0f;
    const int steps = min(G, Km1 - c0);
    float xk = 0.0f, pre = 0.0f;  // this lane's x_k and s_k
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < steps) {
        const float xj = stick(c0 + j == 0, s, __shfl_sync(kFull, z, j, G));
        if (j == l) {
          xk = xj;
          pre = s;
        }
        s += xj;
      }
    }
    if (k == Km1) xk = clamp01(1.0f - s);
    if (k < K) {
      if (ld && k < Km1) lp += ld_term(k == 0, pre, xk);
      if (wlog) wl += (c0 == 0 ? am0 : __ldg(am1 + k)) * logf(xk + kEps);
      if (x && live) x[b * K + k] = xk;
    }
  }
  if (ld) {
    lp = link::group_sum(lp, G);
    if (live && l == 0) ld[b] = lp;
  }
  if (wlog) {
    wl = link::group_sum(wl, G);
    if (live && l == 0) wlog[b] = wl;
  }
}

// the small design; STAGED: y staged by link::for_each_tile (else read from
// device memory, for a K whose y does not fit in shared memory)
template <int G, bool STAGED>
__global__ void __launch_bounds__(link::kMaxThreads)
simplex_group_kernel(const float* __restrict__ y, long long sb, long long sk,
                     const float* __restrict__ lc, const float* __restrict__ am1,
                     float* __restrict__ x, float* __restrict__ ld, float* __restrict__ wlog,
                     link::Shape s, long long B) {
  extern __shared__ __align__(16) float smem[];
  const int e = threadIdx.x / G, l = threadIdx.x % G, Km1 = s.P;
  const float lc0 = l < Km1 ? __ldg(lc + l) : 0.0f;
  const float am0 = am1 && l <= Km1 ? __ldg(am1 + l) : 0.0f;
  if constexpr (STAGED) {
    link::for_each_tile<false>(y, sb, sk, B, s, smem, [&](float* ybuf, long long b0, int n) {
      const float* ys = ybuf + e * s.Pp;
      group_element<G>([&](int k) { return ys[k]; }, lc, am1, lc0, am0, x, ld, wlog, Km1,
                       b0 + e, e < n, l);
      __syncthreads();  // every group is done with ys before it is loaded again
    });
  } else {
    for (long long b0 = (long long)blockIdx.x * s.E; b0 < B; b0 += (long long)gridDim.x * s.E) {
      const long long b = b0 + e;
      const float* yb = y + (b < B ? b : 0) * sb;
      group_element<G>([&](int k) { return __ldg(yb + k * sk); }, lc, am1, lc0, am0, x, ld, wlog,
                       Km1, b, b < B, l);
    }
  }
}

// The wide design: thread e walks element b0 + e of the block's tile in
// registers, on y staged at s.Pp floats an element; x goes to a shared tile
// (row stride s.Fs) that the block then writes whole.
template <bool WANT_X, bool WLOG, bool LOGDET>
__global__ void __launch_bounds__(kWideThreads)
simplex_wide_kernel(const float* __restrict__ y, long long sb, long long sk,
                    const float* __restrict__ lc, const float* __restrict__ am1,
                    float* __restrict__ x, float* __restrict__ ld, float* __restrict__ wlog,
                    link::Shape s, long long B) {
  extern __shared__ __align__(16) float smem[];
  const int e = threadIdx.x, Km1 = s.P, K = Km1 + 1;
  float* xe = smem + e * s.Fs;
  link::for_each_tile<false>(y, sb, sk, B, s, smem + s.E * s.Fs,
                             [&](float* ybuf, long long b0, int n) {
    const float* ys = ybuf + e * s.Pp;
    float sum = 0.0f, lp = 0.0f, wl = 0.0f;
    for (int k = 0; k < Km1; ++k) {
      const float xk = stick(k == 0, sum, logistic(ys[k], __ldg(lc + k)));
      if (LOGDET) lp += ld_term(k == 0, sum, xk);
      if (WANT_X) xe[k] = xk;
      if (WLOG) wl += __ldg(am1 + k) * logf(xk + kEps);
      sum += xk;
    }
    const float xl = clamp01(1.0f - sum);
    if (WANT_X) xe[Km1] = xl;
    if (e < n) {
      if (WLOG) wlog[b0 + e] = wl + __ldg(am1 + Km1) * logf(xl + kEps);
      if (LOGDET) ld[b0 + e] = lp;
    }
    __syncthreads();  // the x tile is whole, and every thread is done with ys
    if (WANT_X) link::store_rows(x, K, 1, smem, s.Fs, b0, n, K);
  });
}

size_t smem_optin() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)optin;
}

// the small design: link::shape's blocks (two y buffers of P = K-1 floats
// an element, no K x K tiles), or, where one element's y does not fit,
// eight warps of unstaged elements
cudaError_t launch_group(const float* y, long long sb, long long sk, const float* lc,
                         const float* am1, float* x, float* ld, float* wlog, int Km1,
                         long long B, cudaStream_t st) {
  link::Shape s = link::shape(Km1, Km1, 0, B);
  if (s.E > 0) {
    if (link::group_lanes(Km1) == 16)
      return link::launch_tiles(simplex_group_kernel<16, true>, s, B, st, y, sb, sk, lc, am1, x,
                                ld, wlog, s, B);
    return link::launch_tiles(simplex_group_kernel<32, true>, s, B, st, y, sb, sk, lc, am1, x,
                              ld, wlog, s, B);
  }
  s.E = link::kMaxThreads / 32;
  s.Pp = 0;  // nothing staged: no shared memory
  return link::launch_tiles(simplex_group_kernel<32, false>, s, B, st, y, sb, sk, lc, am1, x, ld,
                            wlog, s, B);
}

// the wide design's shape: kWideThreads elements a block, halved while the
// block's y buffers and x tile do not fit; E = 0 below a warp
link::Shape wide_shape(int Km1) {
  link::Shape s{};
  s.K = Km1 + 1;
  s.P = Km1;
  s.Pp = Km1 | 1;       // odd: the threads' rows on distinct banks
  s.Fs = (Km1 + 1) | 1;
  s.tiles = 1;
  const size_t optin = smem_optin();
  auto bytes = [&](int E) { return sizeof(float) * (size_t)E * (s.Fs + 2 * s.Pp); };
  s.E = kWideThreads;
  while (s.E >= 32 && bytes(s.E) > optin) s.E /= 2;
  if (s.E < 32) s.E = 0;
  return s;
}

template <bool WANT_X, bool WLOG, bool LOGDET>
cudaError_t launch_wide(const float* y, long long sb, long long sk, const float* lc,
                        const float* am1, float* x, float* ld, float* wlog, int Km1, long long B,
                        cudaStream_t st) {
  const link::Shape s = wide_shape(Km1);
  if (s.E == 0) return launch_group(y, sb, sk, lc, am1, x, ld, wlog, Km1, B, st);
  const size_t bytes = sizeof(float) * (size_t)s.E * (s.Fs + 2 * s.Pp);
  return link::launch_blocks(simplex_wide_kernel<WANT_X, WLOG, LOGDET>, s.E, bytes,
                             (B + s.E - 1) / s.E, st, y, sb, sk, lc, am1, x, ld, wlog, s, B);
}

}  // namespace
}  // namespace tbt

extern "C" {

// y (B, K-1) with element strides (sb, sk) and the table lc (K-1,) of
// log(K-1-k) -> ld (B,), and x (B, K) contiguous when x is not null, and
// wlog (B,) from am1 (K,) when am1 is not null; `small` picks the small
// design (else the wide one). Launches on `stream`, does not synchronise,
// returns the cudaError_t.
int tbt_simplex_inverse_logdet(const float* y, long long sb, long long sk, const float* lc,
                               const float* am1, float* x, float* ld, float* wlog, int Km1,
                               int small, long long B, void* stream) {
  using namespace tbt;
  if (Km1 < 1 || ld == nullptr || (am1 == nullptr) != (wlog == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (small) return (int)launch_group(y, sb, sk, lc, am1, x, ld, wlog, Km1, B, st);
  if (x && am1) return (int)launch_wide<true, true, true>(y, sb, sk, lc, am1, x, ld, wlog, Km1, B, st);
  if (x) return (int)launch_wide<true, false, true>(y, sb, sk, lc, am1, x, ld, wlog, Km1, B, st);
  if (am1) return (int)launch_wide<false, true, true>(y, sb, sk, lc, am1, x, ld, wlog, Km1, B, st);
  return (int)launch_wide<false, false, true>(y, sb, sk, lc, am1, x, ld, wlog, Km1, B, st);
}

// y (B, K-1) with element strides (sb, sk) and the table lc (K-1,) -> x
// (B, K) contiguous, with no log-det; `small` as above. Launches on
// `stream`, does not synchronise, returns the cudaError_t.
int tbt_simplex_inverse(const float* y, long long sb, long long sk, const float* lc, float* x,
                        int Km1, int small, long long B, void* stream) {
  using namespace tbt;
  if (Km1 < 1 || x == nullptr) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (small) return (int)launch_group(y, sb, sk, lc, nullptr, x, nullptr, nullptr, Km1, B, st);
  return (int)launch_wide<true, false, false>(y, sb, sk, lc, nullptr, x, nullptr, nullptr, Km1,
                                              B, st);
}
}
