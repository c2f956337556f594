// LKJ / correlation-matrix inverse-link log-det for Hopper (sm_90a): from
// the packed unconstrained vector y (length P = K(K-1)/2, column-major
// strict upper triangle) of each batch element, the inverse-link log-det
// logJ and log diag W, where W is the upper Cholesky factor of X = W'W,
// without forming W or X. The LKJ density needs only log diag W.
//
// Replaces the TPU kernel tpu_bijectors/kernels/lkj.py::lkj_logdet_pallas.
// Numerics are those of the TPU kernel and of the plain version
// (tpu_bijectors_torch/kernels/lkj.py: lkj_logdet_plain): the stable
// logcosh |y| + softplus(-2|y|) - log 2 (softplus(-2|y|) is
// log1p(exp(-2|y|)) for a non-positive argument), a running sum
// lr = -sum logcosh down each column, logJ += lr after every slot, and
// logJ += lr (1 + c_j) once per column, with c_j = K-1-j (the VecCorr
// diagonal coefficients [0, K-2, ..., 0]; chol = 0) or c_j = 0 (the
// Cholesky variant; chol = 1). log W_jj = lr at the column's end, never
// log(exp(.)).
//
// Layout: y is read through its two strides (batch, slot), so a
// batch-major slice of a (B, dim) tensor and the swapped view of the
// transposed (dim, B) state are both read in place (the TPU kernel's
// pre_t flag). logJ (B,) and log diag W (B, K) are written batch-major.
//
// Bound on the card: an element reads P floats and writes K + 1; at K = 16
// and B = 131072 that is 71.8 MB, about 21.4 us at 3.35 TB/s. But the
// logcosh of a slot (an accurate expf and log1pf, the latter with a branch
// for its special arguments) is some 45 instructions, 15.7M of them at that
// size, so issue bounds it first (PERF.md). Every design walks each element
// in the order above, one thread the whole element, so all three give the
// same bits:
//
// - direct, unrolled (K <= 8): thread b walks element b with K known at
//   compile time, its loads from device memory;
// - direct, loads ahead (larger K at a batch that fills the card): thread b
//   walks element b in one loop over its slots, loading the next kAhead
//   slots while it takes the logcosh of these, so that several loads of
//   each thread are in flight;
// - staged (larger K at a smaller batch): a block walks tiles of E
//   elements (link::for_each_tile: the next tile's y on its way into shared
//   memory by cp.async while the block works on this one); the block's
//   threads take the logcosh of every staged slot in place, neighbouring
//   threads on neighbouring slots, so that a small batch still keeps every
//   thread busy; then thread e walks element e's running sums on them
//   (unrolled for K <= 16); log diag W goes to a shared tile and leaves by
//   16-byte stores. Where a block of 32 elements does not fit in shared
//   memory (K above 42) the direct design serves. No K limit.

#include <cuda_runtime.h>

#include <cmath>

#include "link_tiles.cuh"

namespace tbt {
namespace {

constexpr int kThreads = 256;          // at most, a block of any design
constexpr int kBlocksPerSm = 3;        // the staged design's blocks an SM, where they fit
constexpr int kMaxUnrolled = 16;       // the largest K of an unrolled staged walk
constexpr int kMaxUnrolledDirect = 8;  // the largest K of an unrolled direct walk
constexpr int kAhead = 4;              // slots the direct design loads ahead of its walk
// the smallest batch the direct design serves at K > kMaxUnrolledDirect
// (the crossover measured in PERF.md)
constexpr long long kDirectMinB = 32768;
constexpr float kLog2 = 0.693147180559945309f;

__device__ __forceinline__ float logcosh(float y) {
  const float a = fabsf(y);
  return a + log1pf(expf(-2.0f * a)) - kLog2;
}

// One element's walk: lc(q) gives the logcosh of slot q; log diag W goes to
// ldw_row[0..K-1]; returns logJ. KS > 0: K = KS, the loops unrolled.
template <bool CHOL, int KS, class LC>
__device__ __forceinline__ float walk(LC lc, int Kr, float* ldw_row) {
  const int K = KS > 0 ? KS : Kr;
  float lj = 0.0f;
  ldw_row[0] = 0.0f;
  int slot = 0;
#pragma unroll
  for (int j = 1; j < K; ++j) {
    float lr = 0.0f;  // -sum of logcosh down column j so far
#pragma unroll
    for (int i = 0; i < j; ++i, ++slot) {
      lr -= lc(slot);
      lj += lr;
    }
    ldw_row[j] = lr;
    lj += lr * (CHOL ? 1.0f : (float)(K - j));  // 1 + c_j
  }
  return lj;
}

// The staged design: s.E elements a tile, y at s.Pp floats an element,
// log diag W in a tile of row stride s.Fs = K|1 ahead of the y buffers.
template <bool CHOL, int KS>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
lkj_logdet_tiles(const float* __restrict__ y, long long sb, long long sp,
                 float* __restrict__ logJ, float* __restrict__ ldw, link::Shape s, long long B) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x, K = KS > 0 ? KS : s.K;
  link::for_each_tile<false, true>(y, sb, sp, B, s, smem + s.E * s.Fs,
                                   [&](float* ybuf, long long b0, int n) {
    for (int i = tid; i < n * s.Pp; i += nt) ybuf[i] = logcosh(ybuf[i]);
    __syncthreads();  // every staged slot holds its logcosh
    if (tid < n) {
      const float* lc = ybuf + tid * s.Pp;
      logJ[b0 + tid] = walk<CHOL, KS>([&](int q) { return lc[q]; }, K, smem + tid * s.Fs);
    }
    __syncthreads();  // the log diag W tile is whole, and every thread is done with ybuf
    link::store_rows(ldw, K, 1, smem, s.Fs, b0, n, K);
  });
}

// The direct design: thread b walks element b, reading y from device
// memory (ROWS: sp = 1), and writes its log diag W row itself. KS > 0: K =
// KS, the walk unrolled; else one loop over the slots, the next kAhead
// slots' loads issued before this chunk's logcosh, and a column's end
// found as the walk reaches it (the same operations in the same order).
template <bool CHOL, int KS, bool ROWS>
__global__ void __launch_bounds__(kThreads)
lkj_logdet_direct(const float* __restrict__ y, long long sb, long long sp,
                  float* __restrict__ logJ, float* __restrict__ ldw, int K, long long B) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* yb = y + b * sb;
  auto at = [&](int q) { return yb[ROWS ? q : q * sp]; };
  float* lb = ldw + b * K;
  if constexpr (KS > 0) {
    logJ[b] = walk<CHOL, KS>([&](int q) { return logcosh(at(q)); }, K, lb);
    return;
  }
  const int P = K * (K - 1) / 2;
  float cur[kAhead], nxt[kAhead];
  auto load = [&](float* v, int q) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) v[u] = q + u < P ? at(q + u) : 0.0f;
  };
  float lj = 0.0f, lr = 0.0f;  // lr: -sum of logcosh down column j so far
  int j = 1, i = 0;
  lb[0] = 0.0f;
  load(cur, 0);
  for (int q0 = 0; q0 < P; q0 += kAhead) {
    load(nxt, q0 + kAhead);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (q0 + u < P) {
        lr -= logcosh(cur[u]);
        lj += lr;
        if (++i == j) {
          lb[j] = lr;
          lj += lr * (CHOL ? 1.0f : (float)(K - j));  // 1 + c_j
          ++j;
          i = 0;
          lr = 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) cur[u] = nxt[u];
  }
  logJ[b] = lj;
}

// The staged design's shape at K and batch B: kThreads elements a block,
// halved while kBlocksPerSm blocks do not fit in an SM's shared memory,
// down to a warp (E = 0 where a warp of elements does not fit in a
// block's); then halved while the grid has fewer blocks than the card has
// SMs (so that a small batch spreads over the card), down to one element.
link::Shape staged_shape(int K, long long B) {
  link::Shape s{};
  s.K = K;
  s.P = K * (K - 1) / 2;
  s.Pp = s.P | 1;  // odd: the walking threads read distinct banks
  s.Fs = K | 1;    // odd: the threads write their log diag W rows on distinct banks
  s.tiles = 1;
  int dev = 0, optin = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  s.E = kThreads;
  while (s.E > 32 && s.bytes() > (size_t)optin / kBlocksPerSm) s.E /= 2;
  if (s.bytes() > (size_t)optin) {
    s.E = 0;
    return s;
  }
  while (s.E > 1 && (B + s.E - 1) / s.E < sms) s.E /= 2;
  return s;
}

// the staged design's threads: one a staged slot of the tile, a power of
// two from a warp to kThreads (at least one an element)
int staged_threads(const link::Shape& s) {
  int t = 32;
  while (t < kThreads && t < s.E * s.Pp) t *= 2;
  return t;
}

template <bool CHOL, int KS>
cudaError_t launch_staged(const float* y, long long sb, long long sp, float* logJ, float* ldw,
                          const link::Shape& s, long long B, cudaStream_t st) {
  return link::launch_blocks(lkj_logdet_tiles<CHOL, KS>, staged_threads(s), s.bytes(),
                             (B + s.E - 1) / s.E, st, y, sb, sp, logJ, ldw, s, B);
}

// the staged kernel (which serves K > kMaxUnrolledDirect) with the walk
// unrolled for K = KS, ..., kMaxUnrolled, else with K read at run time
template <bool CHOL, int KS = kMaxUnrolledDirect + 1>
cudaError_t dispatch_staged(const float* y, long long sb, long long sp, float* logJ, float* ldw,
                            const link::Shape& s, long long B, cudaStream_t st) {
  if constexpr (KS <= kMaxUnrolled) {
    if (s.K == KS) return launch_staged<CHOL, KS>(y, sb, sp, logJ, ldw, s, B, st);
    return dispatch_staged<CHOL, KS + 1>(y, sb, sp, logJ, ldw, s, B, st);
  } else {
    return launch_staged<CHOL, 0>(y, sb, sp, logJ, ldw, s, B, st);
  }
}

template <bool CHOL, int KS>
cudaError_t launch_direct(const float* y, long long sb, long long sp, float* logJ, float* ldw,
                          int K, long long B, cudaStream_t st) {
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  if (sp == 1)
    lkj_logdet_direct<CHOL, KS, true><<<blocks, kThreads, 0, st>>>(y, sb, sp, logJ, ldw, K, B);
  else
    lkj_logdet_direct<CHOL, KS, false><<<blocks, kThreads, 0, st>>>(y, sb, sp, logJ, ldw, K, B);
  return cudaGetLastError();
}

// the direct kernel with the walk unrolled for K = KS, ...,
// kMaxUnrolledDirect, else with its loads ahead
template <bool CHOL, int KS = 2>
cudaError_t dispatch_direct(const float* y, long long sb, long long sp, float* logJ, float* ldw,
                            int K, long long B, cudaStream_t st) {
  if constexpr (KS <= kMaxUnrolledDirect) {
    if (K == KS) return launch_direct<CHOL, KS>(y, sb, sp, logJ, ldw, K, B, st);
    return dispatch_direct<CHOL, KS + 1>(y, sb, sp, logJ, ldw, K, B, st);
  } else {
    return launch_direct<CHOL, 0>(y, sb, sp, logJ, ldw, K, B, st);
  }
}

template <bool CHOL>
cudaError_t launch(const float* y, long long sb, long long sp, float* logJ, float* ldw, int K,
                   long long B, cudaStream_t st) {
  if (K > kMaxUnrolledDirect && B < kDirectMinB) {
    const link::Shape s = staged_shape(K, B);
    if (s.E > 0) return dispatch_staged<CHOL>(y, sb, sp, logJ, ldw, s, B, st);
  }
  return dispatch_direct<CHOL>(y, sb, sp, logJ, ldw, K, B, st);
}

}  // namespace
}  // namespace tbt

extern "C" {

// y (B, K(K-1)/2) with element strides (sb, sp) -> logJ (B,) and log diag W
// (B, K), both contiguous; chol != 0 selects the Cholesky variant's
// coefficients. Launches on `stream`, does not synchronise, returns the
// cudaError_t.
int tbt_lkj_logdet(const float* y, long long sb, long long sp, float* logJ, float* ldw, int K,
                   int chol, long long B, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (chol) return (int)tbt::launch<true>(y, sb, sp, logJ, ldw, K, B, st);
  return (int)tbt::launch<false>(y, sb, sp, logJ, ldw, K, B, st);
}
}
