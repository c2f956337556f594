// Stick-breaking simplex forward link for Hopper (sm_90a): one pass over
// the K coordinates of each simplex point x gives the unconstrained
// y (K-1) and the forward log-det, both from the shared prefix sum
// s_k = sum_{i<k} x_i.
//
// Replaces the TPU kernel tpu_bijectors/kernels/simplex.py::
// simplex_forward_logdet_pallas. Numerics are those of the TPU kernel and
// of the plain version (tpu_bijectors_torch/kernels/simplex.py:
// simplex_forward_logdet_plain):
//   z_0 = x_0 (1-2eps) + eps,  z_k = (x_k + eps)(1-2eps) / ((1+eps) - s_k),
//   y_k = log(z_k) - log1p(-z_k) + log(K-1-k),
//   ld = -sum_k [log(max(z'_k, eps)) + log(max(1 - z'_k, eps))
//                + (k > 0) log(max(1 - s_k, eps))],
// with z'_0 = x_0 and z'_k = x_k / max(1 - s_k, eps). Products are rounded
// apart from the sums that follow them (__fmul_rn: no fused multiply-add),
// as the plain version rounds them: near z = 1, log1p(-z) magnifies a
// difference of one rounding.
//
// Layout: x is read through its two strides (batch, coordinate), so a
// batch-major slice and the swapped view of a transposed state are both
// read in place; y (B, K-1) and ld (B,) are written batch-major.
//
// Bound on the card: an element reads K-1 floats (x_{K-1} enters neither y
// nor ld, and is never loaded) and writes K; at K = 16 and B = 131072 that
// is 16.3 MB, about 4.85 us at 3.35 TB/s. But each coordinate takes four
// logs and two IEEE divisions, some 200 instructions, so issue bounds it
// first (PERF.md). Two designs, by batch; both walk each element's prefix
// sum in registers, one thread an element, in the same order, so they give
// the same bits:
//
// - staged (B >= kStagedMinB): the simplex inverse's wide design
//   (simplex_inv.cu): x staged in shared memory by link::for_each_tile
//   (cp.async along whichever stride is 1, the next tile's x on its way
//   while the block works on this one); y goes to a shared tile and leaves
//   by coalesced 16-byte stores;
// - direct (a smaller batch, and where a block of 32 elements does not fit
//   in shared memory, K above about 590): thread b reads x from device
//   memory, four coordinates a trip of its loop, and writes its own y row.
//
// No K limit.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

#include "link_tiles.cuh"

namespace tbt {
namespace {

constexpr int kThreads = 256;      // a block of the direct design
constexpr int kWideThreads = 128;  // elements (and threads) a block of the staged design
// the smallest batch the staged design serves (the crossover measured in
// PERF.md)
constexpr long long kStagedMinB = 1024;
constexpr float kEps = FLT_EPSILON;
constexpr float kC12 = 1.0f - 2.0f * kEps;  // exact in float32
constexpr float kC1p = 1.0f + kEps;

// NaN-propagating max, as torch.maximum
__device__ __forceinline__ float maxp(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// One element: xk(k) gives x_k, y_out(k, v) takes y_k; returns ld.
// lc[k] = log(K-1-k), rounded from double on the host. The log-det's three
// logs of a coordinate are taken as one logf of their product (each factor
// in [eps, 1], so the product in [eps^3, 1], normal in float32), as the
// simplex inverse takes them. UNROLL coordinates a trip of the loop.
template <int UNROLL, class X, class Y>
__device__ __forceinline__ float forward_element(X xk_at, const float* __restrict__ lc, Y y_out,
                                                 int Km1) {
  const float x0 = xk_at(0);
  const float z0 = __fmul_rn(x0, kC12) + kEps;
  float lp = logf(maxp(x0, kEps) * maxp(1.0f - x0, kEps));
  y_out(0, logf(z0) - log1pf(-z0) + __ldg(lc));
  float s = x0;
#pragma unroll UNROLL
  for (int k = 1; k < Km1; ++k) {
    const float xk = xk_at(k);
    const float zf = __fmul_rn(xk + kEps, kC12) / (kC1p - s);
    const float rem = maxp(1.0f - s, kEps);
    const float zl = xk / rem;
    lp += logf(maxp(zl, kEps) * maxp(1.0f - zl, kEps) * rem);
    y_out(k, logf(zf) - log1pf(-zf) + __ldg(lc + k));
    s += xk;
  }
  return -lp;
}

// The staged design: thread e walks element b0 + e of the block's tile on
// x staged at s.Pp floats an element; y goes to a shared tile (row stride
// s.Fs) that the block then writes whole.
__global__ void __launch_bounds__(kWideThreads)
simplex_fwd_tiles(const float* __restrict__ x, long long sb, long long sk,
                  const float* __restrict__ lc, float* __restrict__ y, float* __restrict__ ld,
                  link::Shape s, long long B) {
  extern __shared__ __align__(16) float smem[];
  const int e = threadIdx.x, Km1 = s.P;
  float* ye = smem + e * s.Fs;
  link::for_each_tile<false, true>(x, sb, sk, B, s, smem + s.E * s.Fs,
                                   [&](float* xbuf, long long b0, int n) {
    const float* xs = xbuf + e * s.Pp;
    const float lde = forward_element<1>([&](int k) { return xs[k]; }, lc,
                                         [&](int k, float v) { ye[k] = v; }, Km1);
    if (e < n) ld[b0 + e] = lde;
    __syncthreads();  // the y tile is whole, and every thread is done with xs
    link::store_rows(y, Km1, 1, smem, s.Fs, b0, n, Km1);
  });
}

// The direct design: thread b walks element b from device memory.
__global__ void __launch_bounds__(kThreads)
simplex_fwd_direct(const float* __restrict__ x, long long sb, long long sk,
                   const float* __restrict__ lc, float* __restrict__ y, float* __restrict__ ld,
                   int Km1, long long B) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* xb = x + b * sb;
  float* yb = y + b * (long long)Km1;
  ld[b] = forward_element<4>([&](int k) { return xb[k * sk]; }, lc,
                             [&](int k, float v) { yb[k] = v; }, Km1);
}

// the staged design's shape: kWideThreads elements a block, halved while
// the block's x buffers and y tile do not fit; E = 0 below a warp
link::Shape staged_shape(int Km1) {
  link::Shape s{};
  s.K = Km1 + 1;
  s.P = Km1;       // x_0 .. x_{K-2} staged
  s.Pp = Km1 | 1;  // odd: the threads' rows on distinct banks
  s.Fs = Km1 | 1;
  s.tiles = 1;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  s.E = kWideThreads;
  while (s.E >= 32 && s.bytes() > (size_t)optin) s.E /= 2;
  if (s.E < 32) s.E = 0;
  return s;
}

}  // namespace
}  // namespace tbt

extern "C" {

// x (B, K) with element strides (sb, sk) and the table lc (K-1,) of
// log(K-1-k) -> y (B, K-1) and ld (B,), both contiguous. Launches on
// `stream`, does not synchronise, returns the cudaError_t.
int tbt_simplex_forward_logdet(const float* x, long long sb, long long sk, const float* lc,
                               float* y, float* ld, int K, long long B, void* stream) {
  using namespace tbt;
  if (K < 2) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const link::Shape s = staged_shape(K - 1);
  if (B >= kStagedMinB && s.E > 0)
    return (int)link::launch_blocks(simplex_fwd_tiles, s.E, s.bytes(), (B + s.E - 1) / s.E, st,
                                    x, sb, sk, lc, y, ld, s, B);
  simplex_fwd_direct<<<(unsigned)((B + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      x, sb, sk, lc, y, ld, K - 1, B);
  return (int)cudaGetLastError();
}
}
