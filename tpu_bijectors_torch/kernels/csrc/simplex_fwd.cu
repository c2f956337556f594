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
// Bound on the card: memory. An element reads K-1 floats (x_{K-1} enters
// neither y nor ld, and is never loaded) and writes K, against about 20
// operations per coordinate; at K = 16 and B = 131072 that is 16.3 MB,
// about 4.85 us at 3.35 TB/s. One thread walks one
// element's prefix sum in registers. The y write is 60 contiguous bytes
// per thread, not coalesced across the warp.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace tbt {
namespace {

constexpr int kThreads = 256;

// NaN-propagating max, as torch.maximum
__device__ __forceinline__ float maxp(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__global__ void __launch_bounds__(kThreads)
simplex_fwd_kernel(const float* __restrict__ x, long long sb, long long sk,
                   const float* __restrict__ lc, float* __restrict__ y,
                   float* __restrict__ ld, int K, long long B) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float eps = FLT_EPSILON;
  const float c12 = 1.0f - 2.0f * eps;  // exact in float32
  const float c1p = 1.0f + eps;
  const float* xb = x + b * sb;
  float* yb = y + b * (long long)(K - 1);
  float s = 0.0f, lp = 0.0f;
  for (int k = 0; k < K - 1; ++k) {
    const float xk = xb[k * sk];
    float zf;
    if (k == 0) {
      zf = __fmul_rn(xk, c12) + eps;
      lp += logf(maxp(xk, eps)) + logf(maxp(1.0f - xk, eps));
    } else {
      zf = __fmul_rn(xk + eps, c12) / (c1p - s);
      const float rem = maxp(1.0f - s, eps);
      const float zl = xk / rem;
      lp += logf(maxp(zl, eps)) + logf(maxp(1.0f - zl, eps)) + logf(rem);
    }
    // lc[k] = log(K-1-k), rounded from double on the host
    yb[k] = logf(zf) - log1pf(-zf) + lc[k];
    s += xk;
  }
  ld[b] = -lp;
}

}  // namespace
}  // namespace tbt

extern "C" {

// x (B, K) with element strides (sb, sk) and the table lc (K-1,) of
// log(K-1-k) -> y (B, K-1) and ld (B,), both contiguous. Launches on
// `stream`, does not synchronise, returns the cudaError_t.
int tbt_simplex_forward_logdet(const float* x, long long sb, long long sk, const float* lc,
                               float* y, float* ld, int K, long long B, void* stream) {
  if (B == 0) return 0;
  const long long blocks = (B + tbt::kThreads - 1) / tbt::kThreads;
  tbt::simplex_fwd_kernel<<<(unsigned)blocks, tbt::kThreads, 0, (cudaStream_t)stream>>>(
      x, sb, sk, lc, y, ld, K, B);
  return (int)cudaGetLastError();
}
}
