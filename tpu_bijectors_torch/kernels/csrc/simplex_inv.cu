// Stick-breaking simplex inverse for Hopper (sm_90a): one pass over the
// K-1 unconstrained coordinates of each batch element gives the simplex
// point x, the inverse log-det, and optionally the Dirichlet data term
// wlog = sum_k am1[k] log(x_k + eps).
//
// Replaces two TPU kernels of tpu_bijectors/kernels/simplex.py:
// _simplex_fused_pallas (entries simplex_inverse_logdet_pallas and
// simplex_inverse_logdet_wlog_pallas; C entry tbt_simplex_inverse_logdet)
// and simplex_inverse_pallas, x alone (C entry tbt_simplex_inverse: the
// same recurrence instantiated without the log-det and wlog arithmetic,
// LOGDET = false). Numerics are those of the plain
// version (tpu_bijectors_torch/kernels/simplex.py: simplex_inverse_plain and
// _inverse_logdet_from_x): the same eps algebra, the
// same per-step clamps, the log-det from the running sum of x.
//
// Layout: y is read through its two strides (batch, coordinate), so a
// batch-major slice v[:, s:s+n] of a (B, dim) tensor and the swapped view
// vT[s:s+n, :].T of the transposed (dim, B) state are both read in place;
// the second is coalesced (neighbouring threads read neighbouring floats).
// x is written batch-major (B, K), as the JAX function returns it.
//
// Bound on the card: memory. Per element the kernel reads (K-1) floats
// and writes K (+1 or 2) floats, against ~10 operations per coordinate, so
// at K = 16 and B = 131072 it moves 16.8 MB (about 5 us at 3.35 TB/s);
// x alone, 16.3 MB (4.9 us).
// One thread walks one batch element's recurrence in registers; the x
// write is 64 contiguous bytes per thread, not coalesced across the warp
// (the L2 merges the partial sectors): making it coalesced is later work.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace tbt {
namespace {

constexpr int kThreads = 256;

// NaN-propagating clamp and max, as torch.clamp / torch.maximum
__device__ __forceinline__ float clamp01(float v) {
  return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
}
__device__ __forceinline__ float maxp(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <bool WANT_X, bool WLOG, bool LOGDET>
__global__ void __launch_bounds__(kThreads)
simplex_inv_kernel(const float* __restrict__ y, long long sb, long long sk,
                   const float* __restrict__ lc, const float* __restrict__ am1,
                   float* __restrict__ x,
                   float* __restrict__ ld, float* __restrict__ wlog, int Km1,
                   long long B) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int K = Km1 + 1;
  const float eps = FLT_EPSILON;
  const float c12 = 1.0f - 2.0f * eps;  // exact in float32
  const float c1p = 1.0f + eps;
  const float* yb = y + b * sb;
  float* xb = WANT_X ? x + b * (long long)K : nullptr;
  float s = 0.0f, lp = 0.0f, wl = 0.0f;
  for (int k = 0; k < Km1; ++k) {
    // lc[k] = log(K-1-k), rounded from double on the host: the plain
    // version's table, read through the cache by every thread
    const float t = yb[k * sk] - lc[k];
    const float z = 1.0f / (1.0f + expf(-t));
    float xk;
    if (k == 0) {
      xk = clamp01((z - eps) / c12);
      if (LOGDET) lp += logf(maxp(xk, eps)) + logf(maxp(1.0f - xk, eps));
    } else {
      // __fmul_rn: no fused multiply-add, the plain version rounds twice
      xk = clamp01(__fmul_rn((c1p - s) / c12, z) - eps);
      if (LOGDET) {
        const float rem = maxp(1.0f - s, eps);
        const float zl = xk / rem;
        lp += logf(maxp(zl, eps)) + logf(maxp(1.0f - zl, eps)) + logf(rem);
      }
    }
    if (WANT_X) xb[k] = xk;
    if (WLOG) wl += am1[k] * logf(xk + eps);
    s += xk;
  }
  const float xl = clamp01(1.0f - s);
  if (WANT_X) xb[Km1] = xl;
  if (WLOG) wlog[b] = wl + am1[Km1] * logf(xl + eps);
  if (LOGDET) ld[b] = lp;
}

template <bool WANT_X, bool WLOG, bool LOGDET = true>
cudaError_t launch(const float* y, long long sb, long long sk, const float* lc,
                   const float* am1, float* x, float* ld, float* wlog, int Km1, long long B,
                   cudaStream_t stream) {
  const long long blocks = (B + kThreads - 1) / kThreads;
  simplex_inv_kernel<WANT_X, WLOG, LOGDET><<<(unsigned)blocks, kThreads, 0, stream>>>(
      y, sb, sk, lc, am1, x, ld, wlog, Km1, B);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tbt

extern "C" {

// y (B, K-1) with element strides (sb, sk) and the table lc (K-1,) of
// log(K-1-k) -> ld (B,), and x (B, K) contiguous when x is not null, and
// wlog (B,) from am1 (K,) when am1 is not null. Launches on `stream`, does
// not synchronise, returns the cudaError_t.
int tbt_simplex_inverse_logdet(const float* y, long long sb, long long sk, const float* lc,
                               const float* am1, float* x, float* ld, float* wlog, int Km1,
                               long long B, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (x && am1) return (int)tbt::launch<true, true>(y, sb, sk, lc, am1, x, ld, wlog, Km1, B, st);
  if (x) return (int)tbt::launch<true, false>(y, sb, sk, lc, am1, x, ld, wlog, Km1, B, st);
  if (am1) return (int)tbt::launch<false, true>(y, sb, sk, lc, am1, x, ld, wlog, Km1, B, st);
  return (int)tbt::launch<false, false>(y, sb, sk, lc, am1, x, ld, wlog, Km1, B, st);
}

// y (B, K-1) with element strides (sb, sk) and the table lc (K-1,) -> x
// (B, K) contiguous, with no log-det. Launches on `stream`, does not
// synchronise, returns the cudaError_t.
int tbt_simplex_inverse(const float* y, long long sb, long long sk, const float* lc, float* x,
                        int Km1, long long B, void* stream) {
  if (B == 0) return 0;
  return (int)tbt::launch<true, false, false>(y, sb, sk, lc, nullptr, x, nullptr, nullptr,
                                              Km1, B, (cudaStream_t)stream);
}
}
