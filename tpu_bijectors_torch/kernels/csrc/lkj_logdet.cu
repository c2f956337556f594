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
// pre_t flag); the second is coalesced. logJ (B,) and log diag W (B, K)
// are written batch-major.
//
// Bound on the card: memory. An element reads P floats and writes K + 1,
// against about ten operations per slot; at K = 16 and B = 131072 that is
// 71.8 MB, about 21.4 us at 3.35 TB/s. One thread walks one element and
// keeps each column's running sum in one register, so no shared memory.
// The log diag W write is 64 contiguous bytes per thread, not coalesced
// across the warp (the L2 merges the partial sectors).

#include <cuda_runtime.h>

#include <cmath>

namespace tbt {
namespace {

constexpr int kThreads = 256;
constexpr float kLog2 = 0.693147180559945309f;

template <bool CHOL>
__global__ void __launch_bounds__(kThreads)
lkj_logdet_kernel(const float* __restrict__ y, long long sb, long long sp,
                  float* __restrict__ logJ, float* __restrict__ ldw, int K, long long B) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* yb = y + b * sb;
  float* lb = ldw + b * K;
  float lj = 0.0f;
  lb[0] = 0.0f;
  long long slot = 0;
  for (int j = 1; j < K; ++j) {
    float lr = 0.0f;  // -sum of logcosh down column j so far
    for (int i = 0; i < j; ++i, ++slot) {
      const float a = fabsf(yb[slot * sp]);
      const float lc = a + log1pf(expf(-2.0f * a)) - kLog2;
      lr -= lc;
      lj += lr;
    }
    lb[j] = lr;
    lj += lr * (CHOL ? 1.0f : (float)(K - j));  // 1 + c_j
  }
  logJ[b] = lj;
}

template <bool CHOL>
cudaError_t launch(const float* y, long long sb, long long sp, float* logJ, float* ldw,
                   int K, long long B, cudaStream_t stream) {
  const long long blocks = (B + kThreads - 1) / kThreads;
  lkj_logdet_kernel<CHOL><<<(unsigned)blocks, kThreads, 0, stream>>>(y, sb, sp, logJ, ldw,
                                                                      K, B);
  return cudaGetLastError();
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
