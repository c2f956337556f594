// Backward of the positive-definite trace for Hopper (sm_90a): from the
// packed y (K(K+1)/2 slots) of each batch element and a K x K matrix C
// shared by the batch, d trace / d y for the trace of pd_logdensity.cu:
//   mode 0 (dot):   2 (C L)_rc                (C symmetrised by the caller)
//   mode 1 (solve): -2 (At A')_rc, A = L^-1 C, At = L^-T A
// each times L_rr = exp(y_rr) on the diagonal slots.
//
// Replaces the TPU kernel tpu_bijectors/kernels/pd.py::pd_trace_grad_pallas.
// Numerics are those of the TPU kernel and of the plain version
// (tpu_bijectors_torch/kernels/pd.py: pd_trace_grad_plain); the device
// functions are pd_common.cuh's, which the PD loop entry of fused_slab.cu
// also runs.
//
// Layout: y is read and g written through two strides each (batch, slot),
// so the batch-major (B, P) layout and the swapped view of a (P, B) block
// are both read and written in place (the TPU kernel's pre_t).
//
// Bound on the card: memory in dot mode; at K = 16 and B = 131072 an element
// reads 136 floats and writes 136, 142.6 MB, about 42.6 us at 3.35 TB/s.
// The solve mode does K forward and K back substitutions and the K rank-one
// updates of G (about 6100 multiply-adds an element at K = 16, 1.6 GFLOP at
// B = 131072, 24 us), under the byte bound as well. Rather than the TPU
// kernel's full A and At (256 floats each), it runs one column j of C at a
// time: a = L^-1 C[:, j], at = L^-T a, G_rc += at_r a_c, so a thread keeps
// L, G, exp(-y_rr) and the two vectors (320 floats at K = 16) in shared
// memory (pd_common.cuh), 64 threads a block.

#include "pd_common.cuh"

namespace tbt {
namespace {

constexpr int kMaxThreads = 128;

__global__ void __launch_bounds__(kMaxThreads)
pd_trace_grad_kernel(const float* __restrict__ y, long long sb, long long sp,
                     const float* __restrict__ C, float* __restrict__ g, long long gb,
                     long long gp, int K, int mode, long long B) {
  extern __shared__ float smem[];
  float* sC = smem;
  for (int i = threadIdx.x; i < K * K; i += blockDim.x) sC[i] = C[i];
  __syncthreads();
  const int nt = blockDim.x;
  const long long b = (long long)blockIdx.x * nt + threadIdx.x;
  if (b >= B) return;  // no block-wide barrier below
  const pd::Scratch s{smem + K * K + threadIdx.x, nt, K};
  const float* yb = y + b * sb;
  float lj, sd;
  pd::unpack([&](int q) { return yb[q * sp]; }, s, lj, sd);
  float* gbp = g + b * gb;
  pd::trace_grad(s, sC, mode, [&](int q, int, int, float v) { gbp[q * gp] = v; });
}

}  // namespace
}  // namespace tbt

extern "C" {

// y (B, K(K+1)/2) with element strides (sb, sp), C (K, K) contiguous ->
// g (B, K(K+1)/2) with element strides (gb, gp); mode 0 dot, 1 solve.
// Launches on `stream`, does not synchronise, returns the cudaError_t.
int tbt_pd_trace_grad(const float* y, long long sb, long long sp, const float* C, float* g,
                      long long gb, long long gp, int K, int mode, long long B, void* stream) {
  using namespace tbt;
  if (K < 1 || K > pd::kMaxK || (mode != pd::kDot && mode != pd::kSolve))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int slots = pd::scratch_slots(K, true);
  const size_t fixed = (size_t)K * K * sizeof(float);
  const int nt = pd::threads_for(slots, fixed, kMaxThreads, 100 * 1024);
  const size_t smem = fixed + (size_t)slots * sizeof(float) * nt;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pd_trace_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (B + nt - 1) / nt;
  pd_trace_grad_kernel<<<(unsigned)blocks, nt, smem, (cudaStream_t)stream>>>(
      y, sb, sp, C, g, gb, gp, K, mode, B);
  return (int)cudaGetLastError();
}
}
