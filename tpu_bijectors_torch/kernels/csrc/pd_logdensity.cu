// Positive-definite log-density pieces for Hopper (sm_90a): from the packed
// y (K(K+1)/2 slots) of each batch element and a K x K matrix C shared by
// the batch, the inverse link's logJ, sum_r y_rr (log det X = 2 sum y_rr)
// and a trace, without writing X or L:
//   mode 0 (dot, Wishart, C = S^-1):           sum_ab C_ab (LL')_ab
//   mode 1 (solve, InverseWishart, C = chol(Psi)): ||L^-1 C||_F^2
// (C symmetrised by the caller in dot mode.)
//
// Replaces the TPU kernel tpu_bijectors/kernels/pd.py::pd_logdensity_pallas.
// Numerics are those of the TPU kernel and of the plain version
// (tpu_bijectors_torch/kernels/pd.py: pd_logdensity_plain); the device
// functions are pd_common.cuh's, which the PD loop entry of fused_slab.cu
// also runs.
//
// Layout: y is read through its two strides (batch, slot), so the
// batch-major slice and the swapped view of the transposed state are read
// in place. logJ, sumd and the trace (B,) are written batch-major.
//
// Bound on the card: memory in dot mode; at K = 16 and B = 131072 an element
// reads 136 floats and writes 3, 72.9 MB, about 21.8 us at 3.35 TB/s, while
// the dot trace's 816 multiply-adds take about 3.2 us at the float32 peak.
// The solve mode's K forward substitutions (K^2 (K+1)/2 multiply-adds, 2176
// at K = 16, about 0.6 GFLOP at B = 131072, 9 us) stay under the byte bound
// too. One thread walks one element; the factor, exp(-y_rr) and one column
// of L^-1 C live in shared memory (pd_common.cuh), C is one broadcast copy.

#include "pd_common.cuh"

namespace tbt {
namespace {

constexpr int kMaxThreads = 128;

__global__ void __launch_bounds__(kMaxThreads)
pd_logdensity_kernel(const float* __restrict__ y, long long sb, long long sp,
                     const float* __restrict__ C, float* __restrict__ logJ,
                     float* __restrict__ sumd, float* __restrict__ tr, int K, int mode,
                     long long B) {
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
  logJ[b] = lj;
  sumd[b] = sd;
  tr[b] = mode == pd::kDot ? pd::dot_trace(s, sC) : pd::solve_trace(s, sC);
}

}  // namespace
}  // namespace tbt

extern "C" {

// y (B, K(K+1)/2) with element strides (sb, sp), C (K, K) contiguous ->
// logJ, sumd, tr (B,) each; mode 0 dot, 1 solve. Launches on `stream`, does
// not synchronise, returns the cudaError_t.
int tbt_pd_logdensity(const float* y, long long sb, long long sp, const float* C, float* logJ,
                      float* sumd, float* tr, int K, int mode, long long B, void* stream) {
  using namespace tbt;
  if (K < 1 || K > pd::kMaxK || (mode != pd::kDot && mode != pd::kSolve))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int slots = pd::scratch_slots(K, false);
  const size_t fixed = (size_t)K * K * sizeof(float);
  const int nt = pd::threads_for(slots, fixed, kMaxThreads, 100 * 1024);
  const size_t smem = fixed + (size_t)slots * sizeof(float) * nt;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pd_logdensity_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (B + nt - 1) / nt;
  pd_logdensity_kernel<<<(unsigned)blocks, nt, smem, (cudaStream_t)stream>>>(
      y, sb, sp, C, logJ, sumd, tr, K, mode, B);
  return (int)cudaGetLastError();
}
}
