// Positive-definite inverse link for Hopper (sm_90a): from the packed
// unconstrained vector y (K(K+1)/2 slots, the factor's lower triangle row by
// row) of each batch element, the SPD matrix X = LL', the inverse-link
// log-det logJ = sum_r (K+1-r) y_rr + K log 2, and the lower factor L
// (exp(y_rr) on its diagonal), which the Wishart-family densities use.
//
// Replaces the TPU kernel tpu_bijectors/kernels/pd.py::pd_inverse_pallas.
// Numerics are those of the TPU kernel and of the plain version
// (tpu_bijectors_torch/kernels/pd.py: pd_inverse_plain): logJ from y itself,
// never log(exp(y)); X_ab = sum_{k <= a} L_ak L_bk for a <= b, mirrored.
//
// Layout: y is read through its two strides (batch, slot), so a batch-major
// slice of a (B, dim) tensor and the swapped view of the transposed (dim, B)
// state are both read in place. X and L (B, K, K) and logJ (B,) are written
// batch-major.
//
// Bound on the card: memory. At K = 16 an element reads 136 floats and
// writes 256 + 256 + 1, against 816 multiply-adds for X; at B = 131072 that
// is 340.3 MB, about 101.6 us at 3.35 TB/s, while the multiply-adds take
// about 3.2 us at the float32 peak. One thread walks one element, its
// factor in shared memory (pd_common.cuh). The X and L writes are 1 KB per
// element at a 1 KB stride across the warp, so they are not coalesced, as
// in lkj_inv.cu; staging them through shared memory is later work.

#include "pd_common.cuh"

namespace tbt {
namespace {

constexpr int kMaxThreads = 128;

__global__ void __launch_bounds__(kMaxThreads)
pd_inverse_kernel(const float* __restrict__ y, long long sb, long long sp,
                  float* __restrict__ X, float* __restrict__ logJ,
                  float* __restrict__ Lout, int K, long long B) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  const long long b = (long long)blockIdx.x * nt + threadIdx.x;
  if (b >= B) return;  // no block-wide barrier below
  const pd::Scratch s{smem + threadIdx.x, nt, K};
  const float* yb = y + b * sb;
  float lj, sumd;
  pd::unpack([&](int q) { return yb[q * sp]; }, s, lj, sumd);
  logJ[b] = lj;
  float* Xb = X + b * K * K;
  float* Lb = Lout + b * K * K;
  for (int a = 0; a < K; ++a) {
    for (int c = 0; c < K; ++c) Lb[a * K + c] = c <= a ? s.L(a, c) : 0.0f;
    for (int c = a; c < K; ++c) {
      float acc = 0.0f;
      for (int k = 0; k <= a; ++k) acc += s.L(a, k) * s.L(c, k);
      Xb[a * K + c] = acc;
      Xb[c * K + a] = acc;
    }
  }
}

}  // namespace
}  // namespace tbt

extern "C" {

// y (B, K(K+1)/2) with element strides (sb, sp) -> X (B, K, K), logJ (B,),
// L (B, K, K); all outputs contiguous. Launches on `stream`, does not
// synchronise, returns the cudaError_t.
int tbt_pd_inverse(const float* y, long long sb, long long sp, float* X, float* logJ,
                   float* L, int K, long long B, void* stream) {
  using namespace tbt;
  if (K < 1 || K > pd::kMaxK) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int slots = pd::scratch_slots(K, false);
  const int nt = pd::threads_for(slots, 0, kMaxThreads, 100 * 1024);
  const size_t smem = (size_t)slots * sizeof(float) * nt;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pd_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (B + nt - 1) / nt;
  pd_inverse_kernel<<<(unsigned)blocks, nt, smem, (cudaStream_t)stream>>>(y, sb, sp, X, logJ,
                                                                          L, K, B);
  return (int)cudaGetLastError();
}
}
