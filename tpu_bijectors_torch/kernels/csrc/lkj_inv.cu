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
// writes 256 + 16 + 1, against 120 tanh/exp/log1p chains and 816 FMAs for
// X; at B = 131072 that is 206 MB, about 61.5 us at 3.35 TB/s, while the
// FMAs take about 3.2 us at the float32 peak. One thread walks one batch
// element. Its factor W (K(K+1)/2 floats, 544 B at K = 16) would spill out
// of registers, so it lives in shared memory, slot-major across the
// block's threads (ws[slot * nthreads + tid]: a warp touches 32 consecutive
// words, no bank conflicts). From K = 60 on, one warp's factors pass the
// block's 227 KB: there they live in a global scratch buffer the wrapper
// allocates, slot-major across the grid's threads (coalesced likewise),
// and a grid of at most 528 one-warp blocks walks the batch, so the
// buffer stays at most 16896 factors (140 MB at K = 64) whatever B. The X write is 1 KB per element at a 1 KB
// stride across the warp, so it is not coalesced; staging it through
// shared memory is later work.

#include <cuda_runtime.h>

#include <cmath>

namespace tbt {
namespace {

constexpr int kMaxThreads = 128;
constexpr float kLog2 = 0.693147180559945309f;
// the grid of the global-scratch instantiation: blocks of one warp, four on
// each of the H100's 132 SMs at most (16896 threads), walking the batch
// with a grid stride; one-warp blocks spread a small batch over every SM
constexpr int kScratchThreads = 32;
constexpr long long kScratchBlocks = 4 * 132;

// GSCR: the factors live in a global scratch buffer (slot s of thread t at
// gscr[s * nthreads_of_the_grid + t]), for a K whose factors of one warp
// do not fit in shared memory; the fixed grid walks the batch.
template <bool WANT_W, bool GSCR>
__global__ void __launch_bounds__(kMaxThreads)
lkj_inv_kernel(const float* __restrict__ y, long long sb, long long sp,
               float* __restrict__ X, float* __restrict__ logJ,
               float* __restrict__ ldw, float* __restrict__ Wout,
               float* __restrict__ gscr, int K, long long B) {
  extern __shared__ float ws[];
  const int tid = threadIdx.x;
  const long long gt = (long long)blockIdx.x * blockDim.x + tid;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  float* const fac = GSCR ? gscr + gt : ws + tid;
  const long long stride = GSCR ? nthreads : blockDim.x;
  // W[i][j], i <= j, at packed slot j(j+1)/2 + i
  auto W = [&](int i, int j) -> float& { return fac[(j * (j + 1) / 2 + i) * stride]; };
  auto element = [&](long long b) {
    const float* yb = y + b * sb;
    float* lb = ldw + b * K;
    float lj = 0.0f;
    W(0, 0) = 1.0f;
    lb[0] = 0.0f;
    for (int j = 1; j < K; ++j) {
      float lr = 0.0f;  // -sum of logcosh down column j so far
      const int base = j * (j - 1) / 2;
      for (int i = 0; i < j; ++i) {
        const float yv = yb[(base + i) * sp];
        const float t = tanhf(yv);
        const float a = fabsf(yv);
        const float lc = a + log1pf(expf(-2.0f * a)) - kLog2;
        W(i, j) = t * expf(lr);
        lr -= lc;
        lj += lr;
      }
      W(j, j) = expf(lr);
      lb[j] = lr;
      lj += lr * (float)(K - j);  // the diagonal term, 1 + (K-1-j) times
    }
    logJ[b] = lj;
    // X = W'W: X[a][c] = sum_{k <= a} W[k][a] W[k][c], a <= c
    float* Xb = X + b * K * K;
    for (int a = 0; a < K; ++a) {
      for (int c = a; c < K; ++c) {
        float acc = 0.0f;
        for (int k = 0; k <= a; ++k) acc += W(k, a) * W(k, c);
        Xb[a * K + c] = acc;
        Xb[c * K + a] = acc;
      }
    }
    if (WANT_W) {
      float* Wb = Wout + b * K * K;
      for (int i = 0; i < K; ++i)
        for (int j = 0; j < K; ++j) Wb[i * K + j] = i <= j ? W(i, j) : 0.0f;
    }
  };
  if (GSCR) {
    for (long long b = gt; b < B; b += nthreads) element(b);
  } else if (gt < B) {  // no block-wide barrier
    element(gt);
  }
}

size_t smem_bytes(int K, int nt) { return (size_t)K * (K + 1) / 2 * sizeof(float) * nt; }

// as many threads as keep the block's factors within 100 KB (two blocks an
// SM), at least one warp; 0 when one warp's factors pass the block's
// shared-memory limit (K >= 60 on the H100)
int shared_threads(int K) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int nt = kMaxThreads;
  while (nt > 32 && smem_bytes(K, nt) > 100 * 1024) nt -= 32;
  return smem_bytes(K, nt) <= (size_t)optin ? nt : 0;
}

long long scratch_blocks(long long B) {
  const long long need = (B + kScratchThreads - 1) / kScratchThreads;
  return need < kScratchBlocks ? need : kScratchBlocks;
}

template <bool WANT_W>
cudaError_t launch(const float* y, long long sb, long long sp, float* X, float* logJ,
                   float* ldw, float* Wout, float* gscr, int K, long long B,
                   cudaStream_t stream) {
  const int nt = shared_threads(K);
  if (nt == 0) {
    if (gscr == nullptr) return cudaErrorInvalidValue;
    lkj_inv_kernel<WANT_W, true><<<(unsigned)scratch_blocks(B), kScratchThreads, 0, stream>>>(
        y, sb, sp, X, logJ, ldw, Wout, gscr, K, B);
    return cudaGetLastError();
  }
  const size_t smem = smem_bytes(K, nt);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(lkj_inv_kernel<WANT_W, false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (B + nt - 1) / nt;
  lkj_inv_kernel<WANT_W, false><<<(unsigned)blocks, nt, smem, stream>>>(
      y, sb, sp, X, logJ, ldw, Wout, nullptr, K, B);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tbt

extern "C" {

// The floats of global scratch tbt_lkj_inverse needs at K and B on the
// current device: 0 where the factors fit in shared memory, else K(K+1)/2
// for each thread of the fixed grid.
long long tbt_lkj_inverse_scratch(int K, long long B) {
  if (B == 0 || tbt::shared_threads(K) > 0) return 0;
  return (long long)K * (K + 1) / 2 * tbt::scratch_blocks(B) * tbt::kScratchThreads;
}

// y (B, K(K-1)/2) with element strides (sb, sp) -> X (B, K, K), logJ (B,),
// log diag W (B, K), and W (B, K, K) when Wout is not null; all outputs
// contiguous; gscr the scratch of tbt_lkj_inverse_scratch floats (null
// where that is 0). Launches on `stream`, does not synchronise, returns
// the cudaError_t.
int tbt_lkj_inverse(const float* y, long long sb, long long sp, float* X, float* logJ,
                    float* ldw, float* Wout, float* gscr, int K, long long B, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (Wout) return (int)tbt::launch<true>(y, sb, sp, X, logJ, ldw, Wout, gscr, K, B, st);
  return (int)tbt::launch<false>(y, sb, sp, X, logJ, ldw, Wout, gscr, K, B, st);
}
}
