// Backward of the positive-definite trace for Hopper (sm_90a): from the
// packed y (K(K+1)/2 slots) of each batch element and a K x K matrix C
// shared by the batch, d trace / d y for the trace of pd_logdensity.cu:
//   mode 0 (dot):   2 (C L)_rc                (C symmetrised by the caller)
//   mode 1 (solve): -2 (At A')_rc, A = L^-1 C, At = L^-T A
// each times L_rr = exp(y_rr) on the diagonal slots.
//
// Replaces the TPU kernel tpu_bijectors/kernels/pd.py::pd_trace_grad_pallas.
// Numerics are those of the TPU kernel and of the plain version
// (tpu_bijectors_torch/kernels/pd.py: pd_trace_grad_plain); the per-element
// arithmetic is pd_tiles.cuh's, which #2's item kernel (fused_slab.cu) also
// runs for its PD items.
//
// Layout: y is read and g written through two strides each (batch, slot),
// so the batch-major (B, P) layout and the swapped view of a (P, B) block
// are both read and written in place (the TPU kernel's pre_t).
//
// Bound on the card: memory in dot mode; at K = 16 and B = 131072 an element
// reads 136 floats and writes 136, 142.6 MB, about 42.6 us at 3.35 TB/s.
// The solve mode's two substitutions and the product G take about 6100
// multiply-adds an element, about 70 us of issue over a half-warp's lanes.
// Design: a half-warp an element, lane l row and column l (pd_tiles.cuh),
// its L (and in solve mode A and At) in 16-row tiles of shared memory (row
// stride 20 in solve mode, so the rows the lanes read whole come as float4;
// 17 in dot mode); C once a block in shared memory (by cp.async with the
// first y), rows padded to four, read as float4 in dot mode. Blocks of up to 16 elements stay on the card and walk their
// tiles (link_tiles.cuh): the next tile's y comes by cp.async while this
// one works; g goes to a shared tile and leaves by coalesced stores in
// either layout. At a sampler's B = 64 a block holds two elements (32 SMs
// busy). The kernel takes K <= 16 (kernels/pd.py MAX_K).

#include "link_tiles.cuh"
#include "pd_tiles.cuh"

namespace tbt {
namespace {

constexpr int kMaxE = 16;  // elements a block: 256 threads

// the tiles' row stride: 20 in solve mode (its rows, read whole, come as
// float4), the item kernel's 17 in dot mode (whose column reads and row
// writes it keeps on distinct banks); both the faster in an A/B on the H100
__host__ __device__ constexpr int tile_ld(bool solve) { return solve ? 20 : pdt::kLd; }

// A block's shared memory, in floats: C (K rows of stride Kp, a multiple of
// 4), then each element's tiles (stride Fs, 16 modulo 32 so that the two
// half-warps of a warp meet on other banks), the g tile (E rows of stride
// Pp, odd), and the two y buffers (E Pp each).
size_t smem_floats(const link::Shape& s) {
  return (size_t)s.K * s.Kp + (size_t)s.E * (s.Fs + 3 * s.Pp);
}

link::Shape shape(int K, int solve, long long B) {
  link::Shape s{};
  s.K = K;
  s.P = K * (K + 1) / 2;
  s.Kp = (K + 3) & ~3;
  s.tiles = solve ? 2 : 1;
  s.Fs = s.tiles * 16 * tile_ld(solve);
  s.Fs += ((16 - s.Fs % 32) + 32) % 32;
  s.Pp = s.P | 1;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  s.E = kMaxE;
  while (s.E > 2 && (B + s.E - 1) / s.E < sms) s.E /= 2;
  return s;
}

// KS: K known at compile time (16), else 0
template <bool SOLVE, int KS>
__global__ void __launch_bounds__(kMaxE * 16)
pd_trace_grad_kernel(const float* __restrict__ y, long long sb, long long sp,
                     const float* __restrict__ C, float* __restrict__ g, long long gb,
                     long long gp, link::Shape s, long long B) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = tile_ld(SOLVE);
  const int K = KS ? KS : s.K, e = threadIdx.x >> 4, l = threadIdx.x & 15;
  // C comes by cp.async with the first tile's y (for_each_tile's first group)
  for (int i = threadIdx.x; i < K * s.Kp; i += blockDim.x) {
    const int a = i / s.Kp, b = i % s.Kp;
    if (b < K)
      link::cp_async4(smem + i, C + a * K + b);
    else
      smem[i] = 0.0f;
  }
  const pdt::Rows rows{smem, s.Kp, true};
  float* Lt = smem + K * s.Kp + e * s.Fs;  // L, then At in solve mode
  float* At = Lt + 16 * LD;                // A in solve mode
  float* gtile = smem + K * s.Kp + s.E * s.Fs;
  float* ge = gtile + e * s.Pp;
  link::for_each_tile<false>(y, sb, sp, B, s, gtile + s.E * s.Pp,
                             [&](float* ybuf, long long b0, int n) {
    const float* ys = ybuf + e * s.Pp;
    float ldiag = 0.0f;
    if (l < K) pdt::unpack_row<LD>([&](int q) { return ys[q]; }, K, l, Lt, ldiag);
    pdt::trace_grad<KS, LD>(rows, K, SOLVE, Lt, At, l, ldiag,
                            [&](int r, float v) { ge[pd::tri(r) + l] = v; });
    __syncthreads();  // the g tile is whole, and every half-warp is done with ys
    link::store_rows(g, gb, gp, gtile, s.Pp, b0, n, s.P);
  });
}

}  // namespace
}  // namespace tbt

extern "C" {

// y (B, K(K+1)/2) with element strides (sb, sp), C (K, K) contiguous ->
// g (B, K(K+1)/2), contiguous (gb = K(K+1)/2, gp = 1) or the swapped view of
// a contiguous (K(K+1)/2, B) tensor (gb = 1, gp = B); mode 0 dot, 1 solve.
// Launches on `stream`, does not synchronise, returns the cudaError_t.
int tbt_pd_trace_grad(const float* y, long long sb, long long sp, const float* C, float* g,
                      long long gb, long long gp, int K, int mode, long long B, void* stream) {
  using namespace tbt;
  const long long P = (long long)K * (K + 1) / 2;
  if (K < 1 || K > pd::kMaxK || (mode != pd::kDot && mode != pd::kSolve) ||
      !((gb == P && gp == 1) || (gb == 1 && gp == B)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const link::Shape s = shape(K, mode == pd::kSolve, B);
  const size_t bytes = sizeof(float) * smem_floats(s);
  const long long tiles = (B + s.E - 1) / s.E;
  // K = 16 known at compile time in dot mode; solve mode keeps K a runtime
  // value (at K = 16 its unrolled substitutions take 212 registers)
  const bool solve = mode == pd::kSolve;
  auto kern = solve ? pd_trace_grad_kernel<true, 0>
                    : (K == 16 ? pd_trace_grad_kernel<false, 16> : pd_trace_grad_kernel<false, 0>);
  return (int)link::launch_blocks(kern, s.E * 16, bytes, tiles, (cudaStream_t)stream, y, sb, sp, C,
                                  g, gb, gp, s, B);
}
}
