// Positive-definite inverse link for Hopper (sm_90a): from the packed
// unconstrained vector y (K(K+1)/2 slots, the factor's lower triangle row by
// row) of each batch element, the SPD matrix X = LL', the inverse-link
// log-det logJ = sum_r (K+1-r) y_rr + K log 2, and the lower factor L
// (exp(y_rr) on its diagonal), which the Wishart-family densities use.
//
// Replaces the TPU kernel tpu_bijectors/kernels/pd.py::pd_inverse_pallas.
// Numerics are those of the TPU kernel and of the plain version
// (tpu_bijectors_torch/kernels/pd.py: pd_inverse_plain): logJ from y itself,
// never log(exp(y)); X_ab = sum_{k <= min(a,b)} L_ak L_bk, k ascending.
//
// Layout: y is read through its two strides (batch, slot), so a batch-major
// slice of a (B, dim) tensor and the swapped view of the transposed (dim, B)
// state are both read in place. X and L (B, K, K) and logJ (B,) are written
// batch-major.
//
// Bound on the card: memory. At K = 16 an element reads 136 floats and
// writes 256 + 256 + 1, against 816 multiply-adds for X; at B = 131072 that
// is 340.3 MB, 101.6 us at 3.35 TB/s, while the multiply-adds take about
// 3.2 us at the float32 peak. The design is lkj_inv.cu's (link_tiles.cuh):
// a half-warp an element, its U = L' in a K x K tile of shared memory
// (lane a writes column a: row a of y, exp on the diagonal, and its share
// of logJ), the L tile written by lanes from the y tile, X = U'U row by row,
// never mirrored; X and L leave as whole K x K tiles by 16-byte stores from
// shared memory; resident blocks of 16 elements (70 KB, three an SM) walk
// their tiles with the next y tile on its way by cp.async; at a sampler's
// B = 64 a block holds two elements (32 SMs busy). The kernels take
// K <= 16 (kernels/pd.py MAX_K).

#include "link_tiles.cuh"

namespace tbt {
namespace {

using link::tri;

// X and L leave by 16-byte stores from shared memory; TMA bulk stores
// (true) are timed beside them in PERF.md
constexpr bool kBulkStore = false;

constexpr int kMaxK = 16;
constexpr float kLog2 = 0.693147180559945309f;

// tiles: 0 U = L', 1 X, 2 L; KS = K when it is known at compile time (16),
// else 0
template <int KS>
__global__ void __launch_bounds__(link::kMaxThreads)
pd_inverse_kernel(const float* __restrict__ y, long long sb, long long sp,
                  float* __restrict__ X, float* __restrict__ logJ,
                  float* __restrict__ Lout, link::Shape s, long long B) {
  extern __shared__ __align__(16) float smem[];
  const int K = KS ? KS : s.K, Kp = KS ? KS : s.Kp, G = link::group_lanes(K);
  const int e = threadIdx.x / G, l = threadIdx.x % G;
  float* U = smem + e * s.Fs;
  float* Xt = smem + (s.E + e) * s.Fs;
  float* Lt = smem + (2 * s.E + e) * s.Fs;
  link::for_each_tile<kBulkStore>(y, sb, sp, B, s, smem + 3 * s.E * s.Fs,
                      [&](float* ybuf, long long b0, int n) {
    const float* ys = ybuf + e * s.Pp;
    float lj = 0.0f;
    for (int a = l; a < K; a += G) {
      const float* row = ys + tri(a);
      const float d = row[a];
      lj += (K + 1.0f - a) * d;
      const float ed = expf(d);
      for (int k = 0; k < K; ++k) U[k * Kp + a] = k < a ? row[k] : (k == a ? ed : 0.0f);
    }
    lj = link::group_sum(lj, G);
    if (e < n && l == 0) logJ[b0 + e] = lj + K * kLog2;
    // lane c has written U's column c, so it reads its own diagonal
    for (int c = l; c < K; c += G)
      for (int a = 0; a < K; ++a)
        Lt[a * Kp + c] = c < a ? ys[tri(a) + c] : (c == a ? U[c * Kp + c] : 0.0f);
    __syncwarp();
    link::gram<KS>(link::TileU{U, Kp}, K, l, G,
                   [&](int a, int c, float v) { Xt[a * Kp + c] = v; });
    link::tiles_written<kBulkStore>();
    link::store_tile<kBulkStore>(X, smem, 1, b0, n, s);
    link::store_tile<kBulkStore>(Lout, smem, 2, b0, n, s);
  });
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
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const link::Shape s = link::shape(K, K * (K + 1) / 2, 3, B);
  return (int)link::launch_tiles(K == 16 ? pd_inverse_kernel<16> : pd_inverse_kernel<0>, s, B,
                                 (cudaStream_t)stream, y, sb, sp, X, logJ, L, s, B);
}
}
