// Positive-definite log-density pieces for Hopper (sm_90a): from the packed
// y (K(K+1)/2 slots) of each batch element and a K x K matrix C shared by
// the batch, the inverse link's logJ, sum_r y_rr (log det X = 2 sum y_rr)
// and a trace, without writing X or L:
//   mode 0 (dot, Wishart, C = S^-1):           tr(C' LL'), with C taken as
//                                               (C + C') / 2
//   mode 1 (solve, InverseWishart, C = chol(Psi)): ||L^-1 C||_F^2
//
// Replaces the TPU kernel tpu_bijectors/kernels/pd.py::pd_logdensity_pallas.
// Numerics are those of the TPU kernel and of the plain version
// (tpu_bijectors_torch/kernels/pd.py: pd_logdensity_plain).
//
// Layout: y is read through its two strides (batch, slot), so the
// batch-major slice and the swapped view of the transposed state are read
// in place. logJ, sumd and the trace (B,) are written batch-major.
//
// Bound on the card: memory. At K = 16 and B = 131072 an element reads 136
// floats and writes 3, 72.9 MB, about 21.8 us at 3.35 TB/s. Design: a
// half-warp an element, lane l holding row l of L in registers, loaded
// straight from global memory (the element's other lanes and neighbours
// hit the same lines in L1); no shared memory and no barrier. A block
// walks tiles of 16 elements (a warp two of them), the next tile's rows
// loaded while this one computes; the lanes exchange rows by shuffles.
// (Staging y in shared memory by cp.async, link_tiles.cuh's for_each_tile,
// with the dot mode below or with #12's column of M = C L from float4 reads
// of C, took 75-85 us at B = 131072 on the H100.)
//
//   dot:   tr = sum_a C_aa |L_a|^2 + sum_{a<b} (C_ab + C_ba) L_a.L_b over
//          the rows L_a of L. Lane l takes the diagonal term of row l and
//          the pairs (l, l + d mod 16), d = 1..8 (d = 8 on lanes l < 8 only),
//          receiving row l + d mod 16 by shuffles, only its entries
//          k <= 15 - d (the others meet a zero of one of the two rows): 92
//          shuffles and multiply-adds an element. The weights are
//          registers, formed once a thread.
//   solve: lane l forms column l of A = L^-1 C by forward substitution,
//          a_i = (C_il - sum_{k<i} L_ik a_k) exp(-y_ii), k ascending (#12's
//          order, pd_tiles.cuh::forward_column), L_ik and exp(-y_ii)
//          shuffled from lane i; its share is sum_i A_il^2. Column l of C
//          is registers, loaded once a thread.
//
// The lanes' shares are summed by link::group_sum; logJ and sum y_rr add
// the diagonal slots shuffled from their lanes in row order, the order of
// the plain version and of the parent kernel (their bits unchanged); lane
// 0 writes the three outputs. The kernel takes K <= 16 (kernels/pd.py
// MAX_K).

#include "link_tiles.cuh"
#include "pd_common.cuh"

namespace tbt {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kTile = kThreads / 16;  // elements a block takes at a time
constexpr int kPp = 137;  // a staged element's stride: 136 slots (K = 16), odd
constexpr int kStage = (kTile * 136 + kThreads - 1) / kThreads;  // slots a thread stages

// Row l of L of element b (live: b in the batch) into Lr, for a lane
// l < K: y off the diagonal, the diagonal slot y_ll itself (also in yd; its
// exp goes in when the row is used), zeros past it and on a lane l >= K.
// SP1: the slots are contiguous (sp = 1). At K = 16 (KS) every slot a row
// reads, past the diagonal too, lies inside the element, so the loads need
// no guard but `live`.
template <int KS, bool SP1>
__device__ __forceinline__ void load_row(const float* __restrict__ y, long long sb, long long sp,
                                         long long b, bool live, int K, int l, float (&Lr)[16],
                                         float& yd) {
  const float* p = y + b * sb + (SP1 ? pd::tri(l) : pd::tri(l) * sp);  // slot (l, 0)
  auto at = [&](int k) { return SP1 ? p[k] : p[k * sp]; };
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float v = (KS ? live : live && l < K && k <= l) ? at(k) : 0.0f;
    Lr[k] = k <= l ? v : 0.0f;
  }
  yd = live && l < K ? at(l) : 0.0f;
}

// KS: K known at compile time (16), else 0; SP1: the slots of an element
// contiguous (sp = 1)
template <bool SOLVE, int KS, bool SP1>
__global__ void __launch_bounds__(kThreads)
pd_logdensity_kernel(const float* __restrict__ y, long long sb, long long sp,
                     const float* __restrict__ C, float* __restrict__ logJ,
                     float* __restrict__ sumd, float* __restrict__ tr, int Kr, long long B) {
  const int K = KS ? KS : Kr, l = threadIdx.x & 15;
  const int e = threadIdx.x >> 4;  // the element of the tile
  // the lane's constants: dot mode its weights w (w[0] = C_ll, w[d] =
  // C_lb + C_bl for its pair (l, b = l + d mod 16)) and `mine`, bit d set
  // where pair d is the lane's (b < K, and d < 8 or l < 8); solve mode
  // column l of C
  float w[16] = {};
  unsigned mine = 0u;
  if (l < K) {
    if (SOLVE) {
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i] = i < K ? C[i * K + l] : 0.0f;
    } else {
      w[0] = C[l * K + l];
      mine = 1u;
#pragma unroll
      for (int d = 1; d <= 8; ++d) {
        const int b = (l + d) & 15;
        if (b < K && (d < 8 || l < 8)) {
          w[d] = C[l * K + b] + C[b * K + l];
          mine |= 1u << d;
        }
      }
    }
  }
  const long long tiles = (B + kTile - 1) / kTile, g = gridDim.x;
  const int P = K * (K + 1) / 2;
  auto load = [&](long long t, float (&Lr)[16], float& yd) {
    const long long b = t * kTile + e;
    load_row<KS, SP1>(y, sb, sp, b, t < tiles && b < B, K, l, Lr, yd);
  };
  // element t kTile + e of tile t, its row in Lr, y_ll in yd
  auto step = [&](long long t, float (&Lr)[16], float yd) {
    const long long b = t * kTile + e;
    // logJ and sum y_rr in row order, the diagonal slots from their lanes
    float lj = 0.0f, sd = 0.0f;
    for (int r = 0; r < K; ++r) {
      const float ydr = __shfl_sync(kFull, yd, r, 16);
      lj += (K + 1.0f - r) * ydr;
      sd += ydr;
    }
    const float ed = expf(yd);  // L_ll
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k == l && l < K) Lr[k] = ed;
    float share = 0.0f;
    if (SOLVE) {
      const float einv = expf(-yd);
      float a[16];  // column l of A = L^-1 C
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float x = 0.0f;
        if (i < K) {
          x = w[i];  // C_il minus sum_{k < i} L_ik a_k, k ascending
#pragma unroll
          for (int k = 0; k < i; ++k) x -= __shfl_sync(kFull, Lr[k], i, 16) * a[k];
          x *= __shfl_sync(kFull, einv, i, 16);
        }
        a[i] = x;
        share += a[i] * a[i];
      }
    } else {
      float x0 = 0.0f;  // |L_l|^2
#pragma unroll
      for (int k = 0; k < 16; ++k) x0 += Lr[k] * Lr[k];
      if (mine & 1u) share = w[0] * x0;
#pragma unroll
      for (int d = 1; d <= 8; ++d) {
        float x = 0.0f;  // L_l . L_b, k ascending
#pragma unroll
        for (int k = 0; k <= 15 - d; ++k)
          x += Lr[k] * __shfl_sync(kFull, Lr[k], (l + d) & 15, 16);
        if (mine & (1u << d)) share += w[d] * x;
      }
    }
    share = link::group_sum(share, 16);
    if (l == 0 && b < B) {
      logJ[b] = lj + K * pd::kLog2;
      sumd[b] = sd;
      tr[b] = share;
    }
  };
  if constexpr (SP1) {
    // two row buffers: a tile's rows load while the tile before computes
    float ra[16], rb[16], ya, yb;
    long long t = blockIdx.x;
    load(t, ra, ya);
    for (; t < tiles; t += 2 * g) {
      load(t + g, rb, yb);
      step(t, ra, ya);
      if (t + g >= tiles) break;
      load(t + 2 * g, ra, ya);
      step(t + g, rb, yb);
    }
  } else {
    // Strided slots (the swapped view: the elements contiguous): the
    // tile's y comes through shared memory, each thread loading kStage
    // slots of 16 neighbouring elements (64 contiguous bytes a half-warp)
    // for the next tile while this one computes; a lane then reads its row.
    __shared__ float ys[kTile * kPp];
    float st[kStage];
    auto fetch = [&](long long t) {
#pragma unroll
      for (int j = 0; j < kStage; ++j) {
        const int i = threadIdx.x + j * kThreads, q = i >> 4, m = i & 15;
        const long long b = t * kTile + m;
        st[j] = t < tiles && q < P && b < B ? y[b * sb + q * sp] : 0.0f;
      }
    };
    auto stage = [&]() {
#pragma unroll
      for (int j = 0; j < kStage; ++j) {
        const int i = threadIdx.x + j * kThreads, q = i >> 4;
        if (q < P) ys[(i & 15) * kPp + q] = st[j];
      }
      __syncthreads();
    };
    long long t = blockIdx.x;
    fetch(t);
    stage();
    for (; t < tiles; t += g) {
      float Lr[16], yd;
      load_row<KS, true>(ys + e * kPp, 0, 1, 0, true, K, l, Lr, yd);
      fetch(t + g);
      __syncthreads();  // every lane has its row: ys takes the next tile
      step(t, Lr, yd);
      stage();
    }
  }
}

}  // namespace
}  // namespace tbt

extern "C" {

// y (B, K(K+1)/2) with element strides (sb, sp), C (K, K) contiguous (as
// given: dot mode takes it as (C + C') / 2) -> logJ, sumd, tr (B,) each;
// mode 0 dot, 1 solve. Launches on `stream`, does not synchronise, returns
// the cudaError_t.
int tbt_pd_logdensity(const float* y, long long sb, long long sp, const float* C, float* logJ,
                      float* sumd, float* tr, int K, int mode, long long B, void* stream) {
  using namespace tbt;
  if (K < 1 || K > pd::kMaxK || (mode != pd::kDot && mode != pd::kSolve))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const bool solve = mode == pd::kSolve;
  const bool k16 = K == 16, sp1 = sp == 1;
  auto kern = solve ? (k16 ? (sp1 ? pd_logdensity_kernel<true, 16, true>
                                  : pd_logdensity_kernel<true, 16, false>)
                           : (sp1 ? pd_logdensity_kernel<true, 0, true>
                                  : pd_logdensity_kernel<true, 0, false>))
                    : (k16 ? (sp1 ? pd_logdensity_kernel<false, 16, true>
                                  : pd_logdensity_kernel<false, 16, false>)
                           : (sp1 ? pd_logdensity_kernel<false, 0, true>
                                  : pd_logdensity_kernel<false, 0, false>));
  return (int)link::launch_blocks(kern, kThreads, 0, (B + kTile - 1) / kTile,
                                  (cudaStream_t)stream, y, sb, sp, C, logJ, sumd, tr, K, B);
}
}
