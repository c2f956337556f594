// The trace gradient of the positive-definite links on tiles of shared
// memory, a half-warp an element (K <= 16): lane l owns row and column l of
// the K x K matrices. Shared by pd_trace_grad.cu (#12) and the PD items of
// fused_slab.cu's item kernel (#2's small design), which run the same
// arithmetic in the same order.
//
// An element's L sits in a 16-row tile of row stride LD, exp(-y_rr) in
// column 16, zeros above the diagonal up to column K - 1. LD = 17 (the item
// kernel's, and #12's dot mode): the lanes of a half-warp writing their
// rows, or reading down a column, meet on distinct banks. LD = 20 (#12's
// solve mode): rows are 16-byte aligned, so a row that the lanes read whole
// (a broadcast) comes four entries a load, at the price of 2-way conflicts
// where lanes write their rows. Solve mode needs a second tile of the same
// shape. y packs the lower triangle row by row (slot r(r+1)/2 + c,
// pd_common.cuh).
//
//   dot:   lane l forms column l of M = C L a row at a time (C read by
//          rows, four entries a load); g_rl = 2 M_rl for r >= l.
//   solve: lane l forms column l of A = L^-1 C by forward substitution and
//          column l of At = L^-T A by back substitution; the two go to the
//          tiles (At over L) and g_rl = -2 (At A')_rl = -2 sum_j At_rj A_lj.
// Each times L_rr on the diagonal slots. Every sum runs over its index in
// ascending order, whatever the stride. Tensor cores do not apply: the
// products are K <= 16 in float32, a few hundred multiply-adds an element,
// and 3xTF32 would loosen the float32 bounds the checks hold.

#pragma once

#include <cuda_runtime.h>

#include "pd_common.cuh"

namespace tbt {
namespace pdt {

constexpr int kLd = 17;          // the item kernel's row stride
constexpr int kTile = 16 * kLd;  // floats a tile at that stride

// four entries of a row from column j0 on: one load where the row stride LD
// keeps them 16-byte aligned
template <int LD>
__device__ __forceinline__ float4 row4(const float* row, int j0) {
  if constexpr (LD % 4 == 0) return *reinterpret_cast<const float4*>(row + j0);
  return make_float4(row[j0], row[j0 + 1], row[j0 + 2], row[j0 + 3]);
}

// acc + sum_{j < n} v_j w[j0 + j] over the four entries of v, j ascending
__device__ __forceinline__ float fma4(float acc, float4 v, const float* w, int j0, int n) {
  if (n > 0) acc += v.x * w[j0];
  if (n > 1) acc += v.y * w[j0 + 1];
  if (n > 2) acc += v.z * w[j0 + 2];
  if (n > 3) acc += v.w * w[j0 + 3];
  return acc;
}

// Row l of L into Lt from y (Load: slot -> value), for a lane l < K: y off
// the diagonal, exp(y_ll) on it (also returned in ldiag), exp(-y_ll) in
// column 16, zeros above the diagonal; every lane writes K + 1 entries, so
// the half-warp's stores stay in step. Returns y_ll.
template <int LD, class Load>
__device__ __forceinline__ float unpack_row(Load y, int K, int l, float* Lt, float& ldiag) {
  const int base = pd::tri(l);
  const float yd = y(base + l);
  ldiag = expf(yd);
#pragma unroll
  for (int c = 0; c < 16; ++c)
    if (c < K) Lt[l * LD + c] = c < l ? y(base + c) : (c == l ? ldiag : 0.0f);
  Lt[l * LD + 16] = expf(-yd);
  return yd;
}

// C (K x K) for the dot mode's rows: four entries of row a from column b0
// on, zero past column K - 1 (the callers only use the entries below K)
struct Rows {
  const float* c;
  int ld;      // the row stride
  bool vec4;   // ld a multiple of 4 and c 16-byte aligned: one load
  __device__ __forceinline__ float at(int a, int b) const { return c[a * ld + b]; }
  __device__ __forceinline__ float4 row4(int a, int b0, int K) const {
    if (vec4) return *reinterpret_cast<const float4*>(c + a * ld + b0);
    auto get = [&](int b) { return b < K ? c[a * ld + b] : 0.0f; };
    return make_float4(get(b0), get(b0 + 1), get(b0 + 2), get(b0 + 3));
  }
};

// d tr / d y for the element whose L the lanes have unpacked into Lt (their
// rows written, not yet met): emit(r, g) for each slot (r, l), r = l..K-1,
// of a live lane l < K. At (solve mode) is the second tile; Lt is
// overwritten there. Returns the lane's share of the trace: dot
// sum_{a >= l} L_al M_al, solve sum_i A_il^2. Every lane of the warp calls
// it (it meets the warp). KS: K known at compile time (16), else 0 and K
// is Kr; LD: the tiles' row stride. The arithmetic is the same for all.
template <int KS, int LD, class Emit>
__device__ __forceinline__ float trace_grad(const Rows& C, int Kr, bool solve, float* Lt,
                                            float* At, int l, float ldiag, Emit emit) {
  const int K = KS ? KS : Kr;
  const bool live = l < K;
  __syncwarp();
  float t = 0.0f;
  if (!solve) {
    float lb[16];  // column l of L
#pragma unroll
    for (int b = 0; b < 16; ++b) lb[b] = b < K && live ? Lt[b * LD + l] : 0.0f;
#pragma unroll
    for (int a = 0; a < 16; ++a) {
      if (a < K && live) {
        float acc = 0.0f;  // M_al = sum_b C_ab L_bl, b ascending
#pragma unroll
        for (int b0 = 0; b0 < 16; b0 += 4)
          if (b0 < K) acc = fma4(acc, C.row4(a, b0, K), lb, b0, K - b0);
        if (a >= l) {
          t += Lt[a * LD + l] * acc;
          float gt = 2.0f * acc;
          if (a == l) gt *= ldiag;
          emit(a, gt);
        }
      }
    }
    return t;
  }
  float a[16], at[16];  // column l of A = L^-1 C and of At = L^-T A
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float x = 0.0f;
    if (i < K && live) {
      x = C.at(i, l);  // minus sum_{k < i} L_ik a_k, k ascending
#pragma unroll
      for (int k0 = 0; k0 < i; k0 += 4) {
        const float4 li = row4<LD>(Lt + i * LD, k0);
        x -= li.x * a[k0];
        if (k0 + 1 < i) x -= li.y * a[k0 + 1];
        if (k0 + 2 < i) x -= li.z * a[k0 + 2];
        if (k0 + 3 < i) x -= li.w * a[k0 + 3];
      }
      x *= Lt[i * LD + 16];
    }
    a[i] = x;
    t += a[i] * a[i];
  }
#pragma unroll
  for (int i = 15; i >= 0; --i) {
    float x = 0.0f;
    if (i < K && live) {
      x = a[i];
#pragma unroll
      for (int k = i + 1; k < 16; ++k)
        if (k < K) x -= Lt[k * LD + i] * at[k];
      x *= Lt[i * LD + 16];
    }
    at[i] = x;
  }
  __syncwarp();  // every lane is done with L: At takes its place
  if (live) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i < K) {
        At[i * LD + l] = a[i];
        Lt[i * LD + l] = at[i];
      }
    }
  }
  __syncwarp();
  if (live) {
    float al[16];  // row l of A
#pragma unroll
    for (int j = 0; j < 16; ++j) al[j] = j < K ? At[l * LD + j] : 0.0f;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if (r < K && r >= l) {
        float G = 0.0f;  // (At A')_rl, summed over the columns j in order
#pragma unroll
        for (int j0 = 0; j0 < 16; j0 += 4)
          if (j0 < K) G = fma4(G, row4<LD>(Lt + r * LD, j0), al, j0, K - j0);
        float gt = -2.0f * G;
        if (r == l) gt *= ldiag;
        emit(r, gt);
      }
    }
  }
  return t;
}

}  // namespace pdt
}  // namespace tbt
