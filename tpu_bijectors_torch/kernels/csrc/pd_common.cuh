// Device functions of the positive-definite (Wishart-family) links. One
// thread handles one batch element. Scratch, unpack, dot_trace,
// solve_trace and trace_grad serve only the PD loop entry of fused_slab.cu
// (#1, #3, #4 and #2's kernel of a thread a column). The trace gradient
// pd_trace_grad.cu (#12) and #2's PD items run pd_tiles.cuh's half-warp
// tiles instead, and the log-density pd_logdensity.cu (#11) a half-warp an
// element with the rows of L in registers; they share tri, kMaxK, kLog2
// and the modes below.
//
// y packs the lower triangle of the factor row by row: slot r(r+1)/2 + c for
// c <= r (the reference's pd.jl:36-43 order). L has y off the diagonal and
// exp(y_rr) on it; the inverse diagonal is taken as exp(-y_rr), as the TPU
// kernels (tpu_bijectors/kernels/pd.py) take it, not as 1 / L_rr.
//
// A thread's factor and work vectors (K(K+1)/2 + K floats, twice that and
// two K-vectors for the solve-mode gradient) would spill out of registers at
// K = 16, so they live in shared memory, slot-major across the block's
// threads (Scratch: slot s of thread t at p[s * nt + t], so a warp touches 32
// consecutive words, no bank conflicts). The K x K matrix C is one copy in
// shared memory that every thread reads as a broadcast.

#pragma once

#include <cuda_runtime.h>

namespace tbt {
namespace pd {

constexpr int kMaxK = 16;
constexpr float kLog2 = 0.693147180559945309f;

enum Mode { kDot = 0, kSolve = 1 };

__host__ __device__ constexpr int tri(int r) { return r * (r + 1) / 2; }

// A thread's scratch: L's packed slots [0, P), exp(-y_rr) [P, P + K), the
// vector a [P + K, P + 2K), and for the gradient the vector at
// [P + 2K, P + 3K) and G [P + 3K, 2P + 3K).
struct Scratch {
  float* p;  // this thread's slot 0
  int nt;    // the block's threads: the stride between slots
  int K;
  __device__ __forceinline__ float& at(int s) const { return p[s * nt]; }
  __device__ __forceinline__ float& L(int r, int c) const { return at(tri(r) + c); }
  __device__ __forceinline__ float& einv(int r) const { return at(tri(K) + r); }
  __device__ __forceinline__ float& va(int i) const { return at(tri(K) + K + i); }
  __device__ __forceinline__ float& vat(int i) const { return at(tri(K) + 2 * K + i); }
  __device__ __forceinline__ float& G(int s) const { return at(tri(K) + 3 * K + s); }
};

// slots a thread needs: the value (L, exp(-y_rr), a) or the gradient too
__host__ __device__ constexpr int scratch_slots(int K, bool grad) {
  return grad ? 2 * tri(K) + 3 * K : tri(K) + 2 * K;
}

// L and exp(-y_rr) from y (Load: slot -> value); logJ = sum_r (K+1-r) y_rr +
// K log 2 and sumd = sum_r y_rr, summed in the TPU kernel's order.
template <class Load>
__device__ __forceinline__ void unpack(Load y, const Scratch& s, float& logJ, float& sumd) {
  const int K = s.K;
  logJ = 0.0f;
  sumd = 0.0f;
  for (int r = 0; r < K; ++r) {
    const int base = tri(r);
    for (int c = 0; c < r; ++c) s.L(r, c) = y(base + c);
    const float yd = y(base + r);
    logJ += (K + 1.0f - r) * yd;
    sumd += yd;
    s.L(r, r) = expf(yd);
    s.einv(r) = expf(-yd);
  }
  logJ += K * kLog2;
}

// dot trace: sum_{a <= b} w_ab C_ab (LL')_ab, w = 1 on the diagonal and 2
// off it (C symmetric, so this is tr(C X))
__device__ __forceinline__ float dot_trace(const Scratch& s, const float* C) {
  const int K = s.K;
  float tr = 0.0f;
  for (int a = 0; a < K; ++a) {
    for (int b = a; b < K; ++b) {
      float acc = 0.0f;
      for (int k = 0; k <= a; ++k) acc += s.L(a, k) * s.L(b, k);
      const float w = a == b ? 1.0f : 2.0f;
      tr += w * acc * C[a * K + b];
    }
  }
  return tr;
}

// a = L^-1 C[:, j] by forward substitution
__device__ __forceinline__ void forward_column(const Scratch& s, const float* C, int j) {
  const int K = s.K;
  for (int i = 0; i < K; ++i) {
    float acc = C[i * K + j];
    for (int k = 0; k < i; ++k) acc -= s.L(i, k) * s.va(k);
    s.va(i) = acc * s.einv(i);
  }
}

// solve trace: ||L^-1 C||_F^2, one column of C at a time
__device__ __forceinline__ float solve_trace(const Scratch& s, const float* C) {
  const int K = s.K;
  float tr = 0.0f;
  for (int j = 0; j < K; ++j) {
    forward_column(s, C, j);
    for (int i = 0; i < K; ++i) tr += s.va(i) * s.va(i);
  }
  return tr;
}

// d trace / d y_slot, handed to emit(slot, r, c, g) for every lower slot:
// dot: 2 (C L)_rc; solve: -2 (At A')_rc with A = L^-1 C, At = L^-T A,
// accumulated one column j of C at a time (a = A[:, j], at = At[:, j],
// G_rc += at_r a_c); each times L_rr on the diagonal (the chain rule
// through exp).
template <class Emit>
__device__ __forceinline__ void trace_grad(const Scratch& s, const float* C, int mode, Emit emit) {
  const int K = s.K;
  if (mode == kDot) {
    for (int r = 0; r < K; ++r) {
      for (int c = 0; c <= r; ++c) {
        float cl = 0.0f;  // (C L)_rc = sum_{a >= c} C[r, a] L[a, c]
        for (int a = c; a < K; ++a) cl += C[r * K + a] * s.L(a, c);
        float g = 2.0f * cl;
        if (c == r) g *= s.L(r, r);
        emit(tri(r) + c, r, c, g);
      }
    }
    return;
  }
  for (int q = 0; q < tri(K); ++q) s.G(q) = 0.0f;
  for (int j = 0; j < K; ++j) {
    forward_column(s, C, j);
    for (int i = K - 1; i >= 0; --i) {
      float acc = s.va(i);
      for (int k = i + 1; k < K; ++k) acc -= s.L(k, i) * s.vat(k);
      s.vat(i) = acc * s.einv(i);
    }
    for (int r = 0; r < K; ++r) {
      const float atr = s.vat(r);
      for (int c = 0; c <= r; ++c) s.G(tri(r) + c) += atr * s.va(c);
    }
  }
  for (int r = 0; r < K; ++r) {
    for (int c = 0; c <= r; ++c) {
      float g = -2.0f * s.G(tri(r) + c);
      if (c == r) g *= s.L(r, r);
      emit(tri(r) + c, r, c, g);
    }
  }
}

// the largest multiple of 32 threads, at most `max_nt`, whose scratch and
// `fixed` bytes fit in `budget` bytes of shared memory (0 if none does)
inline int threads_for(int slots, size_t fixed, int max_nt, size_t budget) {
  int nt = max_nt;
  while (nt >= 32 && fixed + (size_t)slots * sizeof(float) * nt > budget) nt -= 32;
  return nt >= 32 ? nt : 0;
}

}  // namespace pd
}  // namespace tbt
