// Whole-model kernels for Hopper (sm_90a): the linked log-density of the
// (dim, B) state, its one-pass value-and-gradient, its vector-Jacobian
// product and its forward-mode (Jacobian-vector) product, over slab rows
// and loop entries.
//
// Replaces the TPU kernels tpu_bijectors/vectorize/fused_kernel.py::
// mega_logdensity_t, ::mega_value_and_grad_t, ::mega_vjp_t and
// ::mega_jvp_t. A SLAB row
// computes, per state row r and batch column b, with V = vT[r, b] (masked to
// 0 on rows the slab does not own), D = V - m:
//
//   lp_row = c1*V + cq*D^2 + where(D>=0, c3p, c3n)*|D|
//          + c4*log1p(exp(sa*|D| + sb)) + c5*exp(ea*V + eb)
//          + c6*log1p((la*D)^2)
//
// (c0 has no V dependence and is added by the caller). A term whose weight
// coefficient is 0 on a row is an exact 0 even at V = +/-inf; sign(0) = 0.
// Rows no slab owns are neither read nor written by the slab pass.
//
// A LOOP entry owns a block of rows that no slab form covers. The entry
// table holds, per entry, {kind, first row, K, offset of its parameters}.
// Five kinds, from the TPU package's fused_emit.py:
//
//   1, 2  PD, dot (Wishart) and solve (InverseWishart) (_emit_pd,
//         _partials_pd): K(K+1)/2 rows read as the packed y of
//         pd_common.cuh, parameters {C (K*K, row-major), w, const}:
//         lp += logJ + w * sum_r y_rr - tr / 2 + const, with tr the dot or
//         solve trace; partials -d tr/dy / 2, plus (K+1-r) + w on the
//         diagonal slots;
//   3, 4  the Gaussian quadratic form, lower (MvNormalTril, C = L^-1) and
//         upper (MvNormalCanon, C = chol(J)') (_emit_gauss_quad,
//         _partials_gauss_quad): K rows, parameters {C, mu (K), const};
//         w = C (v - mu) over C's static triangle only, lp += -||w||^2 / 2
//         + const, partials -C'w;
//   5     the multivariate t (MvStudentT, C = L^-1 lower) (_emit_mvt,
//         _partials_mvt): parameters {C, mu, df, const}; q = ||w||^2,
//         lp += const - (df + K) / 2 * log1p(q / df), partials
//         -(df + K) / (df + q) * C'w;
//   6     traced (fused_traced.py::_traced_scalar_entry and
//         ::_traced_vector_entry, a leaf with no closed form): the entry's
//         tape (traced_tape.cuh), interpreted with the parameter block as
//         its constants. The tape array opens with one offset an entry
//         (entry e's program starts at tapes[tapes[e]]), so the entry
//         table keeps its four columns. A scalar entry runs it on each of its K rows; a
//         vector entry once over its K rows. The derivative modes run it
//         on dual numbers with a unit tangent on one input a pass (one
//         pass a row; K passes for a vector entry), so each pass gives a
//         partial, which feeds g or, times dv, acc.
//
// Four modes: the value (lp), the value and gradient (lp and g = d lp/dvT,
// TPU mega_value_and_grad_t), the vector-Jacobian product (g times a
// cotangent ct (B,), mega_vjp_t) and the forward-mode product (dlp =
// sum over rows of d lp/dvT times a tangent dvT (dim, B), mega_jvp_t).
//
// Bound on the card: memory. At the bench shape (dim 151, B 131072, float32)
// the value kernel must read dim*B*4 = 79.2 MB; value-and-gradient and the
// vector-Jacobian product read that and also write it, 158.3 MB; the
// forward-mode product reads the state and the tangent, 158.3 MB. The
// arithmetic is a few dozen operations per element, far below the card's
// float32 rate at those byte counts. The design moves each byte once: one
// thread per batch column walks the rows, so a warp's loads and stores of
// one row are 32 neighbouring floats; lp is accumulated in a register; the
// gradient is written once per row. Eight rows are loaded before they are
// used, so each thread keeps several loads in flight.
//
// Where the table lives. The coefficient table (64 bytes a row), the
// per-row term flags, the entry table and the loop parameters sit in
// shared memory and are read as broadcasts, where they fit: a model of
// slab rows only (LOOPS false, no loop code, 256 threads a block) up to
// the block's opt-in limit (227 KB, some 3600 rows); a model with loop
// entries within 100 KB together with the PD scratch of its threads. A
// larger model runs the GTAB instantiation: every thread reads the table,
// the entry table and the parameters from global memory through the
// read-only path (__ldg; the same address across a warp, so one
// transaction a warp and an L1 hit after the first), and computes a row's
// flags from its coefficients; its blocks are small enough to cover every
// SM (spread_threads). The traced entries' tapes are read from global
// memory through the read-only path in either instantiation (every lane
// of a warp reads the same word). Only a model with PD entries keeps
// per-thread scratch (pd_common.cuh, in shared memory: at K = 16, 672
// bytes a thread for the value, 1280 with the gradient), and launches as
// many threads a block as fit in 100 KB; the Gaussian and t entries keep
// their two K-vectors (r = v - mu, w) in registers, fixed arrays of 16
// unrolled with K guards.
//
// THE VALUE MODE walks RUNS, not rows (`walk::run_kernel`): maximal runs
// of consecutive slab rows that share one term set (row_flags), built once
// per model on the host (vectorize/fused_kernel.py::run_rows), each with
// its rows' coefficients packed into whole float4s. The set is uniform over
// a run, so the group branches are decided once a run, and the sets the
// driven models have, {quad} (16 bytes a row) and {absv, sp} (the
// telescoped Dirichlet and the LKJ, 32 bytes), have row functions of their
// own; every other set runs slab_row on cf's whole row. A row's
// coefficients come as one or two float4 broadcasts. The next block of
// eight rows is loaded before the current one is computed, and the first
// block before the tables are staged; only the runs and the packed
// coefficients are staged (the bench model's 4.6 KB, against 9.7 KB of
// table and flags). Rows are summed in order and a row's groups in
// slab_row's order, so lp keeps the bits of the thread-a-column kernel,
// which the other three modes still run.
//
// A traced entry is bound by the interpreter's operations, not its bytes:
// each tape instruction costs a dispatch (five uniform loads, a switch,
// local-memory slot reads and writes) around its one or few float
// operations, and the derivative modes run a pass a row (a vector entry's
// K passes each recompute its value). It is the simple, general form; a
// generated kernel per model would remove the dispatch but needs nvcc at
// every new model.
//
// SMALL BATCH. The samplers call the value-and-gradient mode on 64 chains,
// where a thread a column leaves one block of two warps to walk the whole
// model alone: a chain of row loads, then every loop entry one after
// another. There the card's time is latency, not bytes (the bench model's
// (151, 64) state is 39 KB in and out, 0.03 us at the memory's rate), and
// the floor is the launch itself. The item kernel (`item_kernel`, chosen by
// the wrapper at B <= SMALL_B) splits the model's work into ITEMS, built
// once per model on the host (vectorize/fused_kernel.py::item_rows): a
// group of up to 8 consecutive slab rows, one Gaussian or t entry, a run of
// a traced scalar entry's rows, one pass of a traced vector entry (pass j
// writes row j's partial, pass 0 alone adds the value), and one pair of
// columns of a PD entry. A block takes a tile of 32 batch columns; its warp
// w of W (up to 32 for a model of slab rows, 16 with loop entries, whose
// items take up to 128 registers a thread) takes items w, w + W, ... with
// the lanes as the tile's columns (a row's loads and stores are 32
// neighbouring floats), so the items run side by side on the block's
// warps. Where it fits, the block first stages its (dim x 32) slab of the
// state in shared memory by cp.async (row stride 33, so the PD items'
// lanes, which read one column down many rows, meet on distinct banks);
// every item reads it there. A warp loads its item's coefficients or
// parameters into its own shared scratch with coalesced reads through the
// read-only path, its first item's while the state is on its way: no pass
// stages the whole table, so a table of any size takes the same path. Items own disjoint rows of g and
// write them directly. Each warp keeps its share of lp per column in a
// register; the block sums the warps' shares in warp order after one
// barrier: no atomics, the same lp and g bit for bit on every launch.
//
// A PD item is one pair of the tile's columns, a half-warp an element with
// a lane a row and a column of the K x K matrices (K <= 16): L is unpacked
// into a tile of shared memory (row stride 17, exp(-y_rr) in column 16);
// dot mode forms M = C L one column a lane (the trace is sum L .* M, the
// partials 2 M); solve mode forms A = L^-1 C one column a lane by forward
// substitution and At = L^-T A by back substitution, the trace sum A .* A,
// and the partials -2 At A' from the two as tiles (pd_tiles.cuh, which the
// trace-gradient kernel pd_trace_grad.cu runs too); the half-warp's sums
// are group_sum (link_tiles.cuh).

#include <cuda_runtime.h>

#include <cstddef>

#include "link_tiles.cuh"
#include "pd_common.cuh"
#include "pd_tiles.cuh"
#include "traced_tape.cuh"

namespace tbt {

// coefficient columns of the (dim, kNcf) table, in the order of
// vectorize/fused_base.py::_COEF_KEYS; the trailing column is ownership
enum Col { M = 0, C0, C1, CQ, C3P, C3N, C4, SA, SB, C5, EA, EB, C6, LA, OWN };
constexpr int kNcf = 15;
constexpr int kThreads = 256;
constexpr int kRowBlock = 8;

// per-row flags: which term groups have a nonzero weight, and ownership
enum Flag : unsigned {
  kLin = 1u, kQuad = 2u, kAbsv = 4u, kSp = 8u, kExp = 16u, kL1p = 32u, kOwned = 64u
};

enum Mode { kValue = 0, kValueAndGrad = 1, kVjp = 2, kJvp = 3 };

// loop-entry kinds and the entry table's columns
enum LoopKind {
  kPdDot = 1, kPdSolve = 2, kGaussLower = 3, kGaussUpper = 4, kMvt = 5, kTraced = 6
};
constexpr int kEntCols = 4;
constexpr int kMaxQuadK = 16;  // the Gaussian and t entries' K (MAX_K)
// shared-memory budget of a block with loop entries: the table and the
// PD scratch of its threads
constexpr size_t kLoopBudget = 100 * 1024;

// a read of the table or the loop parameters: from global memory through
// the read-only path (G), or from shared memory
template <bool G, class T>
__device__ __forceinline__ T rd(const T* p) {
  if constexpr (G) return __ldg(p);
  return *p;
}

__device__ __forceinline__ float zguard(float c, float t) { return c == 0.0f ? 0.0f : t; }

__device__ __forceinline__ float sign0(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);  // sign(+-0) = +-0, NaN stays
}

__device__ __forceinline__ unsigned row_flags(const float* c) {
  unsigned f = 0u;
  if (c[C1] != 0.0f) f |= kLin;
  if (c[CQ] != 0.0f) f |= kQuad;
  if (c[C3P] != 0.0f || c[C3N] != 0.0f) f |= kAbsv;
  if (c[C4] != 0.0f) f |= kSp;
  if (c[C5] != 0.0f) f |= kExp;
  if (c[C6] != 0.0f) f |= kL1p;
  if (c[OWN] > 0.0f) f |= kOwned;
  return f;
}

// One row of the slab form: its value (VAL) and d value / dV (PAR). Groups
// are summed in the order lin, quad, absv, sp, exp, l1p, as the plain
// version does; with both requested a group shares its transcendental.
template <bool VAL, bool PAR>
__device__ __forceinline__ void slab_row(const float* c, unsigned f, float v,
                                         float& val, float& par) {
  const float vm = (f & kOwned) ? v : 0.0f;
  const float d = vm - c[M];
  val = 0.0f;
  par = 0.0f;
  if (f & kLin) {
    const float c1 = c[C1];
    if (VAL) val += zguard(c1, c1 * vm);
    if (PAR) par += c1;
  }
  if (f & kQuad) {
    const float cq = c[CQ];
    const float t = cq * d;
    if (VAL) val += zguard(cq, t * d);
    if (PAR) par += zguard(cq, 2.0f * t);
  }
  if (f & kAbsv) {
    const float sel3 = d >= 0.0f ? c[C3P] : c[C3N];
    if (VAL && PAR) {
      const float s = sel3 * sign0(d);
      val += zguard(sel3, s * d);
      par += s;
    } else if (VAL) {
      val += zguard(sel3, sel3 * fabsf(d));
    } else {
      par += sel3 * sign0(d);
    }
  }
  if (f & kSp) {
    const float c4 = c[C4];
    // sa <= 0, so the argument is <= 0 and e lies in (0, 1]
    const float e = expf(c[SA] * fabsf(d) + c[SB]);
    if (VAL) val += zguard(c4, c4 * log1pf(e));
    if (PAR) par += zguard(c4, c4 * c[SA] * sign0(d) * (e / (1.0f + e)));
  }
  if (f & kExp) {
    const float c5 = c[C5];
    const float e = expf(c[EA] * vm + c[EB]);
    if (VAL) val += zguard(c5, c5 * e);
    if (PAR) par += zguard(c5, c5 * c[EA] * e);
  }
  if (f & kL1p) {
    const float c6 = c[C6];
    const float la = c[LA];
    const float t = la * d;
    const float t2 = t * t;
    if (VAL) val += zguard(c6, c6 * log1pf(t2));
    if (PAR) par += zguard(c6, c6 * (2.0f * la * la * d) / (1.0f + t2));
  }
}

// One Gaussian or t loop entry (KIND kGaussLower, kGaussUpper or kMvt) of
// batch column b: its value goes into acc (VAL), its partials into g (the
// gradient modes, times `scale` in the VJP) or, times the tangent, into acc
// (kJvp). r = v - mu and w = C r live in registers; C, mu, df and const
// are reads of the parameter block P that every lane makes at the same
// address. Sums run in the plain version's order.
template <int MODE, int KIND, bool G>
__device__ __forceinline__ void quad_entry(const float* __restrict__ vT,
                                           const float* __restrict__ dv,
                                           float* __restrict__ g, const float* P, int row0,
                                           int K, long long b, long long B, float scale,
                                           float& acc) {
  constexpr bool VAL = MODE == kValue || MODE == kValueAndGrad;
  constexpr bool UPPER = KIND == kGaussUpper;
  const float* C = P;
  const float* mu = P + K * K;
  float r[kMaxQuadK], w[kMaxQuadK];
#pragma unroll
  for (int j = 0; j < kMaxQuadK; ++j)
    r[j] = j < K ? vT[(size_t)(row0 + j) * B + b] - rd<G>(mu + j) : 0.0f;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxQuadK; ++i) {
    float a = 0.0f;
#pragma unroll
    for (int j = UPPER ? i : 0; j < (UPPER ? kMaxQuadK : i + 1); ++j)
      if (i < K && j < K) a += rd<G>(C + i * K + j) * r[j];
    w[i] = a;
    q += w[i] * w[i];
  }
  const float df = KIND == kMvt ? rd<G>(P + K * K + K) : 0.0f;
  if (VAL) {
    if (KIND == kMvt)
      acc += rd<G>(P + K * K + K + 1) - 0.5f * (df + K) * log1pf(q / df);
    else
      acc += -0.5f * q + rd<G>(P + K * K + K);
  }
  if (MODE == kValue) return;
  const float s = KIND == kMvt ? -(df + K) / (df + q) : -1.0f;
#pragma unroll
  for (int j = 0; j < kMaxQuadK; ++j) {
    if (j < K) {
      float a = 0.0f;
#pragma unroll
      for (int i = UPPER ? 0 : j; i < (UPPER ? j + 1 : kMaxQuadK); ++i)
        if (i < K) a += rd<G>(C + i * K + j) * w[i];
      const float p = s * a;
      const size_t at = (size_t)(row0 + j) * B + b;
      if (MODE == kValueAndGrad) g[at] = p;
      if (MODE == kVjp) g[at] = p * scale;
      if (MODE == kJvp) acc += p * dv[at];
    }
  }
}

// One traced entry (tape `tp`, constants P, rows row0 .. row0 + K - 1)
// of batch column b, as quad_entry feeds acc and g. The slots live in
// this thread's local memory (tape::kMaxSlots floats each for values and
// tangents; the host declines a tape that needs more).
template <int MODE, bool G>
__device__ __forceinline__ void traced_entry(const float* __restrict__ vT,
                                             const float* __restrict__ dv,
                                             float* __restrict__ g, const float* P,
                                             const int* __restrict__ tp, int row0, int K,
                                             long long b, long long B, float scale,
                                             float& acc) {
  const int n_ins = __ldg(tp), out = __ldg(tp + 2), vec = __ldg(tp + 4), out_t = __ldg(tp + 5);
  const int* code = tp + tape::kHeader;
  auto konst = [&](int k) { return rd<G>(P + k); };
  float sv[tape::kMaxSlots], st[tape::kMaxSlots];
  if (!vec) {  // one row a pass, its own partial
    for (int r = 0; r < K; ++r) {
      const size_t at = (size_t)(row0 + r) * B + b;
      sv[0] = vT[at];
      if (MODE == kValue) {
        acc += tape::run<false>(code, n_ins, konst, sv, st, out);
        continue;
      }
      st[0] = 1.0f;
      const float val = tape::run<true>(code, n_ins, konst, sv, st, out);
      const float p = out_t ? st[out] : 0.0f;
      if (MODE == kValueAndGrad) {
        acc += val;
        g[at] = p;
      }
      if (MODE == kVjp) g[at] = p * scale;
      if (MODE == kJvp) acc += p * dv[at];
    }
    return;
  }
  if (MODE == kValue) {
    for (int i = 0; i < K; ++i) sv[i] = vT[(size_t)(row0 + i) * B + b];
    acc += tape::run<false>(code, n_ins, konst, sv, st, out);
    return;
  }
  for (int j = 0; j < K; ++j) {  // the partial along input j
    for (int i = 0; i < K; ++i) {
      sv[i] = vT[(size_t)(row0 + i) * B + b];
      st[i] = i == j ? 1.0f : 0.0f;
    }
    const float val = tape::run<true>(code, n_ins, konst, sv, st, out);
    const float p = out_t ? st[out] : 0.0f;
    const size_t at = (size_t)(row0 + j) * B + b;
    if (MODE == kValueAndGrad) {
      if (j == 0) acc += val;
      g[at] = p;
    }
    if (MODE == kVjp) g[at] = p * scale;
    if (MODE == kJvp) acc += p * dv[at];
  }
}

// The loop entries' values of batch column b, in entry order, into acc, as
// slab_kernel's value mode adds them: the value kernel's (walk::run_kernel)
// loop entries. slab_kernel keeps its own walk over the entries for the
// other three modes: calling this function from it, which computes the
// same bits, moved their times on the H100 by -35% to +40% from model to
// model (an A/B of tools/torch_slab_ab.py), where those modes are to keep
// their code.
template <bool GTAB, bool TRACED>
__device__ __forceinline__ void loop_values(const int* tent, int n_ent, const float* tprm,
                                            const int* __restrict__ tapes, float* scratch,
                                            const float* __restrict__ vT, long long b,
                                            long long B, float& acc) {
  for (int e = 0; e < n_ent; ++e) {
    const int* en = tent + e * kEntCols;
    const int kind = rd<GTAB>(en), row0 = rd<GTAB>(en + 1), K = rd<GTAB>(en + 2);
    const float* P = tprm + rd<GTAB>(en + 3);
    if (kind == kGaussLower) {
      quad_entry<kValue, kGaussLower, GTAB>(vT, nullptr, nullptr, P, row0, K, b, B, 1.0f, acc);
    } else if (kind == kGaussUpper) {
      quad_entry<kValue, kGaussUpper, GTAB>(vT, nullptr, nullptr, P, row0, K, b, B, 1.0f, acc);
    } else if (kind == kMvt) {
      quad_entry<kValue, kMvt, GTAB>(vT, nullptr, nullptr, P, row0, K, b, B, 1.0f, acc);
    } else if (TRACED && kind == kTraced) {
      traced_entry<kValue, GTAB>(vT, nullptr, nullptr, P, tapes + __ldg(tapes + e), row0, K, b,
                                 B, 1.0f, acc);
    } else {  // PD: C is P's first K*K floats, then w and const
      const float w = rd<GTAB>(P + K * K);
      const pd::Scratch s{scratch + threadIdx.x, (int)blockDim.x, K};
      float lj, sumd;
      pd::unpack([&](int q) { return vT[(size_t)(row0 + q) * B + b]; }, s, lj, sumd);
      const float tr = kind == kPdSolve ? pd::solve_trace(s, P) : pd::dot_trace(s, P);
      acc += lj + w * sumd - 0.5f * tr + rd<GTAB>(P + K * K + 1);
    }
  }
}

// LOOPS: the model has loop entries. Without them the kernel is the slab
// pass alone, every row slab-owned, and carries none of the loop code.
// GTAB: the table, the entry table and the parameters are read from global
// memory, not staged in shared memory (a model too large for it).
// TRACED: the model has traced entries. Only then does the kernel carry
// the interpreter, whose slot arrays would otherwise cost the other loop
// kinds registers and occupancy.
template <int MODE, bool LOOPS, bool GTAB, bool TRACED>
__global__ void __launch_bounds__(kThreads)
slab_kernel(const float* __restrict__ vT, const float* __restrict__ cf,
            const int* __restrict__ ent, int n_ent, const float* __restrict__ prm,
            int n_prm, const int* __restrict__ tapes, const float* __restrict__ ct,
            const float* __restrict__ dv, float* __restrict__ lp, float* __restrict__ g,
            int dim, long long B) {
  constexpr bool VAL = MODE == kValue || MODE == kValueAndGrad;
  constexpr bool PAR = MODE != kValue;
  extern __shared__ float smem[];
  const float* tcf = cf;
  const unsigned* tflags = nullptr;
  const int* tent = ent;
  const float* tprm = prm;
  float* scratch = smem;
  if (!GTAB) {
    float* scf = smem;
    unsigned* sflags = reinterpret_cast<unsigned*>(smem + (size_t)dim * kNcf);
    int* sent = reinterpret_cast<int*>(sflags + dim);
    float* sprm = reinterpret_cast<float*>(sent + n_ent * kEntCols);
    scratch = sprm + n_prm;
    for (int i = threadIdx.x; i < dim * kNcf; i += blockDim.x) scf[i] = cf[i];
    for (int i = threadIdx.x; i < n_ent * kEntCols; i += blockDim.x) sent[i] = ent[i];
    for (int i = threadIdx.x; i < n_prm; i += blockDim.x) sprm[i] = prm[i];
    __syncthreads();
    for (int r = threadIdx.x; r < dim; r += blockDim.x) sflags[r] = row_flags(scf + r * kNcf);
    __syncthreads();
    tcf = scf;
    tflags = sflags;
    tent = sent;
    tprm = sprm;
  }

  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float scale = MODE == kVjp ? ct[b] : 1.0f;
  float acc = 0.0f;

  auto owned = [&](int r) -> bool {
    if (!LOOPS) return true;
    if (GTAB) return rd<true>(tcf + (size_t)r * kNcf + OWN) > 0.0f;
    return tflags[r] & kOwned;
  };
  auto row = [&](int r, float v, float d) {
    if (LOOPS && !owned(r)) return;  // a loop entry's row
    float val, par;
    if (GTAB) {
      float c[kNcf];
#pragma unroll
      for (int k = 0; k < kNcf; ++k) c[k] = rd<true>(tcf + (size_t)r * kNcf + k);
      slab_row<VAL, PAR>(c, row_flags(c), v, val, par);
    } else {
      slab_row<VAL, PAR>(tcf + r * kNcf, tflags[r], v, val, par);
    }
    if (VAL) acc += val;
    if (MODE == kJvp) acc += par * d;
    if (MODE == kValueAndGrad) g[(size_t)r * B + b] = par;
    if (MODE == kVjp) g[(size_t)r * B + b] = par * scale;
  };

  int r = 0;
  for (; r + kRowBlock <= dim; r += kRowBlock) {
    float vv[kRowBlock], dd[kRowBlock];
#pragma unroll
    for (int k = 0; k < kRowBlock; ++k) {
      const bool own = owned(r + k);
      vv[k] = own ? vT[(size_t)(r + k) * B + b] : 0.0f;
      if (MODE == kJvp) dd[k] = own ? dv[(size_t)(r + k) * B + b] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kRowBlock; ++k) row(r + k, vv[k], MODE == kJvp ? dd[k] : 0.0f);
  }
  for (; r < dim; ++r) {
    const bool own = owned(r);
    row(r, own ? vT[(size_t)r * B + b] : 0.0f,
        MODE == kJvp && own ? dv[(size_t)r * B + b] : 0.0f);
  }

  for (int e = 0; LOOPS && e < n_ent; ++e) {
    const int* en = tent + e * kEntCols;
    const int kind = rd<GTAB>(en), row0 = rd<GTAB>(en + 1), K = rd<GTAB>(en + 2);
    const float* P = tprm + rd<GTAB>(en + 3);
    if (kind == kGaussLower) {
      quad_entry<MODE, kGaussLower, GTAB>(vT, dv, g, P, row0, K, b, B, scale, acc);
      continue;
    }
    if (kind == kGaussUpper) {
      quad_entry<MODE, kGaussUpper, GTAB>(vT, dv, g, P, row0, K, b, B, scale, acc);
      continue;
    }
    if (kind == kMvt) {
      quad_entry<MODE, kMvt, GTAB>(vT, dv, g, P, row0, K, b, B, scale, acc);
      continue;
    }
    if (TRACED && kind == kTraced) {
      traced_entry<MODE, GTAB>(vT, dv, g, P, tapes + __ldg(tapes + e), row0, K, b, B, scale,
                               acc);
      continue;
    }
    // the PD entry: C is P's first K*K floats, then w and const
    const float w = rd<GTAB>(P + K * K);
    const int mode = kind == kPdSolve ? pd::kSolve : pd::kDot;
    const pd::Scratch s{scratch + threadIdx.x, (int)blockDim.x, K};
    float lj, sumd;
    pd::unpack([&](int q) { return vT[(size_t)(row0 + q) * B + b]; }, s, lj, sumd);
    if (VAL) {
      const float tr = mode == pd::kDot ? pd::dot_trace(s, P) : pd::solve_trace(s, P);
      acc += lj + w * sumd - 0.5f * tr + rd<GTAB>(P + K * K + 1);
    }
    if (PAR) {
      pd::trace_grad(s, P, mode, [&](int q, int rr, int cc, float gt) {
        float p = -0.5f * gt;
        if (rr == cc) p += (K + 1.0f - rr) + w;
        const size_t at = (size_t)(row0 + q) * B + b;
        if (MODE == kValueAndGrad) g[at] = p;
        if (MODE == kVjp) g[at] = p * scale;
        if (MODE == kJvp) acc += p * dv[at];
      });
    }
  }
  if (MODE != kVjp) lp[b] = acc;
}

size_t fixed_smem_bytes(int dim, int n_ent, int n_prm) {
  return (size_t)dim * kNcf * sizeof(float) + (size_t)dim * sizeof(unsigned) +
         (size_t)n_ent * kEntCols * sizeof(int) + (size_t)n_prm * sizeof(float);
}

// this device's shared memory a block may opt in to (227 KB on the H100)
// and its SM count, read once
struct Limits {
  size_t smem_optin;
  int sms;
};
const Limits& limits() {
  static const Limits l = [] {
    int dev = 0, smem = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return Limits{(size_t)smem, sms};
  }();
  return l;
}

// threads a block of the GTAB instantiation: at most max_nt, and few enough
// (a multiple of 32) that the grid covers every SM. It serves models too
// large for shared memory, whose batches are often small: at B = 16384,
// 128 threads give 128 blocks where 256 would leave half the SMs idle.
int spread_threads(long long B, int max_nt) {
  const long long per_sm = (B + limits().sms - 1) / limits().sms;
  const long long nt = (per_sm + 31) / 32 * 32;
  return nt < 32 ? 32 : (nt > max_nt ? max_nt : (int)nt);
}

// ---------------------------------------------------------------------------
// the value mode: a walk over runs of rows
// ---------------------------------------------------------------------------

namespace walk {

constexpr int kRunCols = 4;  // a run: {first row, rows, term set, offset of its coefficients}
constexpr int kBlock = 8;  // rows loaded at a time (vectorize/fused_kernel.py::WALK_BLOCK)
// the term sets with a row function of their own (row_flags without
// kOwned): {quad}, and {absv, sp} (the telescoped Dirichlet's and the LKJ's
// rows); every other set takes slab_row
constexpr unsigned kQuadSet = kQuad;
constexpr unsigned kAbsvSpSet = kAbsv | kSp;
// floats a row of a run's packed coefficients: {m, cq, 0, 0}; {m, c3p,
// c3n, c4}, {sa, sb, 0, 0}; else cf's row (kNcf columns, in Col order) and
// a 0 (vectorize/fused_kernel.py::run_width)
__host__ __device__ constexpr int width(unsigned set) {
  return set == kQuadSet ? 4 : (set == kAbsvSpSet ? 8 : 16);
}

template <bool G>
__device__ __forceinline__ float4 ld4(const float* p) {
  if constexpr (G) return __ldg(reinterpret_cast<const float4*>(p));
  return *reinterpret_cast<const float4*>(p);
}

template <bool G>
__device__ __forceinline__ int4 run_at(const int* runs, int j) {
  if constexpr (G) return __ldg(reinterpret_cast<const int4*>(runs) + j);
  return reinterpret_cast<const int4*>(runs)[j];
}

// Rows r0 .. r0 + n - 1 (n <= kBlock: a block of one run) of batch column
// b into v, 0 past n or where `in` is false
__device__ __forceinline__ void load_rows(const float* __restrict__ vT, int r0, int n,
                                          long long b, long long B, bool in,
                                          float (&v)[kBlock]) {
  const float* p = vT + (size_t)r0 * B + b;
#pragma unroll
  for (int k = 0; k < kBlock; ++k) v[k] = in && k < n ? p[(size_t)k * B] : 0.0f;
}

// slab_row's value on a {quad} row, c = {m, cq}: cq != 0 on the run, so its
// zguard is the term itself, and the product stays unfused (__fmul_rn) as
// the select kept it, so the sum's bits are slab_row's
__device__ __forceinline__ float quad_value(float4 c, float v) {
  const float d = v - c.x;
  const float t = c.y * d;
  return __fmul_rn(t, d);
}

// slab_row's value on an {absv, sp} row, c0 = {m, c3p, c3n, c4}, c1 =
// {sa, sb}: c4 != 0 on the run; c3p or c3n may be 0, so sel3 keeps its
// zguard
__device__ __forceinline__ float absv_sp_value(float4 c0, float4 c1, float v) {
  const float d = v - c0.x;
  const float sel3 = d >= 0.0f ? c0.y : c0.z;
  const float val = zguard(sel3, __fmul_rn(sel3, fabsf(d)));
  // sa <= 0, so the argument is <= 0 and e lies in (0, 1]
  const float e = expf(c1.x * fabsf(d) + c1.y);
  return val + __fmul_rn(c0.w, log1pf(e));
}

// row(k, c0, c1) for the block's rows k = 0 .. n - 1 in order, with their
// W = 4 or 8 floats of coefficients from c on (row k at c + W k) as c0 (and
// c1): for a whole block unrolled without guards, each row's coefficients
// loaded while the row before it computes; else guarded
template <int W, bool G, class Row>
__device__ __forceinline__ void rows_of(const float* c, int n, Row row) {
  if (n == kBlock) {
    float4 a0 = ld4<G>(c), a1 = W > 4 ? ld4<G>(c + 4) : a0;
#pragma unroll
    for (int k = 0; k < kBlock; ++k) {
      float4 n0 = a0, n1 = a1;
      if (k + 1 < kBlock) {
        n0 = ld4<G>(c + W * (k + 1));
        if (W > 4) n1 = ld4<G>(c + W * (k + 1) + 4);
      }
      row(k, a0, a1);
      a0 = n0;
      a1 = n1;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kBlock; ++k) {
    if (k < n) {
      const float4 a0 = ld4<G>(c + W * k);
      row(k, a0, W > 4 ? ld4<G>(c + W * k + 4) : a0);
    }
  }
}

// The value of the n rows of run `run` from its row o on (v: their state),
// added to acc in row order. G: the packed coefficients pk in global
// memory.
template <bool G>
__device__ __forceinline__ void rows_value(const float* pk, int4 run, int o, int n,
                                           const float (&v)[kBlock], float& acc) {
  const unsigned set = (unsigned)run.z;
  const float* c = pk + run.w + (size_t)o * width(set);
  if (set == kQuadSet) {
    rows_of<4, G>(c, n, [&](int k, float4 a, float4) { acc += quad_value(a, v[k]); });
  } else if (set == kAbsvSpSet) {
    rows_of<8, G>(c, n,
                  [&](int k, float4 a, float4 a1) { acc += absv_sp_value(a, a1, v[k]); });
  } else {
    auto row = [&](int k) {
      const float* r = c + 16 * k;
      float cr[16];
      if constexpr (G) {
#pragma unroll
        for (int q = 0; q < 16; q += 4) {
          const float4 x = ld4<true>(r + q);
          cr[q] = x.x;
          cr[q + 1] = x.y;
          cr[q + 2] = x.z;
          cr[q + 3] = x.w;
        }
        r = cr;
      }
      float val, par;
      slab_row<true, false>(r, set | kOwned, v[k], val, par);
      acc += val;
    };
#pragma unroll
    for (int k = 0; k < kBlock; ++k)
      if (k < n) row(k);
  }
}

// The value mode (lp of each batch column): the slab rows as a walk over
// the model's runs (`runs`: n_runs rows of kRunCols ints, in row order;
// `pk`: their packed coefficients, n_pk floats), kBlock rows of a run at a
// time, the next block's loads in flight while a block computes, then the
// loop entries. The first block (rows head_row .. head_row + head_n - 1,
// run 0's first) is loaded before the tables are staged. Sums: rows in
// order, a row's groups in slab_row's order; lp is slab_kernel's bit for
// bit.
template <bool LOOPS, bool GTAB, bool TRACED>
__global__ void __launch_bounds__(kThreads)
run_kernel(const float* __restrict__ vT, const int* __restrict__ runs, int n_runs, int head_row,
           int head_n, const float* __restrict__ pk, int n_pk, const int* __restrict__ ent,
           int n_ent, const float* __restrict__ prm, int n_prm, const int* __restrict__ tapes,
           float* __restrict__ lp, long long B) {
  extern __shared__ __align__(16) float smem[];
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float cur[kBlock], nxt[kBlock];
  load_rows(vT, head_row, head_n, b, B, b < B, cur);
  const int* trun = runs;
  const float* tpk = pk;
  const int* tent = ent;
  const float* tprm = prm;
  float* scratch = smem;
  if (!GTAB) {
    int* srun = reinterpret_cast<int*>(smem);
    float* spk = smem + n_runs * kRunCols;
    int* sent = reinterpret_cast<int*>(spk + n_pk);
    float* sprm = reinterpret_cast<float*>(sent + n_ent * kEntCols);
    scratch = sprm + n_prm;
    for (int i = threadIdx.x; i < n_runs * kRunCols; i += blockDim.x) srun[i] = runs[i];
    for (int i = threadIdx.x; i < n_pk / 4; i += blockDim.x)
      reinterpret_cast<float4*>(spk)[i] = reinterpret_cast<const float4*>(pk)[i];
    for (int i = threadIdx.x; i < n_ent * kEntCols; i += blockDim.x) sent[i] = ent[i];
    for (int i = threadIdx.x; i < n_prm; i += blockDim.x) sprm[i] = prm[i];
    __syncthreads();
    trun = srun;
    tpk = spk;
    tent = sent;
    tprm = sprm;
  }
  if (b >= B) return;
  float acc = 0.0f;
  if (n_runs > 0) {
    int4 run = run_at<GTAB>(trun, 0);
    for (int j = 0, o = 0;;) {
      const int n = min(kBlock, run.y - o);
      // the next block: the rest of this run, else the next run's first rows
      int jn = j, on = o + kBlock;
      int4 next = run;
      if (on >= run.y) {
        ++jn;
        on = 0;
        if (jn < n_runs) next = run_at<GTAB>(trun, jn);
      }
      const bool more = jn < n_runs;
      if (more) load_rows(vT, next.x + on, min(kBlock, next.y - on), b, B, true, nxt);
      rows_value<GTAB>(tpk, run, o, n, cur, acc);
      if (!more) break;
#pragma unroll
      for (int k = 0; k < kBlock; ++k) cur[k] = nxt[k];
      j = jn;
      o = on;
      run = next;
    }
  }
  if constexpr (LOOPS) loop_values<GTAB, TRACED>(tent, n_ent, tprm, tapes, scratch, vT, b, B, acc);
  lp[b] = acc;
}

size_t smem_bytes(int n_runs, int n_pk, int n_ent, int n_prm) {
  return (size_t)n_runs * kRunCols * sizeof(int) + (size_t)n_pk * sizeof(float) +
         (size_t)n_ent * kEntCols * sizeof(int) + (size_t)n_prm * sizeof(float);
}

template <bool LOOPS, bool GTAB>
cudaError_t launch_with(const float* vT, const int* runs, int n_runs, int head_row, int head_n,
                        const float* pk, int n_pk, const int* ent, int n_ent, const float* prm,
                        int n_prm, const int* tapes, float* lp, long long B, int nt, size_t smem,
                        cudaStream_t stream) {
  auto kernel = (LOOPS && tapes != nullptr) ? run_kernel<LOOPS, GTAB, LOOPS>
                                            : run_kernel<LOOPS, GTAB, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (B + nt - 1) / nt;
  kernel<<<(unsigned)blocks, nt, smem, stream>>>(vT, runs, n_runs, head_row, head_n, pk, n_pk,
                                                 ent, n_ent, prm, n_prm, tapes, lp, B);
  return cudaGetLastError();
}

}  // namespace walk

// The value mode on the model's runs: the tables in shared memory where
// they fit (a model of slab rows alone: up to the block's opt-in limit;
// with loop entries: within kLoopBudget together with the PD scratch of the
// block's threads), else read through the read-only path (GTAB), as
// `launch` places the other modes' table.
cudaError_t launch_runs(const float* vT, const int* runs, int n_runs, int head_row, int head_n,
                        const float* pk, int n_pk, const int* ent, int n_ent, const float* prm,
                        int n_prm, int pd_kmax, const int* tapes, float* lp, long long B,
                        cudaStream_t stream) {
  using namespace walk;
  if (B == 0) return cudaSuccess;
  if (n_runs < 0 || n_pk % 4 != 0 || head_n < 0 || head_n > kBlock)
    return cudaErrorInvalidValue;
  const size_t table = smem_bytes(n_runs, n_pk, n_ent, n_prm);
  auto go = [&](auto kernel_with, int nt, size_t smem) {
    return kernel_with(vT, runs, n_runs, head_row, head_n, pk, n_pk, ent, n_ent, prm, n_prm, tapes,
                       lp, B, nt, smem, stream);
  };
  if (n_ent == 0) {
    if (table <= limits().smem_optin) return go(launch_with<false, false>, kThreads, table);
    return go(launch_with<false, true>, spread_threads(B, kThreads), 0);
  }
  if (pd_kmax < 0 || pd_kmax > pd::kMaxK) return cudaErrorInvalidValue;
  const int slots = pd_kmax > 0 ? pd::scratch_slots(pd_kmax, false) : 0;
  int nt = pd::threads_for(slots, table, kThreads, kLoopBudget);
  if (nt > 0)
    return go(launch_with<true, false>, nt, table + (size_t)slots * sizeof(float) * nt);
  nt = pd::threads_for(slots, 0, spread_threads(B, kThreads), kLoopBudget);
  if (nt == 0) return cudaErrorInvalidValue;
  return go(launch_with<true, true>, nt, (size_t)slots * sizeof(float) * nt);
}

template <int MODE, bool LOOPS, bool GTAB>
cudaError_t launch_with(const float* vT, const float* cf, const int* ent, int n_ent,
                        const float* prm, int n_prm, const int* tapes, const float* ct,
                        const float* dv, float* lp, float* g, int dim, long long B, int nt,
                        size_t smem, cudaStream_t stream) {
  // the interpreter only where a traced entry needs it (a model of slab
  // rows only has no tapes)
  auto kernel = (LOOPS && tapes != nullptr) ? slab_kernel<MODE, LOOPS, GTAB, LOOPS>
                                            : slab_kernel<MODE, LOOPS, GTAB, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (B + nt - 1) / nt;
  kernel<<<(unsigned)blocks, nt, smem, stream>>>(vT, cf, ent, n_ent, prm, n_prm, tapes, ct, dv,
                                                 lp, g, dim, B);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch(const float* vT, const float* cf, const int* ent, int n_ent,
                   const float* prm, int n_prm, int pd_kmax, const int* tapes,
                   const float* ct, const float* dv, float* lp, float* g, int dim, long long B,
                   cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  const size_t table = fixed_smem_bytes(dim, n_ent, n_prm);
  if (n_ent == 0) {
    if (table <= limits().smem_optin)
      return launch_with<MODE, false, false>(vT, cf, ent, n_ent, prm, n_prm, tapes, ct, dv,
                                             lp, g, dim, B, kThreads, table, stream);
    return launch_with<MODE, false, true>(vT, cf, ent, n_ent, prm, n_prm, tapes, ct, dv, lp,
                                          g, dim, B, spread_threads(B, kThreads), 0, stream);
  }
  if (pd_kmax < 0 || pd_kmax > pd::kMaxK) return cudaErrorInvalidValue;
  // per-thread scratch only where a PD entry exists
  const int slots = pd_kmax > 0 ? pd::scratch_slots(pd_kmax, MODE != kValue) : 0;
  int nt = pd::threads_for(slots, table, kThreads, kLoopBudget);
  if (nt > 0)
    return launch_with<MODE, true, false>(vT, cf, ent, n_ent, prm, n_prm, tapes, ct, dv, lp,
                                          g, dim, B, nt,
                                          table + (size_t)slots * sizeof(float) * nt, stream);
  nt = pd::threads_for(slots, 0, spread_threads(B, kThreads), kLoopBudget);
  if (nt == 0) return cudaErrorInvalidValue;
  return launch_with<MODE, true, true>(vT, cf, ent, n_ent, prm, n_prm, tapes, ct, dv, lp, g,
                                       dim, B, nt, (size_t)slots * sizeof(float) * nt, stream);
}

// ---------------------------------------------------------------------------
// the value-and-gradient mode at small batch: the item kernel
// ---------------------------------------------------------------------------

namespace items {

constexpr int kTile = 32;       // batch columns a block: a warp's lanes
constexpr int kLd = kTile + 1;  // the staged state's row stride
// a block's warps: 32 for a model of slab rows alone, 16 with loop entries
// (whose items take up to 128 registers a thread)
__host__ __device__ constexpr int max_warps(bool loops) { return loops ? 16 : 32; }
constexpr int kCols = 6;        // an item: {kind, first row, rows or K, offset, tape, j}
constexpr int kSlabGroup = 0;   // a group of slab rows; the loop kinds keep their codes
// a PD item's scratch: C (K x K), w, const, then a half-warp's L tile and
// A tile (16 rows of stride 17 each), the second half-warp's kPdHalf
// further (16 floats of padding put its tiles on the other banks);
// vectorize/fused_kernel.py::PD_SCRATCH is kPdScratch
constexpr int kPdLd = pdt::kLd;
constexpr int kPdTile = pdt::kTile;
constexpr int kPdTiles = 16 * 16 + 16;
constexpr int kPdHalf = 2 * kPdTile + 16;
constexpr int kPdScratch = kPdTiles + 2 * kPdHalf;
static_assert(kPdScratch == 1392, "vectorize/fused_kernel.py::PD_SCRATCH");
constexpr unsigned kFull = 0xffffffffu;

// the block's tile of the state and of g: column `col` of the tile is batch
// column c0 + col; `staged`: the state is read from the block's shared copy
struct Cols {
  const float* __restrict__ vT;
  const float* vs;
  float* __restrict__ g;
  long long B, c0;
  bool staged;
  __device__ __forceinline__ float v(int r, int col) const {
    if (staged) return vs[r * kLd + col];
    return c0 + col < B ? vT[(size_t)r * B + c0 + col] : 0.0f;
  }
  __device__ __forceinline__ void put(int r, int col, float p) const {
    if (c0 + col < B) g[(size_t)r * B + c0 + col] = p;
  }
};

// n floats from global memory into the warp's scratch, then the warp meets
__device__ __forceinline__ void warp_load(float* dst, const float* __restrict__ src, int n,
                                          int lane) {
  for (int i = lane; i < n; i += 32) dst[i] = __ldg(src + i);
  __syncwarp();
}

// n <= kRowBlock slab rows from row0, all slab-owned
// (the items below find their coefficients or parameters in the warp's
// scratch ws, put there by load_item)
__device__ __forceinline__ void slab_item(const Cols& s, int row0, int n, const float* ws,
                                          int lane, float& acc) {
  float v[kRowBlock];
#pragma unroll
  for (int k = 0; k < kRowBlock; ++k) v[k] = k < n ? s.v(row0 + k, lane) : 0.0f;
#pragma unroll
  for (int k = 0; k < kRowBlock; ++k) {
    if (k < n) {
      const float* c = ws + k * kNcf;
      float val, par;
      slab_row<true, true>(c, row_flags(c), v[k], val, par);
      acc += val;
      s.put(row0 + k, lane, par);
    }
  }
  __syncwarp();
}

// one Gaussian or t entry (KIND), as quad_entry computes it, its parameter
// block in the warp's scratch
template <int KIND>
__device__ __forceinline__ void quad_item(const Cols& s, int row0, int K, const float* ws,
                                          int lane, float& acc) {
  constexpr bool UPPER = KIND == kGaussUpper;
  const float* C = ws;
  const float* mu = ws + K * K;
  float r[kMaxQuadK], w[kMaxQuadK];
#pragma unroll
  for (int j = 0; j < kMaxQuadK; ++j) r[j] = j < K ? s.v(row0 + j, lane) - mu[j] : 0.0f;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxQuadK; ++i) {
    float a = 0.0f;
#pragma unroll
    for (int j = UPPER ? i : 0; j < (UPPER ? kMaxQuadK : i + 1); ++j)
      if (i < K && j < K) a += C[i * K + j] * r[j];
    w[i] = a;
    q += w[i] * w[i];
  }
  const float df = KIND == kMvt ? ws[K * K + K] : 0.0f;
  if (KIND == kMvt)
    acc += ws[K * K + K + 1] - 0.5f * (df + K) * log1pf(q / df);
  else
    acc += -0.5f * q + ws[K * K + K];
  const float sc = KIND == kMvt ? -(df + K) / (df + q) : -1.0f;
#pragma unroll
  for (int j = 0; j < kMaxQuadK; ++j) {
    if (j < K) {
      float a = 0.0f;
#pragma unroll
      for (int i = UPPER ? 0 : j; i < (UPPER ? j + 1 : kMaxQuadK); ++i)
        if (i < K) a += C[i * K + j] * w[i];
      s.put(row0 + j, lane, sc * a);
    }
  }
  __syncwarp();
}

// a run of K rows of a traced scalar entry, or pass j of a traced vector
// entry of K rows (the partial along input j; pass 0 adds the value), on
// the tape at tp with the constants P (read through the read-only path)
__device__ __forceinline__ void traced_item(const Cols& s, const float* __restrict__ P,
                                            const int* __restrict__ tp, int row0, int K, int j,
                                            int lane, float& acc) {
  const int n_ins = __ldg(tp), out = __ldg(tp + 2), vec = __ldg(tp + 4), out_t = __ldg(tp + 5);
  const int* code = tp + tape::kHeader;
  auto konst = [&](int k) { return __ldg(P + k); };
  float sv[tape::kMaxSlots], st[tape::kMaxSlots];
  if (!vec) {
    for (int r = 0; r < K; ++r) {
      sv[0] = s.v(row0 + r, lane);
      st[0] = 1.0f;
      acc += tape::run<true>(code, n_ins, konst, sv, st, out);
      s.put(row0 + r, lane, out_t ? st[out] : 0.0f);
    }
    return;
  }
  for (int i = 0; i < K; ++i) {
    sv[i] = s.v(row0 + i, lane);
    st[i] = i == j ? 1.0f : 0.0f;
  }
  const float val = tape::run<true>(code, n_ins, konst, sv, st, out);
  if (j == 0) acc += val;
  s.put(row0 + j, lane, out_t ? st[out] : 0.0f);
}

// columns 2 pair and 2 pair + 1 of a PD entry (K <= 16): a half-warp each,
// lane l the matrices' row and column l; lp += logJ + w sum_r y_rr - tr / 2
// + const, partials -d tr/dy / 2 plus (K+1-r) + w on the diagonal slots
// (pd_tiles.cuh's trace gradient, the terms summed here over the
// half-warp's lanes)
__device__ __forceinline__ void pd_item(const Cols& s, bool solve, int row0, int K, int pair,
                                        float* ws, int lane, float& acc) {
  const float* C = ws;
  const float w = ws[K * K], cst = ws[K * K + 1];
  const int h = lane >> 4, l = lane & 15, col = 2 * pair + h;
  float* Lt = ws + kPdTiles + h * kPdHalf;  // L, then At in solve mode
  float* At = Lt + kPdTile;                 // A in solve mode
  float lj = 0.0f, sd = 0.0f, ldiag = 0.0f;
  if (l < K) {
    const float yd =
        pdt::unpack_row<kPdLd>([&](int q) { return s.v(row0 + q, col); }, K, l, Lt, ldiag);
    lj = (K + 1.0f - l) * yd;
    sd = yd;
  }
  const float logJ = link::group_sum(lj, 16) + K * pd::kLog2;
  const float sumd = link::group_sum(sd, 16);
  const float t = pdt::trace_grad<0, kPdLd>(pdt::Rows{C, K, false}, K, solve, Lt, At, l, ldiag,
                                  [&](int r, float gt) {
    float p = -0.5f * gt;
    if (r == l) p += (K + 1.0f - r) + w;
    s.put(row0 + pd::tri(r) + l, col, p);
  });
  const float tr = link::group_sum(t, 16);
  const float val = logJ + w * sumd - 0.5f * tr + cst;
  const float got = __shfl_sync(kFull, val, lane == 2 * pair + 1 ? 16 : 0);
  if (lane == 2 * pair || lane == 2 * pair + 1) acc += got;
  __syncwarp();
}

// An item's coefficients (a slab group's rows of cf) or parameter block (a
// Gaussian, t or PD entry's; a traced entry reads its constants in place)
// into the warp's scratch.
template <bool LOOPS>
__device__ __forceinline__ void load_item(const int* __restrict__ im,
                                          const float* __restrict__ cf,
                                          const float* __restrict__ prm, float* ws, int lane) {
  const int kind = __ldg(im), row0 = __ldg(im + 1), n = __ldg(im + 2);
  if (!LOOPS || kind == kSlabGroup) {
    warp_load(ws, cf + (size_t)row0 * kNcf, n * kNcf, lane);
    return;
  }
  const float* P = prm + __ldg(im + 3);
  if (kind == kGaussLower || kind == kGaussUpper)
    warp_load(ws, P, n * n + n + 1, lane);
  else if (kind == kMvt)
    warp_load(ws, P, n * n + n + 2, lane);
  else if (kind != kTraced)
    warp_load(ws, P, n * n + 2, lane);  // PD: C, w, const
}

// LOOPS: the model has loop entries (else every item is a slab group);
// TRACED: traced entries (only then the interpreter's slots); `staged`:
// the block's slab of the state sits in shared memory
template <bool LOOPS, bool TRACED>
__global__ void __launch_bounds__(max_warps(LOOPS) * 32)
item_kernel(const float* __restrict__ vT, const float* __restrict__ cf,
            const int* __restrict__ items, int n_items, const float* __restrict__ prm,
            const int* __restrict__ tapes, int wscr, int staged, float* __restrict__ lp,
            float* __restrict__ g, int dim, long long B) {
  extern __shared__ float smem[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* part = smem;                             // the warps' shares of lp
  float* ws = smem + nw * kTile + warp * wscr;    // this warp's scratch
  float* vs = smem + nw * kTile + nw * wscr;      // the staged state
  const long long c0 = (long long)blockIdx.x * kTile;
  if (staged) {
    for (int i = threadIdx.x; i < dim * kTile; i += blockDim.x) {
      const int r = i / kTile, c = i % kTile;
      float* dst = vs + r * kLd + c;
      if (c0 + c < B)
        link::cp_async4(dst, vT + (size_t)r * B + c0 + c);
      else
        *dst = 0.0f;
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  // the warp's first item's parameters load while the state is on its way
  if (warp < n_items) load_item<LOOPS>(items + warp * kCols, cf, prm, ws, lane);
  if (staged) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
  }
  const Cols s{vT, vs, g, B, c0, staged != 0};
  float acc = 0.0f;
  for (int it = warp; it < n_items; it += nw) {
    const int* im = items + it * kCols;
    if (it != warp) load_item<LOOPS>(im, cf, prm, ws, lane);
    const int kind = __ldg(im), row0 = __ldg(im + 1), n = __ldg(im + 2);
    if (!LOOPS || kind == kSlabGroup) {
      slab_item(s, row0, n, ws, lane, acc);
      continue;
    }
    if constexpr (LOOPS) {
      const int j = __ldg(im + 5);
      if (kind == kGaussLower) {
        quad_item<kGaussLower>(s, row0, n, ws, lane, acc);
      } else if (kind == kGaussUpper) {
        quad_item<kGaussUpper>(s, row0, n, ws, lane, acc);
      } else if (kind == kMvt) {
        quad_item<kMvt>(s, row0, n, ws, lane, acc);
      } else if (kind == kTraced) {
        if constexpr (TRACED)
          traced_item(s, prm + __ldg(im + 3), tapes + __ldg(im + 4), row0, n, j, lane, acc);
      } else if (c0 + 2 * j < B) {  // a PD pair with a column in the batch
        pd_item(s, kind == kPdSolve, row0, n, j, ws, lane, acc);
      }
    }
  }
  part[warp * kTile + lane] = acc;
  __syncthreads();
  if (warp == 0) {
    float t = part[lane];
    for (int k = 1; k < nw; ++k) t += part[k * kTile + lane];
    if (c0 + lane < B) lp[c0 + lane] = t;
  }
}

template <bool LOOPS, bool TRACED>
cudaError_t launch_with(const float* vT, const float* cf, const int* items, int n_items,
                        const float* prm, const int* tapes, int wscr, bool staged, float* lp,
                        float* g, int dim, long long B, int nw, size_t smem,
                        cudaStream_t stream) {
  auto kernel = item_kernel<LOOPS, TRACED>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (B + kTile - 1) / kTile;
  kernel<<<(unsigned)blocks, nw * 32, smem, stream>>>(vT, cf, items, n_items, prm, tapes, wscr,
                                                      (int)staged, lp, g, dim, B);
  return cudaGetLastError();
}

}  // namespace items

// The item kernel on n_items items (items::kCols int32 each), `wscr`
// floats of scratch a warp, `loops` whether any item is a loop entry. The
// state is staged where it fits beside the warps' scratch.
cudaError_t launch_items(const float* vT, const float* cf, const int* item_tab, int n_items,
                         const float* prm, const int* tapes, int wscr, int loops, float* lp,
                         float* g, int dim, long long B, cudaStream_t stream) {
  using namespace items;
  if (B == 0) return cudaSuccess;
  if (n_items <= 0 || wscr < 0) return cudaErrorInvalidValue;
  const int nw = n_items < max_warps(loops) ? n_items : max_warps(loops);
  const size_t fixed = (size_t)nw * (kTile + wscr) * sizeof(float);
  const size_t staged = (size_t)dim * kLd * sizeof(float);
  const bool stage = fixed + staged <= limits().smem_optin;
  const size_t smem = fixed + (stage ? staged : 0);
  if (smem > limits().smem_optin) return cudaErrorInvalidValue;
  if (!loops)
    return launch_with<false, false>(vT, cf, item_tab, n_items, prm, tapes, wscr, stage, lp, g,
                                     dim, B, nw, smem, stream);
  if (tapes != nullptr)
    return launch_with<true, true>(vT, cf, item_tab, n_items, prm, tapes, wscr, stage, lp, g, dim,
                                   B, nw, smem, stream);
  return launch_with<true, false>(vT, cf, item_tab, n_items, prm, tapes, wscr, stage, lp, g, dim,
                                  B, nw, smem, stream);
}

// a kernel that does nothing: its time is the launch floor
__global__ void empty_kernel() {}

cudaError_t launch_empty(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return cudaGetLastError();
}

cudaError_t launch_slab(int mode, const float* vT, const float* cf, const int* ent,
                        int n_ent, const float* prm, int n_prm, int pd_kmax, const int* tapes,
                        const float* ct, const float* dv, float* lp, float* g, int dim,
                        long long B, cudaStream_t stream) {
  switch (mode) {
    case kValueAndGrad:
      return launch<kValueAndGrad>(vT, cf, ent, n_ent, prm, n_prm, pd_kmax, tapes, ct, dv, lp,
                                   g, dim, B, stream);
    case kVjp:
      return launch<kVjp>(vT, cf, ent, n_ent, prm, n_prm, pd_kmax, tapes, ct, dv, lp, g, dim,
                          B, stream);
    case kJvp:
      return launch<kJvp>(vT, cf, ent, n_ent, prm, n_prm, pd_kmax, tapes, ct, dv, lp, g, dim,
                          B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tbt
