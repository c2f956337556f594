// Whole-model kernels for Hopper (sm_90a): the linked log-density of the
// (dim, B) state, its one-pass value-and-gradient, and its vector-Jacobian
// product, over slab rows and loop entries.
//
// Replaces the TPU kernels tpu_bijectors/vectorize/fused_kernel.py::
// mega_logdensity_t, ::mega_value_and_grad_t and ::mega_vjp_t. A SLAB row
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
// The PD entry (kinds 1 dot, Wishart, and 2 solve, InverseWishart: the TPU
// package's fused_emit.py::_emit_pd and _partials_pd) reads its
// K(K+1)/2 rows as the packed y of pd_common.cuh, with parameters
// {C (K*K, row-major), w, const}, and adds
//
//   logJ + w * sum_r y_rr - tr / 2 + const
//
// with tr the dot or solve trace; its partials are -d tr/dy / 2, plus
// (K+1-r) + w on the diagonal slots.
//
// Bound on the card: memory. At the bench shape (dim 151, B 131072, float32)
// the value kernel must read dim*B*4 = 79.2 MB; value-and-gradient and the
// vector-Jacobian product read that and also write it, 158.3 MB. The
// arithmetic is a few dozen operations per element, far below the card's
// float32 rate at those byte counts. The design moves each byte once: one
// thread per batch column walks the rows, so a warp's loads and stores of
// one row are 32 neighbouring floats; the coefficient table, the per-row
// term flags, the entry table and the loop parameters sit in shared memory
// and are read as broadcasts; lp is accumulated in a register; the gradient
// is written once per row. Eight rows are loaded before they are used, so
// each thread keeps several loads in flight. A model with loop entries also
// gives each thread the PD scratch of pd_common.cuh in shared memory (at
// K = 16, 672 bytes for the value, 1280 with the gradient), and launches as
// many threads a block as fit in 100 KB; a model without runs the
// instantiation without loop code (LOOPS false), 256 threads a block.

#include <cuda_runtime.h>

#include <cstddef>

#include "pd_common.cuh"

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

enum Mode { kValue = 0, kValueAndGrad = 1, kVjp = 2 };

// loop-entry kinds and the entry table's columns
enum LoopKind { kPdDot = 1, kPdSolve = 2 };
constexpr int kEntCols = 4;

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

// LOOPS: the model has loop entries. Without them the kernel is the slab
// pass alone, every row slab-owned, and carries none of the loop code.
template <int MODE, bool LOOPS>
__global__ void __launch_bounds__(kThreads)
slab_kernel(const float* __restrict__ vT, const float* __restrict__ cf,
            const int* __restrict__ ent, int n_ent, const float* __restrict__ prm,
            int n_prm, const float* __restrict__ ct, float* __restrict__ lp,
            float* __restrict__ g, int dim, long long B) {
  constexpr bool VAL = MODE != kVjp;
  constexpr bool PAR = MODE != kValue;
  extern __shared__ float smem[];
  float* scf = smem;
  unsigned* sflags = reinterpret_cast<unsigned*>(smem + (size_t)dim * kNcf);
  int* sent = reinterpret_cast<int*>(sflags + dim);
  float* sprm = reinterpret_cast<float*>(sent + n_ent * kEntCols);
  float* scratch = sprm + n_prm;
  for (int i = threadIdx.x; i < dim * kNcf; i += blockDim.x) scf[i] = cf[i];
  for (int i = threadIdx.x; i < n_ent * kEntCols; i += blockDim.x) sent[i] = ent[i];
  for (int i = threadIdx.x; i < n_prm; i += blockDim.x) sprm[i] = prm[i];
  __syncthreads();
  for (int r = threadIdx.x; r < dim; r += blockDim.x) sflags[r] = row_flags(scf + r * kNcf);
  __syncthreads();

  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float scale = MODE == kVjp ? ct[b] : 1.0f;
  float acc = 0.0f;

  auto row = [&](int r, float v) {
    if (LOOPS && !(sflags[r] & kOwned)) return;  // a loop entry's row
    float val, par;
    slab_row<VAL, PAR>(scf + r * kNcf, sflags[r], v, val, par);
    if (VAL) acc += val;
    if (MODE == kValueAndGrad) g[(size_t)r * B + b] = par;
    if (MODE == kVjp) g[(size_t)r * B + b] = par * scale;
  };
  auto load = [&](int r) {
    return (!LOOPS || (sflags[r] & kOwned)) ? vT[(size_t)r * B + b] : 0.0f;
  };

  int r = 0;
  for (; r + kRowBlock <= dim; r += kRowBlock) {
    float vv[kRowBlock];
#pragma unroll
    for (int k = 0; k < kRowBlock; ++k) vv[k] = load(r + k);
#pragma unroll
    for (int k = 0; k < kRowBlock; ++k) row(r + k, vv[k]);
  }
  for (; r < dim; ++r) row(r, load(r));

  for (int e = 0; LOOPS && e < n_ent; ++e) {
    const int* en = sent + e * kEntCols;
    const int row0 = en[1], K = en[2];
    const float* C = sprm + en[3];
    const float w = C[K * K];
    const int mode = en[0] == kPdSolve ? pd::kSolve : pd::kDot;
    const pd::Scratch s{scratch + threadIdx.x, (int)blockDim.x, K};
    float lj, sumd;
    pd::unpack([&](int q) { return vT[(size_t)(row0 + q) * B + b]; }, s, lj, sumd);
    if (VAL) {
      const float tr = mode == pd::kDot ? pd::dot_trace(s, C) : pd::solve_trace(s, C);
      acc += lj + w * sumd - 0.5f * tr + C[K * K + 1];
    }
    if (PAR) {
      pd::trace_grad(s, C, mode, [&](int q, int rr, int cc, float gt) {
        float p = -0.5f * gt;
        if (rr == cc) p += (K + 1.0f - rr) + w;
        g[(size_t)(row0 + q) * B + b] = MODE == kVjp ? p * scale : p;
      });
    }
  }
  if (VAL) lp[b] = acc;
}

size_t fixed_smem_bytes(int dim, int n_ent, int n_prm) {
  return (size_t)dim * kNcf * sizeof(float) + (size_t)dim * sizeof(unsigned) +
         (size_t)n_ent * kEntCols * sizeof(int) + (size_t)n_prm * sizeof(float);
}

template <int MODE, bool LOOPS>
cudaError_t launch_with(const float* vT, const float* cf, const int* ent, int n_ent,
                        const float* prm, int n_prm, const float* ct, float* lp, float* g,
                        int dim, long long B, int nt, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        slab_kernel<MODE, LOOPS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (B + nt - 1) / nt;
  slab_kernel<MODE, LOOPS><<<(unsigned)blocks, nt, smem, stream>>>(
      vT, cf, ent, n_ent, prm, n_prm, ct, lp, g, dim, B);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch(const float* vT, const float* cf, const int* ent, int n_ent,
                   const float* prm, int n_prm, int kmax, const float* ct, float* lp,
                   float* g, int dim, long long B, cudaStream_t stream) {
  const size_t fixed = fixed_smem_bytes(dim, n_ent, n_prm);
  if (n_ent == 0)
    return launch_with<MODE, false>(vT, cf, ent, n_ent, prm, n_prm, ct, lp, g, dim, B,
                                    kThreads, fixed, stream);
  if (kmax < 1 || kmax > pd::kMaxK) return cudaErrorInvalidValue;
  const int slots = pd::scratch_slots(kmax, MODE != kValue);
  const int nt = pd::threads_for(slots, fixed, kThreads, 100 * 1024);
  if (nt == 0) return cudaErrorInvalidValue;
  return launch_with<MODE, true>(vT, cf, ent, n_ent, prm, n_prm, ct, lp, g, dim, B, nt,
                                 fixed + (size_t)slots * sizeof(float) * nt, stream);
}

cudaError_t launch_slab(int mode, const float* vT, const float* cf, const int* ent,
                        int n_ent, const float* prm, int n_prm, int kmax, const float* ct,
                        float* lp, float* g, int dim, long long B, cudaStream_t stream) {
  switch (mode) {
    case kValue:
      return launch<kValue>(vT, cf, ent, n_ent, prm, n_prm, kmax, ct, lp, g, dim, B, stream);
    case kValueAndGrad:
      return launch<kValueAndGrad>(vT, cf, ent, n_ent, prm, n_prm, kmax, ct, lp, g, dim, B,
                                   stream);
    case kVjp:
      return launch<kVjp>(vT, cf, ent, n_ent, prm, n_prm, kmax, ct, lp, g, dim, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tbt
