// A probe of the slab engine's per-element math for Hopper (sm_90a): raw
// kernels that each add one piece of the slab rows' work to a floor pass,
// so that the time of each piece can be read off against the floor.
//
// Replaces the TPU probe tools/transcend_probe.py::make_kernel (its two
// pallas_call sites, the value variants and floor_g). Every variant reads
// the state vT (dim, B), scales it by the column's coefficient,
// X = V * c[col % 2048] (c is (1, 2048): each 2048-column block of the TPU
// probe read c[0, :2048]), and writes lp (1, B) = sum over rows of X^2
// plus the variant's own per-element term:
//
//   floor      nothing more (the memory floor of a value kernel)
//   floor_g    also writes g = X + 1 (dim, B) (the floor of a kernel that
//              writes the gradient)
//   alu8       eight ALU operations (abs, select, multiply-adds)
//   exp1       exp(-|X|)            log1       log(1.5 + |X|)
//   sp         log1p(exp(-2|X|))    sp_poly    exp, then a degree-7
//                                              polynomial for log1p
//   sig        sigmoid(-2|X|)       spsig      sp and sig, independent
//   spsig_sh   one exp, the polynomial log1p and e / (1 + e)
//   spsig_sh2  one exp, log1p and e / (1 + e)
//   sel4       four selects         band16     alu8 on the first 16 rows
//
// The sums run in the plain version's order (tpu_bijectors_torch/kernels/
// probe.py): the X^2 sum and the extra term's sum in two registers, added
// at the end.
//
// Bound on the card: memory. At dim 151, B = 131072 a variant reads
// 79.2 MB and writes 0.5 MB, 23.8 us at 3.35 TB/s; floor_g writes 79.2 MB
// more, 47.4 us. The design is the slab kernel's (csrc/fused_slab.cu):
// one thread per batch column walks the rows, so a warp reads 32
// neighbouring floats of a row; the column's coefficient is one load a
// thread; eight rows are loaded before they are used. What the slab kernel
// has and the probe lacks is the coefficient table, the per-row flags and
// their decode: the gap between a variant here and the slab kernel of the
// same math is the cost of that structure.

#include <cuda_runtime.h>

#include <cmath>

namespace tbt {
namespace {

constexpr int kThreads = 256;
constexpr int kRowBlock = 8;
constexpr int kCWidth = 2048;
constexpr int kBand = 16;

enum Variant {
  kFloor = 0, kFloorG, kAlu8, kExp1, kLog1, kSp, kSpPoly, kSig, kSpSig, kSpSigSh,
  kSpSigSh2, kSel4, kBand16, kNumVariants
};

struct Poly {
  float p[8];  // highest degree first
};

__device__ __forceinline__ float poly_log1p(float z, const Poly& P) {
  float acc = P.p[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) acc = acc * z + P.p[i];
  return acc;
}

__device__ __forceinline__ float alu8(float x) {
  const float u = fabsf(x);
  float t = x >= 0.0f ? u * 1.25f : u * 0.75f;
  t = t * t + u;
  t = t > 1.0f ? t - 1.0f : t;
  return t * 0.5f + u;
}

// the variant's extra term of one element of row r
template <int V>
__device__ __forceinline__ float extra(float x, int r, const Poly& P) {
  if (V == kAlu8) return alu8(x);
  if (V == kBand16) return r < kBand ? alu8(x) : 0.0f;
  if (V == kExp1) return expf(-fabsf(x));
  if (V == kLog1) return logf(1.5f + fabsf(x));
  if (V == kSp) return log1pf(expf(-2.0f * fabsf(x)));
  if (V == kSpPoly) return poly_log1p(expf(-2.0f * fabsf(x)), P);
  if (V == kSig) return 1.0f / (1.0f + expf(2.0f * fabsf(x)));
  if (V == kSpSig) {
    const float a = -2.0f * fabsf(x);
    return log1pf(expf(a)) + 1.0f / (1.0f + expf(-a));
  }
  if (V == kSpSigSh || V == kSpSigSh2) {
    const float e = expf(-2.0f * fabsf(x));
    const float l = V == kSpSigSh ? poly_log1p(e, P) : log1pf(e);
    return l + e / (1.0f + e);
  }
  if (V == kSel4) {
    float t = x > 0.0f ? x : 0.0f;
    t = x > 1.0f ? t : x * 0.5f;
    t = x < -1.0f ? t : x * 0.25f;
    return x != 0.0f ? t : 0.0f;
  }
  return 0.0f;  // kFloor, kFloorG
}

template <int V>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* __restrict__ vT, const float* __restrict__ c, float* __restrict__ lp,
             float* __restrict__ g, int dim, long long B, Poly P) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float cc = c[b % kCWidth];
  float sq = 0.0f, ex = 0.0f;
  int r = 0;
  for (; r + kRowBlock <= dim; r += kRowBlock) {
    float x[kRowBlock];
#pragma unroll
    for (int k = 0; k < kRowBlock; ++k) x[k] = vT[(size_t)(r + k) * B + b] * cc;
#pragma unroll
    for (int k = 0; k < kRowBlock; ++k) {
      sq += x[k] * x[k];
      if (V == kFloorG) g[(size_t)(r + k) * B + b] = x[k] + 1.0f;
      if (V != kFloor && V != kFloorG) ex += extra<V>(x[k], r + k, P);
    }
  }
  for (; r < dim; ++r) {
    const float x = vT[(size_t)r * B + b] * cc;
    sq += x * x;
    if (V == kFloorG) g[(size_t)r * B + b] = x + 1.0f;
    if (V != kFloor && V != kFloorG) ex += extra<V>(x, r, P);
  }
  lp[b] = sq + ex;
}

template <int V>
cudaError_t launch(const float* vT, const float* c, float* lp, float* g, int dim, long long B,
                   const Poly& P, cudaStream_t stream) {
  const long long blocks = (B + kThreads - 1) / kThreads;
  probe_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(vT, c, lp, g, dim, B, P);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tbt

extern "C" {

// vT (dim, B) and c (2048,) -> lp (B,) (and, for floor_g, g (dim, B)), all
// contiguous float32; `variant` is the index of the variant in the list
// above; `poly` the 8 host floats of the degree-7 log1p polynomial,
// highest degree first. Launches on `stream`, does not synchronise,
// returns the cudaError_t.
int tbt_transcend_probe(int variant, const float* vT, const float* c, float* lp, float* g,
                        const float* poly, int dim, long long B, void* stream) {
  using namespace tbt;
  if (B == 0) return 0;
  Poly P;
  for (int i = 0; i < 8; ++i) P.p[i] = poly[i];
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case kFloor: return (int)launch<kFloor>(vT, c, lp, g, dim, B, P, st);
    case kFloorG: return (int)launch<kFloorG>(vT, c, lp, g, dim, B, P, st);
    case kAlu8: return (int)launch<kAlu8>(vT, c, lp, g, dim, B, P, st);
    case kExp1: return (int)launch<kExp1>(vT, c, lp, g, dim, B, P, st);
    case kLog1: return (int)launch<kLog1>(vT, c, lp, g, dim, B, P, st);
    case kSp: return (int)launch<kSp>(vT, c, lp, g, dim, B, P, st);
    case kSpPoly: return (int)launch<kSpPoly>(vT, c, lp, g, dim, B, P, st);
    case kSig: return (int)launch<kSig>(vT, c, lp, g, dim, B, P, st);
    case kSpSig: return (int)launch<kSpSig>(vT, c, lp, g, dim, B, P, st);
    case kSpSigSh: return (int)launch<kSpSigSh>(vT, c, lp, g, dim, B, P, st);
    case kSpSigSh2: return (int)launch<kSpSigSh2>(vT, c, lp, g, dim, B, P, st);
    case kSel4: return (int)launch<kSel4>(vT, c, lp, g, dim, B, P, st);
    case kBand16: return (int)launch<kBand16>(vT, c, lp, g, dim, B, P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
}
