// The tape interpreter of the traced entries (sm_90a), shared by the loop
// kind kTraced of the whole-model kernels (fused_slab.cu) and the
// per-opcode probe (prim_probe.cu).
//
// A traced entry's linked density is a straight-line program of scalar
// opcodes (tpu_bijectors_torch/vectorize/fused_traced.py builds it from a
// trace of the density; vectorize/fused_decomp.py holds the opcodes' value
// and tangent rules in torch, which `run` follows one for one). Layout, in
// int32 words: a header {instructions, slots, output slot, inputs,
// vector, output carries a tangent}, then per instruction {opcode |
// tangent bits, destination slot, operands a, b, c}. An operand >= 0 is a
// slot; ~k is the entry's constant k (its parameter block). Tangent bits:
// kTanA, kTanB, kTanC say that operand a, b or c carries a tangent (a
// constant or a comparison's result carries none and adds no term, so no
// 0 * inf forms from it), kTanOut that the result does.
//
// `run` walks the program for one batch column in a thread: slot values
// and tangents are per-thread arrays of kMaxSlots floats (local memory,
// cached in L1), the program is read through the read-only path at the
// same address across the warp (one transaction, then L1 hits), so every
// lane runs the same opcode and the switch does not diverge. With DUAL it
// runs on dual numbers (value, tangent): one pass gives lp and the
// derivative along the inputs' tangents.
//
// Values are aten's, at the edge points too (softplus with beta 1 and
// threshold 20; sign and the tangent of abs 0 at 0 and at NaN; maximum and
// minimum propagate NaN; logaddexp of equal infinities is that infinity);
// tangents are torch's forward-mode rules (pow's guards at base 0 and
// exponent 0, clamp's slope 1 inside its closed bounds, 1/2 at the ties of
// maximum and minimum, where's tangent of the selected branch alone).
// cos and sin are the accurate cosf and sinf (no fast-math: the
// __cosf / __sinf intrinsics lose accuracy once |x| passes a few pi), their
// tangents -sin(x) t and cos(x) t.

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace tbt {
namespace tape {

// the opcodes, numbered as vectorize/fused_decomp.py's OPS (the tests
// parse this enum against it)
enum Opcode {
  kAdd = 1, kSub = 2, kMul = 3, kDiv = 4, kNeg = 5, kRecip = 6, kExp = 7, kLog = 8,
  kLog1p = 9, kExpm1 = 10, kSqrt = 11, kRsqrt = 12, kSigmoid = 13, kSoftplus = 14,
  kTanh = 15, kAsinh = 16, kAbs = 17, kSign = 18, kPow = 19, kLogaddexp = 20, kMax = 21,
  kMin = 22, kClampMin = 23, kClampMax = 24, kClamp = 25, kWhere = 26, kGe = 27, kGt = 28,
  kLe = 29, kLt = 30, kEq = 31, kNe = 32, kAnd = 33, kOr = 34, kNot = 35, kB2f = 36,
  kMaxSg = 37, kFin0 = 38, kCos = 39, kSin = 40,
};

constexpr int kMaxSlots = 64;  // fused_decomp.MAX_SLOTS
constexpr int kHeader = 6;
constexpr int kWords = 5;
constexpr int kOpMask = 0xff;
constexpr int kTanA = 1 << 8, kTanB = 1 << 9, kTanC = 1 << 10, kTanOut = 1 << 11;

// the sum of the present terms, in the plain version's order
__device__ __forceinline__ float sum2(bool ha, float a, bool hb, float b) {
  return ha ? (hb ? a + b : a) : (hb ? b : 0.0f);
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);  // 0 at +-0 and NaN, as torch.sign
}

__device__ __forceinline__ float nan_max(float x, float y) {
  return (x != x) ? x : ((y != y) ? y : (x < y ? y : x));
}

__device__ __forceinline__ float nan_min(float x, float y) {
  return (x != x) ? x : ((y != y) ? y : (y < x ? y : x));
}

__device__ __forceinline__ float b2f(bool c) { return c ? 1.0f : 0.0f; }

// One opcode on (x, y, z) with the tangents (tx, ty, tz) of the operands
// `bits` marks: the value in r, and with DUAL the tangent in t.
template <bool DUAL>
__device__ __forceinline__ void step(int code, int bits, float x, float y, float z, float tx,
                                     float ty, float tz, float& r, float& t) {
  const bool hx = bits & kTanA, hy = bits & kTanB, hz = bits & kTanC;
  t = 0.0f;
  switch (code) {
    case kAdd:
      r = x + y;
      if (DUAL) t = sum2(hx, tx, hy, ty);
      break;
    case kSub:
      r = x - y;
      if (DUAL) t = sum2(hx, tx, hy, -ty);
      break;
    case kMul:
      r = x * y;
      if (DUAL) t = sum2(hy, ty * x, hx, tx * y);
      break;
    case kDiv:
      r = x / y;
      if (DUAL) t = (hy ? (hx ? tx - ty * r : -(ty * r)) : tx) / y;
      break;
    case kNeg:
      r = -x;
      if (DUAL) t = -tx;
      break;
    case kRecip:
      r = 1.0f / x;
      if (DUAL) t = -tx * (r * r);
      break;
    case kExp:
      r = expf(x);
      if (DUAL) t = tx * r;
      break;
    case kLog:
      r = logf(x);
      if (DUAL) t = tx / x;
      break;
    case kLog1p:
      r = log1pf(x);
      if (DUAL) t = tx / (x + 1.0f);
      break;
    case kExpm1:
      r = expm1f(x);
      if (DUAL) t = tx * (r + 1.0f);
      break;
    case kSqrt:
      r = sqrtf(x);
      if (DUAL) t = tx / (2.0f * r);
      break;
    case kRsqrt:
      r = rsqrtf(x);
      if (DUAL) t = -0.5f * tx * (r * r * r);
      break;
    case kSigmoid:
      r = 1.0f / (1.0f + expf(-x));
      if (DUAL) t = tx * (1.0f - r) * r;
      break;
    case kSoftplus: {
      const float e = expf(x);
      r = x > 20.0f ? x : log1pf(e);
      if (DUAL) t = x > 20.0f ? tx : tx * e / (e + 1.0f);
      break;
    }
    case kTanh:
      r = tanhf(x);
      if (DUAL) t = tx * (1.0f - r * r);
      break;
    case kAsinh:
      r = asinhf(x);
      if (DUAL) t = tx * rsqrtf(x * x + 1.0f);
      break;
    case kAbs:
      r = fabsf(x);
      if (DUAL) t = tx * sgn(x);
      break;
    case kSign:
      r = sgn(x);
      break;  // a tangent of 0
    case kPow: {
      r = powf(x, y);
      if (DUAL) {
        const float a = y == 0.0f ? 0.0f : tx * (y * powf(x, y - 1.0f));
        const float b = ty * ((x == 0.0f && y >= 0.0f) ? 0.0f : r * logf(x));
        t = sum2(hx, a, hy, b);
      }
      break;
    }
    case kLogaddexp:
      r = (isinf(x) && x == y) ? x : nan_max(x, y) + log1pf(expf(-fabsf(x - y)));
      if (DUAL) t = sum2(hx, tx / (1.0f + expf(y - x)), hy, ty / (1.0f + expf(x - y)));
      break;
    case kMax:
    case kMin: {
      r = code == kMax ? nan_max(x, y) : nan_min(x, y);
      if (DUAL) {
        const float w = x == y ? 0.5f : b2f(code == kMax ? x > y : x < y);
        t = sum2(hx, w * tx, hy, (1.0f - w) * ty);
      }
      break;
    }
    case kClampMin:
      r = (x != x) ? x : (x < y ? y : x);
      if (DUAL) t = sum2(hx, x >= y ? tx : 0.0f, hy, x < y ? ty : 0.0f);
      break;
    case kClampMax:
      r = (x != x) ? x : (x > y ? y : x);
      if (DUAL) t = sum2(hx, x <= y ? tx : 0.0f, hy, x > y ? ty : 0.0f);
      break;
    case kClamp:
      r = (x != x) ? x : fminf(fmaxf(x, y), z);
      if (DUAL) t = (x >= y && x <= z) ? tx : 0.0f;
      break;
    case kWhere:  // where(x, y, z): the condition carries no tangent
      r = x != 0.0f ? y : z;
      if (DUAL) t = x != 0.0f ? (hy ? ty : 0.0f) : (hz ? tz : 0.0f);
      break;
    case kGe: r = b2f(x >= y); break;
    case kGt: r = b2f(x > y); break;
    case kLe: r = b2f(x <= y); break;
    case kLt: r = b2f(x < y); break;
    case kEq: r = b2f(x == y); break;
    case kNe: r = b2f(x != y); break;
    case kAnd: r = b2f(x != 0.0f && y != 0.0f); break;
    case kOr: r = b2f(x != 0.0f || y != 0.0f); break;
    case kNot: r = b2f(x == 0.0f); break;
    case kB2f: r = b2f(x != 0.0f); break;
    case kMaxSg: r = nan_max(x, y); break;
    case kFin0: r = isinf(x) ? 0.0f : x; break;
    case kCos:
      r = cosf(x);
      if (DUAL) t = -tx * sinf(x);
      break;
    case kSin:
      r = sinf(x);
      if (DUAL) t = tx * cosf(x);
      break;
    default: r = __int_as_float(0x7fffffff); break;  // an unknown opcode: NaN
  }
}

// Run `n_ins` instructions from `code` (global memory) on the slots sv
// (and, with DUAL, their tangents st) of this thread; `konst(k)` reads the
// entry's constant k. Returns the value of slot `out`.
template <bool DUAL, class Konst>
__device__ __forceinline__ float run(const int* __restrict__ code, int n_ins, Konst konst,
                                     float* sv, float* st, int out) {
  for (int i = 0; i < n_ins; ++i) {
    const int* w = code + i * kWords;
    const int op = __ldg(w), dst = __ldg(w + 1), a = __ldg(w + 2), b = __ldg(w + 3),
              c = __ldg(w + 4);
    const float x = a >= 0 ? sv[a] : konst(~a);
    const float y = b >= 0 ? sv[b] : konst(~b);
    const float z = c >= 0 ? sv[c] : konst(~c);
    float tx = 0.0f, ty = 0.0f, tz = 0.0f;
    if (DUAL) {
      if (op & kTanA) tx = st[a];
      if (op & kTanB) ty = st[b];
      if (op & kTanC) tz = st[c];
    }
    float r, t;
    step<DUAL>(op & kOpMask, op, x, y, z, tx, ty, tz, r, t);
    sv[dst] = r;
    if (DUAL && (op & kTanOut)) st[dst] = t;
  }
  return sv[out];
}

}  // namespace tape
}  // namespace tbt
