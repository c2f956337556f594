// The per-opcode probe of the traced entries' interpreter for Hopper
// (sm_90a): one opcode, as a one-instruction tape, run by the interpreter's
// own device function (traced_tape.cuh, `tape::run` on dual numbers) over a
// grid of B inputs.
//
// Replaces the TPU probe tools/prim_lowering_probe.py::probe, which
// compiles a one-op Pallas kernel per primitive to record which primitives
// lower on the TPU (its PRIM_LOWERING.json pins the JAX package's
// admission set). On Hopper every opcode compiles with the interpreter, so
// the question this probe answers is whether the card computes each one
// right: tpu_bijectors_torch/kernels/prim_probe.py holds every value and
// tangent it returns against the torch op and torch.autograd in float64,
// at the op's edge points (+-0, ties, bounds, +-1e10, +-inf), and fails
// on any opcode of the admission set that disagrees.
//
// The tape (host-built, global memory) reads its three operands from the
// slots 0, 1, 2, loaded from x, y and z; the tangents of the operands are
// the scalars sx, sy, sz (a unit tangent on one operand gives the partial
// along it). Writes the value r (B,) and the tangent t (B,).
//
// Bound on the card: memory. Three float reads and two float writes an
// element, 2.6 MB at B = 131072, 0.78 us at 3.35 TB/s; one opcode is a
// few operations an element. One thread an element.

#include <cuda_runtime.h>

#include "traced_tape.cuh"

namespace tbt {
namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
prim_probe_kernel(const int* __restrict__ tp, const float* __restrict__ consts,
                  const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ z, float sx, float sy, float sz,
                  float* __restrict__ r, float* __restrict__ t, long long B) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n_ins = __ldg(tp), out = __ldg(tp + 2), out_t = __ldg(tp + 5);
  float sv[4], st[4];
  sv[0] = x[b];
  sv[1] = y[b];
  sv[2] = z[b];
  st[0] = sx;
  st[1] = sy;
  st[2] = sz;
  auto konst = [&](int k) { return __ldg(consts + k); };
  r[b] = tape::run<true>(tp + tape::kHeader, n_ins, konst, sv, st, out);
  t[b] = out_t ? st[out] : 0.0f;
}

}  // namespace
}  // namespace tbt

extern "C" int tbt_prim_probe(const int* tape, const float* consts, const float* x,
                              const float* y, const float* z, float sx, float sy, float sz,
                              float* r, float* t, long long B, void* stream) {
  if (B == 0) return 0;
  const long long blocks = (B + tbt::kThreads - 1) / tbt::kThreads;
  tbt::prim_probe_kernel<<<(unsigned)blocks, tbt::kThreads, 0, (cudaStream_t)stream>>>(
      tape, consts, x, y, z, sx, sy, sz, r, t, B);
  return (int)cudaGetLastError();
}
