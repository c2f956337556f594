// Plain C interface of the whole-model kernels (fused_slab.cu), loaded with
// ctypes by tpu_bijectors_torch/kernels/build.py. Every function launches on
// the given stream, does not synchronise, and returns the launch's
// cudaError_t (0 on success). The caller has checked devices, dtypes, shapes
// and contiguity, and allocated every output. The loop entries: `ent`
// (n_ent, 4) int32 rows {kind, first row, K, parameter offset} into `prm`
// (n_prm floats), `tape` the traced entries' programs (int32: n_ent
// offsets, entry e's program at tape[tape[e]]; null where the model has no
// traced entry), `kmax` the largest K of the PD entries (0 where there is
// none: it sizes the per-thread scratch); n_ent = 0 (null pointers) for a
// model of slab rows only.

#include <cuda_runtime.h>

namespace tbt {
cudaError_t launch_slab(int mode, const float* vT, const float* cf, const int* ent,
                        int n_ent, const float* prm, int n_prm, int pd_kmax, const int* tape,
                        const float* ct, const float* dv, float* lp, float* g, int dim,
                        long long B, cudaStream_t stream);
cudaError_t launch_items(const float* vT, const float* cf, const int* item_tab, int n_items,
                         const float* prm, const int* tapes, int wscr, int loops, float* lp,
                         float* g, int dim, long long B, cudaStream_t stream);
cudaError_t launch_runs(const float* vT, const int* runs, int n_runs, int head_row, int head_n,
                        const float* pk, int n_pk, const int* ent, int n_ent, const float* prm,
                        int n_prm, int pd_kmax, const int* tapes, float* lp, long long B,
                        cudaStream_t stream);
cudaError_t launch_empty(cudaStream_t stream);
}  // namespace tbt

extern "C" {

// lp (B,) = sum over rows and loop entries; vT (dim, B). The slab rows
// come as runs: `runs` (n_runs, 4) int32 rows {first row, rows, term set,
// offset into pk}, in row order, `pk` their packed coefficients (n_pk
// floats, a multiple of 4), rows head_row .. head_row + head_n - 1 the
// first run's first block (head_n = 0 where there is no run)
int tbt_slab_value(const float* vT, const int* runs, int n_runs, int head_row, int head_n,
                   const float* pk, int n_pk, const int* ent, int n_ent, const float* prm,
                   int n_prm, int kmax, const int* tape, float* lp, long long B, void* stream) {
  return (int)tbt::launch_runs(vT, runs, n_runs, head_row, head_n, pk, n_pk, ent, n_ent, prm,
                               n_prm, kmax, tape, lp, B, (cudaStream_t)stream);
}

// lp (B,) and g = d lp / d vT (dim, B) in one pass
int tbt_slab_value_and_grad(const float* vT, const float* cf, const int* ent, int n_ent,
                            const float* prm, int n_prm, int kmax, const int* tape, float* lp,
                            float* g, int dim, long long B, void* stream) {
  return (int)tbt::launch_slab(1, vT, cf, ent, n_ent, prm, n_prm, kmax, tape, nullptr,
                               nullptr, lp, g, dim, B, (cudaStream_t)stream);
}

// lp and g as tbt_slab_value_and_grad, by the item kernel (the small-batch
// design): `items` (n_items, 6) int32 rows {kind, first row, rows or K,
// parameter offset, tape offset, pass or column pair}, `wscr` floats of
// shared scratch a warp, `loops` nonzero where an item is a loop entry
int tbt_slab_value_and_grad_items(const float* vT, const float* cf, const int* items,
                                  int n_items, const float* prm, const int* tape, int wscr,
                                  int loops, float* lp, float* g, int dim, long long B,
                                  void* stream) {
  return (int)tbt::launch_items(vT, cf, items, n_items, prm, tape, wscr, loops, lp, g, dim, B,
                                (cudaStream_t)stream);
}

// a kernel that does nothing, on one warp: the launch floor
int tbt_empty(void* stream) { return (int)tbt::launch_empty((cudaStream_t)stream); }

// g = (d lp / d vT) * ct, ct (B,)
int tbt_slab_vjp(const float* vT, const float* cf, const int* ent, int n_ent,
                 const float* prm, int n_prm, int kmax, const int* tape, const float* ct,
                 float* g, int dim, long long B, void* stream) {
  return (int)tbt::launch_slab(2, vT, cf, ent, n_ent, prm, n_prm, kmax, tape, ct, nullptr,
                               nullptr, g, dim, B, (cudaStream_t)stream);
}

// dlp (B,) = sum over rows of (d lp / d vT) * dvT, dvT (dim, B)
int tbt_slab_jvp(const float* vT, const float* cf, const int* ent, int n_ent,
                 const float* prm, int n_prm, int kmax, const int* tape, const float* dvT,
                 float* dlp, int dim, long long B, void* stream) {
  return (int)tbt::launch_slab(3, vT, cf, ent, n_ent, prm, n_prm, kmax, tape, nullptr, dvT,
                               dlp, nullptr, dim, B, (cudaStream_t)stream);
}

const char* tbt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
}
