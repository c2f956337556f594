"""Time the host-bound entry points of the PyTorch port with the
`tpu_bijectors_torch` of the checkout given as the argument, float32 on the
card: cell 2's ms a batched leapfrog (chip_smoke.py path 2: the bench model
with its likelihood, `kernel='nuts_batched_t'`, 64 chains, max_depth 8,
target 0.95; a short warmup, then AB_TRANSITIONS transitions timed
through `resume_sampling`, the leapfrogs counted by #2's small-design
launches) and path 23's ms an evaluation (`map_laplace` on the same
model, MAP_STEPS L-BFGS steps, the evaluations counted by #6's launches as
chip_smoke.run_map_laplace counts them). Prints one JSON line with both
and a digest of the draws' bits (equal digests: the same draws).

    python3 tools/torch_dispatch_ab.py CHECKOUT

Two commits on one card: unpack one into a directory of the checkout that
.gitignore lists (`git archive`), copy the kernel library this checkout
built into its `build/torch_ext/` (the sources hash to the same name where
they are unchanged), and run A, B, B, A in one call, each in its own
process.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (  # noqa: E402
    CHAINS,
    MAP_STEPS,
    MAX_DEPTH,
    SEED,
    SMALL,
    TARGET_ACCEPT,
    bench_model,
    digest,
    hier_loglik_and_counts,
)

AB_WARMUP = 100
AB_TRANSITIONS = 50


def main(checkout):
    sys.path.insert(0, checkout)
    import torch

    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.infer import map_laplace, resume_sampling

    dev = torch.device("cuda")
    loglik, _ = hier_loglik_and_counts(dev)
    model = tbt.Model(bench_model(dists, dev, torch.float32), loglik=loglik, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    _, state, _ = model.sample(gen, n_chains=CHAINS, n_warmup=AB_WARMUP, n_samples=0,
                               max_depth=MAX_DEPTH, target_accept=TARGET_ACCEPT,
                               constrained=False, kernel="nuts_batched_t")
    density = model.batched_logdensity_t_fn()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    raw, _, _ = resume_sampling(density, state, AB_TRANSITIONS, kernel="nuts_batched_t",
                                max_depth=MAX_DEPTH)
    torch.cuda.synchronize()
    sampling_s = time.perf_counter() - t
    leapfrogs = kernels.LAUNCHES[SMALL]
    kernels.reset_launch_counts()
    t = time.perf_counter()
    map_laplace(model, n_steps=MAP_STEPS)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t
    evals = kernels.LAUNCHES["lkj_inverse"] - 2
    print(json.dumps({"checkout": checkout, "cell2_ms_per_leapfrog": 1e3 * sampling_s / leapfrogs,
                      "leapfrogs": leapfrogs, "draws_digest": digest([raw]),
                      "map_ms_per_evaluation": 1e3 * map_s / evals, "evaluations": evals}),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
