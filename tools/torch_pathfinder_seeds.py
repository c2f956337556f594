"""Multi-path Pathfinder on `chip_smoke.py`'s bench model with its
likelihood over several torch seeds: the statistics path 24 gates, a run
at a time, so their spread over seeds shows what a single run's gate
admits.

    python3 tools/torch_pathfinder_seeds.py cuda 8     # on the card
    python3 tools/torch_pathfinder_seeds.py cpu 8      # the plain versions

Each seed runs `multipath_pathfinder(model.logdensity_fn(), gen,
model.init_positions(gen, 8, 0.3))` in float32 (path 24's call, its
generator seeded afresh) and prints one JSON line: the seconds, the
pooled draws' importance ESS, the largest `w` deviation in standard
errors from the JAX package's float32 and float64 runs
(`chip_smoke.pf_multi_w_dev`), the same in the single-path statistic's
pooled spreads (`chip_smoke.pf_w_dev`), and the `w` means.
"""

import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import tpu_bijectors_torch as tbt  # noqa: E402
from tpu_bijectors_torch import dists  # noqa: E402
from tpu_bijectors_torch.infer import multipath_pathfinder  # noqa: E402


def main():
    dev = torch.device(sys.argv[1] if len(sys.argv) > 1 else "cuda")
    n_seeds = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    if dev.type == "cuda":
        from tpu_bijectors_torch.kernels import build

        build.build()
        build.load()
    loglik, _ = cs.hier_loglik_and_counts(dev)
    model = tbt.Model(cs.bench_model(dists, dev, torch.float32), loglik=loglik, device=dev)
    for seed in range(n_seeds):
        gen = torch.Generator(device=dev).manual_seed(seed)
        t = time.perf_counter()
        draws, res = multipath_pathfinder(model.logdensity_fn(), gen,
                                          model.init_positions(gen, 8, 0.3))
        print(json.dumps({
            "seed": seed, "seconds": time.perf_counter() - t, "ess": cs.pool_ess(res),
            "se_f32": cs.pf_multi_w_dev(model, draws, res, cs.PATHFINDER_JAX_F32["multi_w"]),
            "se_f64": cs.pf_multi_w_dev(model, draws, res, cs.PATHFINDER_JAX["multi_w"]),
            "spreads_f64": cs.pf_w_dev(model, draws, cs.PATHFINDER_JAX["multi_w"]),
            "w": cs.pf_w_means(model, draws).tolist()}), flush=True)


if __name__ == "__main__":
    main()
