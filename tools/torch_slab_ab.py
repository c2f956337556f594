"""Time the whole-model kernels of the PyTorch port with the
`tpu_bijectors_torch` of the checkout given as the argument: the bench
model's four modes (slab value, value-and-gradient, vector-Jacobian and
forward-mode products) at B = 131072, and the value-and-gradient mode
(#2) at the samplers' 64 chains on each sampler cell's model (bench,
pdonly, mvdense, eight schools, generic-traced; `chip_smoke.SAMPLER_MODELS`),
float32, and on the InverseWishart twin of pdonly (the PD entry's solve
mode). Prints one JSON line with the card times (CUDA events, median of
25 timings of 10 calls), checksums of lp and g, and at 64 chains a digest
of their bits (equal digests: the same lp and g bit for bit).

    python3 tools/torch_slab_ab.py CHECKOUT

To compare two commits on one card, unpack one into a directory of the
checkout that .gitignore lists (`git archive`) and run the two in turns in
one call: A, B, B, A.
"""

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# one set of models, states and one timer for A and B
from chip_smoke import (  # noqa: E402
    CHAINS,
    ITEM_MODELS,
    SAMPLER_MODELS,
    bench_model,
    digest,
    item_states,
    time_ms,
)


def main(checkout):
    sys.path.insert(0, checkout)
    import torch

    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    dev = torch.device("cuda")
    u = tbt.Model(bench_model(dists, dev, torch.float32), device=dev).unconstrainer()
    v = 0.5 * np.random.default_rng(0).standard_normal((131072, 151))
    vT = torch.as_tensor(np.ascontiguousarray(v.T), dtype=torch.float32, device=dev)
    dvT = torch.as_tensor(np.random.default_rng(3).standard_normal((151, 131072)),
                          dtype=torch.float32, device=dev)
    cf = fk._prep(u, vT)[0]
    ones = torch.ones(131072, device=dev)
    out = {
        "checkout": checkout,
        "slab_value": time_ms(lambda: fk.slab_value(vT, cf)),
        "slab_value_and_grad": time_ms(lambda: fk.slab_value_and_grad(vT, cf)),
        "slab_vjp": time_ms(lambda: fk.slab_vjp(vT, cf, ones)),
        "slab_jvp": time_ms(lambda: fk.slab_jvp(vT, cf, dvT)),
    }
    lp, g = fk.slab_value_and_grad(vT, cf)
    out["lp_sum"] = float(lp.double().sum())
    out["g_sum"] = float(g.double().sum())
    cells = [(f"cell {cell}", name) for cell, name in SAMPLER_MODELS.items()]
    for tag, name in cells + [("solve mode", "pdonly-invwishart")]:
        model = tbt.Model(ITEM_MODELS[name](dists, tbt, dev, torch.float32), device=dev)
        x = item_states(dev, name, model.dim(), CHAINS)
        cf_m, loops, _ = fk._prep(model.unconstrainer(), x)
        key = f"slab_value_and_grad B = 64 ({name}, {tag})"
        out[key] = time_ms(lambda: fk.slab_value_and_grad(x, cf_m, loops))
        lp, g = fk.slab_value_and_grad(x, cf_m, loops)
        out[key + " lp_sum"] = float(lp.double().sum())
        out[key + " g_sum"] = float(g.double().sum())
        out[key + " digest"] = digest((lp, g))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
