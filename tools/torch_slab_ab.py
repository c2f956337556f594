"""Time the whole-model kernels of the PyTorch port with the
`tpu_bijectors_torch` of the checkout given as the argument, float32 on the
card: the four modes (#1 slab value, #2 value-and-gradient, #3
vector-Jacobian and #4 forward-mode products) at B = 131072 on every model
`chip_smoke.py` drives through them (`AB_MODELS`: the bench model, pdonly
and its InverseWishart twin, mvdense, families, eight schools and the
three traced models), and at B = 16384 on `wide` and `wide-general` (4000
slab rows, the value mode's tables in shared and in global memory); and
#2 at the samplers' 64 chains on each sampler cell's model
(`chip_smoke.SAMPLER_MODELS`) and on the InverseWishart twin of pdonly
(the PD entry's solve mode). Prints one JSON line with the card times
(CUDA events, median of 25 timings of 10 calls) and a digest of each
output's bits (equal digests: the same outputs bit for bit).

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
    WIDE_MODELS,
    bench_model,
    digest,
    item_states,
    time_ms,
)

AB_MODELS = ("bench", "pdonly", "pdonly-invwishart", "mvdense", "families", "eight-schools",
             "generic-traced", "truncated-leaves", "vector-leaves")


def main(checkout):
    sys.path.insert(0, checkout)
    import torch

    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    dev = torch.device("cuda")
    out = {"checkout": checkout}
    builds = [(name, 131072) for name in AB_MODELS] + [(name, 16384) for name in WIDE_MODELS]
    for name, B in builds:
        if name == "bench":  # the bench model's states of every earlier A/B
            d = bench_model(dists, dev, torch.float32)
            v = 0.5 * np.random.default_rng(0).standard_normal((B, 151))
            x = torch.as_tensor(np.ascontiguousarray(v.T), dtype=torch.float32, device=dev)
        else:
            build = ITEM_MODELS.get(name) or WIDE_MODELS[name]
            d = build(dists, tbt, dev, torch.float32)
            x = None
        model = tbt.Model(d, device=dev)
        if x is None:
            x = item_states(dev, name, model.dim(), B)
        dx = torch.as_tensor(np.random.default_rng(3).standard_normal(tuple(x.shape)),
                             dtype=torch.float32, device=dev)
        ones = torch.ones(B, device=dev)
        cf, loops, _ = fk._prep(model.unconstrainer(), x)
        calls = {
            "slab_value": lambda: fk.slab_value(x, cf, loops),
            "slab_value_and_grad": lambda: fk.slab_value_and_grad(x, cf, loops, design="wide"),
            "slab_vjp": lambda: fk.slab_vjp(x, cf, ones, loops),
            "slab_jvp": lambda: fk.slab_jvp(x, cf, dx, loops),
        }
        for mode, call in calls.items():
            got = call()
            out[f"{mode} ({name}, B = {B})"] = {
                "ms": time_ms(call), "digest": digest(got if isinstance(got, tuple) else (got,))}
        del x, dx, cf, loops
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
