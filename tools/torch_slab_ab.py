"""Time the bench model's three whole-model kernels (slab value,
value-and-gradient, vector-Jacobian product) on the PyTorch port at
B = 131072, float32, with the `tpu_bijectors_torch` of the checkout given as
the argument; prints one JSON line with the card times (CUDA events, median
of 25 timings of 10 calls) and checksums of lp and g.

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

from chip_smoke import bench_model, time_ms  # noqa: E402  (one model, one timer for A and B)


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
    cf = fk._prep(u, vT)[0]
    ones = torch.ones(131072, device=dev)
    out = {
        "checkout": checkout,
        "slab_value": time_ms(lambda: fk.slab_value(vT, cf)),
        "slab_value_and_grad": time_ms(lambda: fk.slab_value_and_grad(vT, cf)),
        "slab_vjp": time_ms(lambda: fk.slab_vjp(vT, cf, ones)),
    }
    lp, g = fk.slab_value_and_grad(vT, cf)
    out["lp_sum"] = float(lp.double().sum())
    out["g_sum"] = float(g.double().sum())
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
