"""The pd_conjugate model's Hessian through the port's link Functions, on the
card in float32 against the float64 plain Hessian on the CPU, for one
checkout of the port.

    python3 tools/torch_hessian_ab.py <checkout root>

The Hessian is one double backward over 151 copies of a fixed point (0.1
N(0, 1), numpy seed 0) through `Model.batched_logdensity_fn()` of
`chip_smoke.py`'s pd_conjugate model (Wishart(18, I_16) + 15 N(0, 1) with
its Gaussian likelihood): the PD log-density kernel (#11), its trace
gradient (#12) in the first backward, and the PD inverse (#10). A checkout
whose #12 output carries no graph drops the trace term's curvature. Prints
one JSON line: the package's path, max |H|, the largest deviation and the
bound `chip_smoke.run_map_laplace` holds it to (4 eps32 K^2 max |H|).
"""

import json
import sys

import numpy as np
import torch

sys.path.insert(0, sys.argv[1])

import chip_smoke as cs  # noqa: E402
import tpu_bijectors_torch as tbt  # noqa: E402
from tpu_bijectors_torch import dists  # noqa: E402
from tpu_bijectors_torch.kernels import build  # noqa: E402


def hessian(dev, dtype, v):
    loglik, _ = cs.pd_conjugate_data(dev)
    m = tbt.Model(cs.pd_model(dists, dev, dtype, "wishart"), loglik=loglik, device=dev)
    f = m.batched_logdensity_fn()
    V = v.to(dev, dtype).expand(151, 151).clone().requires_grad_(True)
    (G,) = torch.autograd.grad(f(V).sum(), V, create_graph=True)
    (H,) = torch.autograd.grad(torch.diagonal(G).sum(), V)
    return H.double().cpu()


def main():
    if not torch.cuda.is_available():
        print("torch_hessian_ab: CUDA is not available", file=sys.stderr)
        return 2
    build.build()
    build.load()
    v = torch.as_tensor(0.1 * np.random.default_rng(0).standard_normal(151))
    H = hessian(torch.device("cuda"), torch.float32, v)
    H64 = hessian(torch.device("cpu"), torch.float64, v)
    top = float(H64.abs().max())
    print(json.dumps({"package": tbt.__file__, "max_abs_H64": top,
                      "max_abs_dev": float((H - H64).abs().max()),
                      "bound": 4 * float(np.finfo(np.float32).eps) * 16 * 16 * top}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
