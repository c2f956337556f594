"""The pd_conjugate witness: `chip_smoke.py`'s pd_conjugate cell (pdonly,
W = Wishart(18, I_16) and 15 iid N(0, 1), with the likelihood
100 log det W - tr(W Z'Z) / 2 on 200 Gaussian observations), sampled by the
JAX package and by the port under the cell's settings, from the starts of
`Model.sample` (N(0, 1)) or the cell's (0.3 N(0, 1)).

From N(0, 1) starts the port's float32 sampler on the card adapted its step
towards 0 and its chains did not mix; the cell starts at 0.3 N(0, 1).
Whether that failure belongs to the model in float32 (the JAX package's
sampler fails there too) or to the port (the port in float64 fails too) is
what this script measures:

    python tests/test_torch_pd_witness.py --engine jax --dtype float32
    python tests/test_torch_pd_witness.py --engine port --device cuda
    python tests/test_torch_pd_witness.py --engine port --device cpu --dtype float64

`--init-scale 0.3` starts the chains as the cell does. Each seed prints
one JSON line: the adapted step size, mean acceptance, leapfrogs per
transition, divergences, max rank-normalized R-hat, the largest distance
of W's diagonal means from the Wishart(218, (I + Z'Z)^-1) posterior's in
MCSE, the condition numbers of the starts' W (in float64, of W as the
engine's dtype holds it) and wall seconds. The random streams differ (JAX
keys, torch generators), so the engines are compared by whether the step
collapses and the chains mix, not draw by draw.

Under pytest, the two engines' log-densities and gradients are held to
each other at the cell's width in float64 at N(0, 1) states (so the
witness compares one model).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the port's PD model and the cell's data)

CHAINS, WARMUP, KEPT = chip_smoke.CHAINS, chip_smoke.WARMUP, chip_smoke.KEPT
MAX_DEPTH, TARGET = chip_smoke.MAX_DEPTH, chip_smoke.TARGET_ACCEPT


def jax_model():
    """The JAX package's pdonly (tools/mega_probe.py) with the cell's
    likelihood on the same data (rounded to float32, promoted to float64 in
    a float64 run, as the port's are)."""
    import jax.numpy as jnp

    from tpu_bijectors import dists as jd
    from tpu_bijectors.infer import Model

    ztz = jnp.asarray(chip_smoke.pd_conjugate_ztz().astype(np.float32))

    def loglik(x):
        W = x["W"]
        return 100.0 * jnp.linalg.slogdet(W)[1] - 0.5 * jnp.sum(W * ztz)

    priors = jd.NamedProduct.of(
        W=jd.Wishart(18.0, jnp.eye(chip_smoke.PD_K)),
        m=jd.IIDProduct(jd.Normal(0.0, 1.0), 15),
    )
    return Model(priors=priors, loglik=loglik)


def port_model(device, dtype):
    """The port's model as `chip_smoke.py` builds it for the cell."""
    import torch

    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists

    loglik, _ = chip_smoke.pd_conjugate_data(device)
    priors = chip_smoke.pd_model(dists, device, getattr(torch, dtype), "wishart")
    return tbt.Model(priors, loglik=loglik, device=device)


def _summary(seed, seconds, step, stats, W0, W, raw, rhat, mcse_mean):
    """One JSON-able line; W0 the starts' W (chains, K, K), W the draws'
    (kept, chains, K, K), raw the linked draws (kept, chains, dim), all
    numpy in the engine's dtype."""
    post = 218.0 * np.diag(np.linalg.inv(np.eye(chip_smoke.PD_K) + chip_smoke.pd_conjugate_ztz()))
    Wd = np.diagonal(W, axis1=-2, axis2=-1).astype(np.float64)
    dev = np.abs(Wd.mean(axis=(0, 1)) - post) / np.asarray(mcse_mean(Wd))
    cond = np.linalg.cond(W0.astype(np.float64))
    diverging = np.asarray(stats.diverging)
    return {
        "seed": seed,
        "step_size": float(step),
        "mean_accept": float(np.mean(np.asarray(stats.accept_prob))),
        "leapfrogs_per_transition": float(np.mean(np.asarray(stats.n_steps))),
        "divergences": int(diverging.sum()),
        "max_rhat": float(np.max(np.asarray(rhat(raw)))),
        "max_W_diag_dev_in_mcse": float(np.max(dev)),
        "starts_cond_W_median": float(np.median(cond)),
        "starts_cond_W_max": float(np.max(cond)),
        "seconds": seconds,
    }


def run_jax(seed, init_scale):
    """Model.sample's steps (kernel 'nuts_batched_t', the kernel the port's
    'auto' takes), the starts scaled by `init_scale`."""
    import jax

    from tpu_bijectors import diagnostics
    from tpu_bijectors.infer.sampler import sample_with_kernel

    model = jax_model()
    t0 = time.perf_counter()
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    q0 = model.init_positions(k_init, CHAINS, init_scale)
    raw, state, stats = sample_with_kernel(
        model.batched_logdensity_t_fn(), k_run, q0, n_warmup=WARMUP, n_samples=KEPT,
        kernel="nuts_batched_t", max_depth=MAX_DEPTH, target_accept=TARGET,
    )
    raw = np.asarray(raw)
    seconds = time.perf_counter() - t0
    W0 = np.asarray(model.constrain(q0)["W"])
    W = np.asarray(model.constrain(raw)["W"])
    return _summary(seed, seconds, state.eps, stats, W0, W, raw, diagnostics.rhat,
                    diagnostics.mcse_mean)


def run_port(seed, device, dtype, init_scale):
    """Model.sample's steps with the kernel 'auto' takes, the starts scaled
    by `init_scale` (at 1, the draws of Model.sample itself)."""
    import torch

    from tpu_bijectors_torch import diagnostics
    from tpu_bijectors_torch.infer import sample_with_kernel

    if device == "cpu":
        torch.set_num_threads(1)  # thousands of tiny ops: threads only add overhead
    model = port_model(device, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    q0 = model.init_positions(gen, CHAINS, init_scale)
    raw, state, stats = sample_with_kernel(
        model.batched_logdensity_t_fn(), gen, q0, n_warmup=WARMUP, n_samples=KEPT,
        kernel=model._auto_kernel(), max_depth=MAX_DEPTH, target_accept=TARGET,
    )
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    W0 = model.constrain(q0)["W"].cpu().numpy()
    W = model.constrain(raw)["W"].cpu().numpy()
    stats = type(stats)(*(t.cpu() for t in stats))
    return _summary(seed, seconds, state.eps.cpu(), stats, W0, W, raw.cpu().double(),
                    diagnostics.rhat, diagnostics.mcse_mean)


# ---------------------------------------------------------------------------
# under pytest
# ---------------------------------------------------------------------------


def test_pd_conjugate_model_matches_jax(rng):
    """The two engines sample one density: value and gradient of the cell's
    model at dim 151, float64, at N(0, 1) states (Model.sample's starts).
    The likelihood's gradient carries W^-1 (d log det W / dW), whose
    rounding grows with kappa(W): at these states kappa(W) reaches 1e9, so
    each state's gradient is held to (1e-10 + kappa(W) eps64) of its
    largest element."""
    import jax
    import jax.numpy as jnp
    import torch

    jm = jax_model()
    tm = port_model("cpu", "float64")
    vT = rng.standard_normal((tm.dim(), 3))
    jlp, jg = jax.jit(jm.batched_logdensity_t_fn().value_and_grad_fn)(jnp.asarray(vT))
    lp, g = tm.batched_logdensity_t_fn().value_and_grad_fn(torch.as_tensor(vT))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-10, atol=1e-10)
    jg = np.asarray(jg)
    kappa = np.linalg.cond(tm.constrain(torch.as_tensor(vT.T))["W"].numpy())
    err = np.abs(g.numpy() - jg).max(axis=0)
    np.testing.assert_array_less(err, (1e-10 + kappa * np.finfo(np.float64).eps)
                                 * np.abs(jg).max(axis=0))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", choices=("jax", "port"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--device", default="cuda", help="the port's device")
    ap.add_argument("--init-scale", type=float, nargs="+", default=[1.0],
                    help="starts are init_scale * N(0, 1) (Model.sample: 1; the cell: 0.3)")
    args = ap.parse_args(argv)
    if args.engine == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", args.dtype == "float64")
    for scale in args.init_scale:
        for seed in args.seeds:
            if args.engine == "jax":
                out = run_jax(seed, scale)
            else:
                out = run_port(seed, args.device, args.dtype, scale)
            out.update(engine=args.engine, dtype=args.dtype, init_scale=scale,
                       device="cpu" if args.engine == "jax" else args.device)
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
