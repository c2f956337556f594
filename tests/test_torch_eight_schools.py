"""Eight schools, non-centered (`examples/eight_schools_nuts.py`, Rubin's
1981 data), in both packages: the model of `chip_smoke.py`'s eight_schools
cell (mu ~ Normal(0, 5), tau ~ HalfCauchy(5), theta_raw ~ 8 iid N(0, 1),
linked dim 10).

Under pytest, the two packages' log-densities and gradients are held to
each other in float64 on the CPU, on both layouts, at states that reach
the funnel's neck (tau ~ e^-4) and its mouth.

As a script it samples the model under the cell's settings (64 chains,
max_depth 8, 300 warmup transitions, target 0.8, starts 0.5 N(0, 1)) and
prints one JSON line a seed: the posterior means of mu and tau with their
MCSE, the max rank-normalized R-hat, divergences and the adapted step:

    python tests/test_torch_eight_schools.py --engine jax --kept 4000
    python tests/test_torch_eight_schools.py --engine port --device cuda

The JAX package's float64 run with 4000 kept draws a chain gives the
means and MCSE that the cell's gate holds the port's draws to
(`chip_smoke.ES_JAX`).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the cell's model, data and settings)

CHAINS, WARMUP, MAX_DEPTH = chip_smoke.CHAINS, chip_smoke.WARMUP, chip_smoke.MAX_DEPTH


def jax_model():
    """The example's model in the JAX package (float64 where x64 is on)."""
    import jax.numpy as jnp

    from tpu_bijectors import dists as jd
    from tpu_bijectors.infer import Model

    y = jnp.asarray(chip_smoke.ES_Y)
    sigma = jnp.asarray(chip_smoke.ES_SIGMA)

    def loglik(x):
        theta = x["mu"] + x["tau"] * x["theta_raw"]
        return jnp.sum(-0.5 * ((y - theta) / sigma) ** 2)

    priors = jd.NamedProduct.of(
        mu=jd.Normal(0.0, 5.0),
        tau=jd.HalfCauchy(5.0),
        theta_raw=jd.IIDProduct(jd.Normal(0.0, 1.0), 8),
    )
    return Model(priors=priors, loglik=loglik)


def port_model(device, dtype):
    import torch

    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists

    dt = getattr(torch, dtype)
    return tbt.Model(chip_smoke.eight_schools_model(dists, device, dt),
                     loglik=chip_smoke.eight_schools_loglik(device, dt), device=device)


def _summary(seed, seconds, step, stats, mu, tau, raw, rhat, mcse_mean):
    """mu, tau (kept, chains) and raw (kept, chains, dim), numpy."""
    return {
        "seed": seed,
        "kept": int(mu.shape[0]),
        "mu_mean": float(mu.mean()), "mu_mcse": float(np.asarray(mcse_mean(mu))),
        "tau_mean": float(tau.mean()), "tau_mcse": float(np.asarray(mcse_mean(tau))),
        "max_rhat": float(np.max(np.asarray(rhat(raw)))),
        "divergences": int(np.asarray(stats.diverging).sum()),
        "step_size": float(step),
        "leapfrogs_per_transition": float(np.mean(np.asarray(stats.n_steps))),
        "seconds": seconds,
    }


def run_jax(seed, kept):
    import jax

    from tpu_bijectors import diagnostics
    from tpu_bijectors.infer.sampler import sample_with_kernel

    model = jax_model()
    t0 = time.perf_counter()
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    q0 = model.init_positions(k_init, CHAINS, chip_smoke.ES_INIT_SCALE)
    raw, state, stats = sample_with_kernel(
        model.batched_logdensity_t_fn(), k_run, q0, n_warmup=WARMUP, n_samples=kept,
        kernel="nuts_batched_t", max_depth=MAX_DEPTH, target_accept=chip_smoke.ES_TARGET,
    )
    raw = np.asarray(raw)
    x = model.constrain(raw)
    return _summary(seed, time.perf_counter() - t0, state.eps, stats, np.asarray(x["mu"]),
                    np.asarray(x["tau"]), raw, diagnostics.rhat, diagnostics.mcse_mean)


def run_port(seed, kept, device, dtype):
    import torch

    from tpu_bijectors_torch import diagnostics
    from tpu_bijectors_torch.infer import sample_with_kernel

    model = port_model(device, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    q0 = model.init_positions(gen, CHAINS, chip_smoke.ES_INIT_SCALE)
    raw, state, stats = sample_with_kernel(
        model.batched_logdensity_t_fn(), gen, q0, n_warmup=WARMUP, n_samples=kept,
        kernel=model._auto_kernel(), max_depth=MAX_DEPTH, target_accept=chip_smoke.ES_TARGET,
    )
    x = model.constrain(raw)
    stats = type(stats)(*(t.cpu() for t in stats))
    return _summary(seed, time.perf_counter() - t0, state.eps.cpu(), stats,
                    x["mu"].cpu().double().numpy(), x["tau"].cpu().double().numpy(),
                    raw.cpu().double(), diagnostics.rhat, diagnostics.mcse_mean)


# ---------------------------------------------------------------------------
# under pytest
# ---------------------------------------------------------------------------


def test_eight_schools_model_matches_jax(rng):
    """Value and gradient of the model, float64, both layouts, against the
    JAX package's at 0.7 N(0, 1) states and at states with log tau from -4
    to 4 (the funnel the non-centered form straightens)."""
    import jax
    import jax.numpy as jnp
    import torch

    jm = jax_model()
    tm = port_model("cpu", "float64")
    assert tm.dim() == 10 and tm._auto_kernel() == "nuts_batched_t"
    v = 0.7 * rng.standard_normal((9, 10))
    v[:, 1] = np.linspace(-4.0, 4.0, 9)
    jvg = jax.jit(jm.batched_logdensity_t_fn().value_and_grad_fn)(jnp.asarray(v.T))
    lp, g = tm.batched_logdensity_t_fn().value_and_grad_fn(torch.as_tensor(v.T.copy()))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jvg[0]), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(jvg[1]), rtol=1e-10, atol=1e-12)
    lp_b, g_b = tm.batched_logdensity_fn().value_and_grad_fn(torch.as_tensor(v))
    np.testing.assert_allclose(lp_b.numpy(), np.asarray(jvg[0]), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g_b.numpy(), np.asarray(jvg[1]).T, rtol=1e-10, atol=1e-12)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", choices=("jax", "port"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--kept", type=int, default=chip_smoke.KEPT)
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32",
                    help="the port's dtype (JAX runs float64)")
    ap.add_argument("--device", default="cuda", help="the port's device")
    args = ap.parse_args(argv)
    if args.engine == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    for seed in args.seeds:
        if args.engine == "jax":
            out = run_jax(seed, args.kept)
        else:
            out = run_port(seed, args.kept, args.device, args.dtype)
        out.update(engine=args.engine)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
