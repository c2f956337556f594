"""The funnel witness: the bench model with `chip_smoke.py`'s likelihood,
sampled by the JAX package and by the port under the same settings.

At the default target acceptance 0.8 the port left some of 64 chains
stranded in the likelihood's funnel (small sigma), diverging at every
transition; `chip_smoke.py` samples at 0.95. Whether 0.8 strands chains
in the JAX package's sampler as well (the same init, adaptation and tree)
is what this script measures:

    python tests/test_torch_funnel.py --engine jax --dtype float32 --seeds 0 1 2
    python tests/test_torch_funnel.py --engine port --device cuda --seeds 0 1 2

`--init-scale 0.3` starts the chains as bench.py does. Each seed prints
one JSON line: divergences, stranded chains (more than half of their kept
transitions diverged), the smallest sigma such a chain visits, the step
size, max rank-normalized R-hat and wall seconds. The random streams
differ (JAX keys, torch generators), so the engines are compared by how
often chains strand, not draw by draw.

Under pytest, the two engines' log-densities and gradients are held to
each other at the bench width in float64 (so the witness compares one
model), and the stranded-chain count is checked on a small case.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the port's bench model and likelihood)

CHAINS, WARMUP, KEPT, MAX_DEPTH = 64, 300, 200, 8


def stranded_chains(diverging):
    """Chains that diverged in more than half of their kept transitions,
    from (n_kept, chains) divergence flags."""
    d = np.asarray(diverging, dtype=np.float64)
    return np.flatnonzero(d.mean(axis=0) > 0.5)


def jax_model():
    """The JAX package's bench model (bench.py) with chip_smoke.py's
    likelihood, on the same data (numpy seed 1, rounded to float32; they
    promote to float64 in a float64 run, as the port's do)."""
    import jax.numpy as jnp

    from tpu_bijectors import dists as jd
    from tpu_bijectors.infer import Model

    rng = np.random.default_rng(1)
    ybar = jnp.asarray(rng.standard_normal(8).astype(np.float32))
    counts = rng.multinomial(200, np.full(16, 1 / 16))
    A = rng.standard_normal((16, 16))
    S = jnp.asarray((0.05 * (A + A.T)).astype(np.float32))
    c = jnp.asarray(counts.astype(np.float32))

    def hier_loglik(x):
        return (
            -0.5 * jnp.sum((ybar - x["mu"]) ** 2 / (x["sigma"] ** 2 + 1e-3))
            + jnp.sum(c * jnp.log(x["w"] + 1e-8))
            + jnp.sum(S * x["corr"])
        )

    priors = jd.NamedProduct.of(
        mu=jd.IIDProduct(jd.Normal(0.0, 2.0), 8),
        sigma=jd.IIDProduct(jd.LogNormal(0.0, 0.5), 8),
        w=jd.Dirichlet(jnp.ones(16)),
        corr=jd.LKJ(16, 2.0),
    )
    return Model(priors=priors, loglik=hier_loglik), counts


def port_model(device, dtype):
    """The port's model as `chip_smoke.py` builds it (its float32 data
    promote to float64 in a float64 model, as the JAX model's do)."""
    import torch

    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists

    ll, counts = chip_smoke.hier_loglik_and_counts(device)
    priors = chip_smoke.bench_model(dists, device, getattr(torch, dtype))
    return tbt.Model(priors, loglik=ll, device=device), counts


def _summary(seed, target, seconds, step, diverging, sigma, raw, rhat):
    stuck = stranded_chains(diverging)
    sigma = np.asarray(sigma)
    return {
        "seed": seed,
        "target_accept": target,
        "divergences": int(np.asarray(diverging).sum()),
        "stranded_chains": int(stuck.size),
        "smallest_sigma_of_a_stranded_chain": (
            float(sigma[:, stuck].min()) if stuck.size else None
        ),
        "step_size": float(step),
        "max_rhat": float(np.max(rhat(raw))),
        "seconds": seconds,
    }


def run_jax(seed, target, init_scale):
    """Model.sample's steps, with the starts scaled by `init_scale` (at 1,
    the draws of Model.sample itself)."""
    import jax

    from tpu_bijectors import diagnostics
    from tpu_bijectors.infer.sampler import sample_with_kernel

    model, _ = jax_model()
    t0 = time.perf_counter()
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    raw, state, stats = sample_with_kernel(
        model.batched_logdensity_t_fn(), k_run,
        model.init_positions(k_init, CHAINS, init_scale), n_warmup=WARMUP,
        n_samples=KEPT, kernel="nuts_batched_t", max_depth=MAX_DEPTH,
        target_accept=target,
    )
    raw = np.asarray(raw)
    seconds = time.perf_counter() - t0
    sigma = np.asarray(model.constrain(raw)["sigma"])
    return _summary(seed, target, seconds, state.eps, stats.diverging, sigma, raw,
                    diagnostics.rhat)


def run_port(seed, target, device, dtype, init_scale):
    """Model.sample's steps, with the starts scaled by `init_scale` (at 1,
    the draws of Model.sample itself)."""
    import torch

    from tpu_bijectors_torch import diagnostics
    from tpu_bijectors_torch.infer import sample_with_kernel

    if device == "cpu":
        torch.set_num_threads(1)  # thousands of tiny ops: threads only add overhead
    model, _ = port_model(device, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    raw, state, stats = sample_with_kernel(
        model.batched_logdensity_t_fn(), gen, model.init_positions(gen, CHAINS, init_scale),
        n_warmup=WARMUP, n_samples=KEPT, kernel="nuts_batched_t", max_depth=MAX_DEPTH,
        target_accept=target,
    )
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    sigma = model.constrain(raw)["sigma"].cpu().numpy()
    return _summary(seed, target, seconds, state.eps.cpu(), stats.diverging.cpu(), sigma,
                    raw.cpu().double(), diagnostics.rhat)


# ---------------------------------------------------------------------------
# under pytest
# ---------------------------------------------------------------------------


def test_bench_likelihood_model_matches_jax(rng):
    """The two engines sample one density: value and gradient of the bench
    model with the likelihood at dim 151, float64 (the data rounded to
    float32 in both, as on the card)."""
    import jax
    import jax.numpy as jnp
    import torch

    jm, _ = jax_model()
    tm, _ = port_model("cpu", "float64")
    vT = 0.7 * rng.standard_normal((tm.dim(), 3))
    jlp, jg = jax.jit(jm.batched_logdensity_t_fn().value_and_grad_fn)(jnp.asarray(vT))
    lp, g = tm.batched_logdensity_t_fn().value_and_grad_fn(torch.as_tensor(vT))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10, atol=1e-10)


def test_stranded_chains_counts_majority_divergent():
    d = np.zeros((10, 4), dtype=bool)
    d[:, 1] = True  # every transition
    d[:6, 2] = True  # 6 of 10
    d[:5, 3] = True  # half: not stranded
    np.testing.assert_array_equal(stranded_chains(d), [1, 2])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", choices=("jax", "port"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--target", type=float, nargs="+", default=[0.8])
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--device", default="cuda", help="the port's device")
    ap.add_argument("--init-scale", type=float, default=1.0,
                    help="starts are init_scale * N(0, 1) (Model.sample: 1; bench.py: 0.3)")
    args = ap.parse_args(argv)
    if args.engine == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", args.dtype == "float64")
    for target in args.target:
        for seed in args.seeds:
            if args.engine == "jax":
                out = run_jax(seed, target, args.init_scale)
            else:
                out = run_port(seed, target, args.device, args.dtype, args.init_scale)
            out.update(engine=args.engine, dtype=args.dtype, init_scale=args.init_scale)
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
