"""The traced_sampling witness: `chip_smoke.py`'s cell 17 (the
generic-traced prior: two truncated priors, Kumaraswamy, BetaPrime,
InverseGaussian, JohnsonSU, TriangularDist, a two-component Normal
mixture and four joint order statistics), sampled by the JAX package and
by the port under the cell's settings (64 chains, max_depth 8, 300
warmup transitions, target 0.8, starts 0.3 N(0, 1)) for a given number
of kept draws.

At 200 kept draws, the other cells' count, the max rank-normalized R-hat
passed 1.05 on the card, on the mixture's coordinate (its modes at -2
and 3 are crossed rarely); whether that belongs to the model at that run
length (the JAX package's sampler gives it too) or to the port is what
this script measures:

    python tests/test_torch_traced_witness.py --engine jax --kept 200 1000
    python tests/test_torch_traced_witness.py --engine port --device cuda --kept 200 1000

Each seed samples the largest `--kept` once; each run length prints one
JSON line over the first that many draws: the adapted step size, mean
acceptance, leapfrogs per transition, divergences, the max R-hat and the
leaf it lies in, the mixture's R-hat, the min bulk ESS, and the run's
wall seconds. The random streams differ (JAX keys, torch generators), so
the engines are compared in distribution, not draw by draw.

Under pytest, the two engines' log-densities and gradients are held to
each other in float64 (so the witness compares one model).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the cell's model and settings)

CHAINS, WARMUP, MAX_DEPTH = chip_smoke.CHAINS, chip_smoke.WARMUP, chip_smoke.MAX_DEPTH
TARGET, INIT_SCALE = chip_smoke.TRACED_TARGET, chip_smoke.TRACED_INIT_SCALE
# the generic-traced model's linked rows, leaf by leaf
ROWS = {n: (i, i + 1) for i, n in enumerate(("tn", "tst", "ku", "bp", "ig", "js", "tri", "mx"))}
ROWS["jo"] = (8, 12)


def _leaf(i):
    return next(n for n, (a, b) in ROWS.items() if a <= i < b)


def jax_model():
    """tools/tpu_sweep.py's generic-traced model in the JAX package, as
    written there."""
    import jax.numpy as jnp

    from tpu_bijectors import dists as jd
    from tpu_bijectors.infer import Model

    e = jnp.asarray
    return Model(priors=jd.NamedProduct.of(
        tn=jd.Truncated(jd.Normal(0.3, 1.2), lower=-0.5, upper=2.0),
        tst=jd.Truncated(jd.StudentT(4.0, 0.2, 1.1), lower=0.0),
        ku=jd.Kumaraswamy(2.0, 3.0),
        bp=jd.BetaPrime(2.0, 3.5),
        ig=jd.InverseGaussian(1.2, 2.0),
        js=jd.JohnsonSU(0.1, 1.2, 0.3, 1.1),
        tri=jd.TriangularDist(-1.0, 2.0, 0.5),
        mx=jd.Mixture(jd.Normal(e([-2.0, 3.0]), e([1.0, 2.0])), jnp.log(e([0.5, 0.5]))),
        jo=jd.JointOrderStatistics(jd.Normal(0.2, 1.3), 4),
    ))


def port_model(device, dtype):
    import torch

    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists

    return tbt.Model(chip_smoke.traced_model(dists, device, getattr(torch, dtype)),
                     device=device)


def _summaries(seed, kepts, seconds, step, stats, raw, rhat, ess_bulk):
    """One line for each run length in `kepts` over the first draws of raw
    (kept, chains, dim) and stats, both numpy."""
    out = []
    for k in kepts:
        r = np.asarray(rhat(raw[:k]))
        out.append({
            "seed": seed,
            "kept": k,
            "step_size": float(step),
            "mean_accept": float(np.mean(stats.accept_prob[:k])),
            "leapfrogs_per_transition": float(np.mean(stats.n_steps[:k])),
            "divergences": int(stats.diverging[:k].sum()),
            "max_rhat": float(r.max()),
            "max_rhat_leaf": _leaf(int(r.argmax())),
            "mx_rhat": float(r[ROWS["mx"][0]]),
            "min_ess_bulk": float(np.min(np.asarray(ess_bulk(raw[:k])))),
            "seconds": seconds,
        })
    return out


def run_jax(seed, kepts, dtype):
    import jax

    from tpu_bijectors import diagnostics
    from tpu_bijectors.infer.sampler import sample_with_kernel

    model = jax_model()
    t0 = time.perf_counter()
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    q0 = model.init_positions(k_init, CHAINS, INIT_SCALE)
    raw, state, stats = sample_with_kernel(
        model.batched_logdensity_t_fn(), k_run, q0, n_warmup=WARMUP, n_samples=max(kepts),
        kernel="nuts_batched_t", max_depth=MAX_DEPTH, target_accept=TARGET,
    )
    raw = np.asarray(raw)
    stats = type(stats)(*(np.asarray(t) for t in stats))
    return _summaries(seed, kepts, time.perf_counter() - t0, state.eps, stats, raw,
                      diagnostics.rhat, diagnostics.ess_bulk)


def run_port(seed, kepts, device, dtype):
    import torch

    from tpu_bijectors_torch import diagnostics
    from tpu_bijectors_torch.infer import warmup_and_sample

    if device == "cpu":
        torch.set_num_threads(1)  # thousands of tiny ops: threads only add overhead
    model = port_model(device, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    raw, state, stats = warmup_and_sample(
        model.batched_logdensity_t_fn(), gen, model.init_positions(gen, CHAINS, INIT_SCALE),
        n_warmup=WARMUP, n_samples=max(kepts), kernel=model._auto_kernel(),
        max_depth=MAX_DEPTH, target_accept=TARGET,
    )
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stats = type(stats)(*(t.cpu().numpy() for t in stats))
    return _summaries(seed, kepts, seconds, float(state.eps), stats, raw.cpu().double(),
                      diagnostics.rhat, diagnostics.ess_bulk)


# ---------------------------------------------------------------------------
# under pytest
# ---------------------------------------------------------------------------


def test_traced_sampling_model_matches_jax(rng):
    """The two engines sample one density: value and gradient of the cell's
    model, float64, at 0.3 N(0, 1) states (the cell's starts)."""
    import jax
    import jax.numpy as jnp
    import torch

    jm = jax_model()
    tm = port_model("cpu", "float64")
    vT = 0.3 * rng.standard_normal((tm.dim(), 5))
    jlp, jg = jax.jit(jm.batched_logdensity_t_fn().value_and_grad_fn)(jnp.asarray(vT))
    lp, g = tm.batched_logdensity_t_fn().value_and_grad_fn(torch.as_tensor(vT))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-9, atol=1e-9)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", choices=("jax", "port"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--kept", type=int, nargs="+", default=[200, 1000])
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--device", default="cuda", help="the port's device")
    args = ap.parse_args(argv)
    if args.engine == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", args.dtype == "float64")
    kepts = sorted(args.kept)
    for seed in args.seeds:
        if args.engine == "jax":
            lines = run_jax(seed, kepts, args.dtype)
        else:
            lines = run_port(seed, kepts, args.device, args.dtype)
        for out in lines:
            out.update(engine=args.engine, dtype=args.dtype,
                       device="cpu" if args.engine == "jax" else args.device)
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
