"""The port's chain- and parameter-parallel runners on `torch.distributed`
(gloo, CPU, float64) against the JAX package and the port's unsharded
engines: the cases of tests/test_shard.py.

One process group of four ranks is spawned for the whole file (a
`file://` store under the module's temporary directory, one thread a
rank); the module fixture runs every case in the ranks and hands their
results back as numpy arrays. The two-rank cases run on the pairs of a
("pair", "chain") mesh, half of them on each pair; the world-size-1 cases
on the one-rank groups of a ("rep", "chain") mesh of shape (4, 1); the
2-D case on a ("chain", "param") mesh of shape (2, 2); fewer children than
ranks on a 1-D "param" mesh of all four.

- Deterministic: world size 1 against the unsharded NUTS, ChEES, ADVI,
  Pathfinder and tempering runs bit for bit; the checkpoint resume bit for
  bit; the step size and inverse mass bit for bit equal on the two ranks
  of a pair; ADVI sharded against unsharded (1e-8, the sums' order);
  `param_parallel_*` against the JAX package's unsharded density and
  `from_linked_vec` at 1e-10.
- Statistical, at the JAX tests' tolerances: NUTS on a Gaussian and a
  Dirichlet, with the batched and transposed kernels; ADVI's families and
  estimators; SMC; parallel tempering on a bimodal target; Pathfinder.

The JAX package's own sharded engines are not run here (its test file
runs them on the 8-device mesh). The ranks import this module, not JAX:
the JAX side is imported in the tests alone.
"""

import math
import multiprocessing
import os
import queue
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

WORLD = 4
F64 = torch.float64
KW = dict(device="cpu", dtype=F64)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _np(t):
    return t.detach().cpu().numpy()


def _batch(f):
    f.batch_capable = True
    return f


# ---------------------------------------------------------------------------
# the cases, run in the ranks
# ---------------------------------------------------------------------------

MU4 = [1.0, -1.0, 0.5, 2.0]


def _dirichlet_model(alpha, lognormal=False):
    from tpu_bijectors_torch import dists
    from tpu_bijectors_torch.infer import Model

    parts = dict(w=dists.Dirichlet(torch.tensor(alpha, **KW), **KW))
    if lognormal:
        parts["s"] = dists.LogNormal(0.0, 0.5, **KW) if len(alpha) == 3 else dists.LogNormal(**KW)
    return Model(dists.NamedProduct.of(**parts), device="cpu")


def case_nuts_gaussian(mesh):
    from tpu_bijectors_torch.shard import chain_parallel_nuts, shard_chains

    mu = torch.tensor(MU4, **KW)
    q0 = shard_chains(mesh, torch.randn((16, 4), generator=_gen(2), **KW))
    samples, state, _ = chain_parallel_nuts(lambda v: -0.5 * torch.sum((v - mu) ** 2), mesh,
                                            _gen(23), q0, n_warmup=300, n_samples=400,
                                            kernel="nuts")
    return dict(samples=_np(samples), eps=_np(state.eps), inv_mass=_np(state.inv_mass))


def case_nuts_dirichlet(mesh):
    from tpu_bijectors_torch.infer import warmup_and_sample
    from tpu_bijectors_torch.shard import chain_parallel_nuts, shard_chains

    model = _dirichlet_model([2.0, 3.0, 4.0])
    logp = model.logdensity_fn()
    q0 = model.init_positions(_gen(3), 16, scale=0.5)
    # 200 + 200 transitions (the JAX test's 300 + 400): the 0.03 bound is
    # still about 9 MCSE of these means
    if mesh is None:  # the unsharded run, on one rank
        sh, _, _ = warmup_and_sample(logp, _gen(4), q0, n_warmup=200, n_samples=200,
                                     kernel="nuts")
    else:
        sh, _, _ = chain_parallel_nuts(logp, mesh, _gen(23), shard_chains(mesh, q0),
                                       n_warmup=200, n_samples=200, kernel="nuts")
    return dict(w=_np(model.constrain(sh.reshape(-1, 2))["w"]))


def case_resume(mesh, tmp):
    from tpu_bijectors_torch.shard import (
        chain_parallel_nuts,
        chain_parallel_resume,
        load_sampler_state,
        save_sampler_state,
        shard_chains,
    )

    def logp(v):
        return -0.5 * torch.sum(v * v)

    q0 = shard_chains(mesh, torch.randn((16, 3), generator=_gen(5), **KW))
    kw = dict(n_warmup=25, max_depth=4, kernel="nuts")
    full, _, _ = chain_parallel_nuts(logp, mesh, _gen(23), q0, n_samples=8, **kw)
    _, state_a, _ = chain_parallel_nuts(logp, mesh, _gen(23), q0, n_samples=4, **kw)
    path = os.path.join(tmp, f"rank{dist.get_rank()}.npz")
    save_sampler_state(path, state_a)
    tail, state_b, _ = chain_parallel_resume(logp, mesh, load_sampler_state(path, state_a), 4,
                                             max_depth=4, kernel="nuts")
    return dict(full=_np(full), tail=_np(tail), iteration=state_b.iteration)


def _kernel_case(mesh, kernel, seed):
    from tpu_bijectors_torch.shard import chain_parallel_nuts, shard_chains

    model = _dirichlet_model([1.0] * 4, lognormal=True)
    q0 = shard_chains(mesh, model.init_positions(_gen(seed), 4 * 2, 0.5))
    fn = model.batched_logdensity_t_fn() if kernel == "nuts_batched_t" else \
        model.batched_logdensity_fn()
    samples, state, _ = chain_parallel_nuts(fn, mesh, _gen(seed + 1), q0, n_warmup=150,
                                            n_samples=200, kernel=kernel)
    x = model.constrain(samples.reshape(-1, model.dim()))
    return dict(w=_np(x["w"]), s=_np(x["s"]), eps=_np(state.eps), inv_mass=_np(state.inv_mass))


def case_nuts_batched(mesh):
    return _kernel_case(mesh, "nuts_batched", 40)


def case_nuts_batched_t(mesh):
    return _kernel_case(mesh, "nuts_batched_t", 50)


def case_advi_matches_unsharded(mesh):
    from tpu_bijectors_torch.infer import fit_advi
    from tpu_bijectors_torch.shard import chain_parallel_advi

    model = _dirichlet_model([2.0, 3.0, 4.0], lognormal=True)
    logp = model.batched_logdensity_fn()
    kw = dict(n_steps=200, n_mc=16, learning_rate=2e-2, dtype=F64, device="cpu")
    sh = chain_parallel_advi(logp, mesh, _gen(23), model.dim(), **kw)
    lo = fit_advi(logp, _gen(23), model.dim(), **kw)
    return dict(sh=[_np(sh.losses), _np(sh.q.loc), _np(sh.q.log_scale)],
                lo=[_np(lo.losses), _np(lo.q.loc), _np(lo.q.log_scale)])


def case_advi_estimators(mesh):
    from tpu_bijectors_torch.infer import FullRankGaussian, fit_advi
    from tpu_bijectors_torch.shard import chain_parallel_advi

    mu = torch.tensor([1.0, -0.5], **KW)
    logp = _batch(lambda v: -0.5 * torch.sum((v - mu) ** 2, -1))
    kw = dict(n_steps=600, n_mc=16, learning_rate=2e-2, dtype=F64, device="cpu",
              q=FullRankGaussian.init(2, F64, "cpu"), estimator="stl")
    stl = chain_parallel_advi(logp, mesh, _gen(23), 2, **kw)
    stl_lo = fit_advi(logp, _gen(23), 2, **kw)
    kw = dict(n_steps=800, n_mc=16, n_iw=4, learning_rate=2e-2, dtype=F64, device="cpu",
              estimator="iwelbo")
    iw = chain_parallel_advi(logp, mesh, _gen(23), 2, **kw)
    iw_lo = fit_advi(logp, _gen(23), 2, **kw)
    try:
        chain_parallel_advi(logp, mesh, _gen(23), 2, n_mc=3, dtype=F64, device="cpu")
        error = ""
    except ValueError as e:
        error = str(e)
    return dict(stl=_np(stl.q.loc), stl_lo=_np(stl_lo.q.loc), iw=_np(iw.losses),
                iw_lo=_np(iw_lo.losses), iw_loc=_np(iw.q.loc), error=error)


def _conjugate(mesh, batched):
    from tpu_bijectors_torch import dists
    from tpu_bijectors_torch.infer import Model
    from tpu_bijectors_torch.shard import chain_parallel_smc, shard_chains

    x_obs, s_lik = 1.0, 0.5
    if batched:
        log_prior = Model(dists.NamedProduct.of(v=dists.Normal(**KW)),
                          device="cpu").batched_logdensity_fn()
        log_lik = _batch(lambda v: -0.5 * ((x_obs - v[..., 0]) / s_lik) ** 2)
    else:
        log_prior = lambda v: -0.5 * torch.sum(v * v)  # noqa: E731
        log_lik = lambda v: -0.5 * ((x_obs - v[0]) / s_lik) ** 2  # noqa: E731
    p0 = shard_chains(mesh, torch.randn((2048, 1), generator=_gen(6 if batched else 23), **KW))
    parts, log_ev, beta, stages = chain_parallel_smc(log_prior, log_lik, mesh,
                                                     _gen(7 if batched else 5), p0,
                                                     rw_scale=0.5, n_mutations=8)
    return dict(parts=_np(parts[:, 0]), beta=float(beta), log_ev=float(log_ev), stages=stages)


def case_smc(mesh):
    return _conjugate(mesh, False)


def case_smc_batched(mesh):
    return _conjugate(mesh, True)


@_batch
def _bimodal_prior(v):
    return -0.5 * torch.sum((v / 3.0) ** 2, -1)


@_batch
def _bimodal_lik(v):
    modes = torch.stack([-0.5 * torch.sum(((v - 4.0) / 0.5) ** 2, -1),
                         -0.5 * torch.sum(((v + 4.0) / 0.5) ** 2, -1)])
    return torch.logsumexp(modes, 0) - math.log(2.0)


def case_pt_bimodal(mesh):
    from tpu_bijectors_torch.shard import chain_parallel_pt, shard_chains

    q0 = shard_chains(mesh, torch.full((32, 1), 4.0, **KW))
    res = chain_parallel_pt(_bimodal_prior, _bimodal_lik, mesh, _gen(23), q0, n_temps=6,
                            n_warmup=100, n_samples=200, n_leapfrog=8)
    return dict(samples=_np(res.samples), swap=_np(res.swap_accept), eps=_np(res.eps),
                log_ev=float(res.log_evidence))


def case_pathfinder(mesh):
    from tpu_bijectors_torch.shard import chain_parallel_pathfinder, shard_chains

    mu = torch.tensor([1.0, -0.5, 0.25], **KW)
    v0s = 2.0 * torch.randn((16, 3), generator=_gen(11), **KW)
    draws, res = chain_parallel_pathfinder(lambda v: -0.5 * torch.sum((v - mu) ** 2), mesh,
                                           _gen(23), shard_chains(mesh, v0s), n_draws=256,
                                           per_path_draws=64, max_iters=20)
    try:
        shard_chains(mesh, v0s[:3])
        error = ""
    except ValueError as e:
        error = str(e)
    return dict(draws=_np(draws), paths=res.draws.shape[0], error=error)


def case_world_size_one(mesh):
    """Every engine on a one-rank group against its unsharded run, the same
    generator seed: the draws bit for bit."""
    from tpu_bijectors_torch.infer import (
        fit_advi,
        multipath_pathfinder,
        run_chees,
        run_parallel_tempering,
        warmup_and_sample,
    )
    from tpu_bijectors_torch.shard import (
        chain_parallel_advi,
        chain_parallel_chees,
        chain_parallel_nuts,
        chain_parallel_pathfinder,
        chain_parallel_pt,
    )

    mu = torch.tensor([1.0, -0.5, 0.25], **KW)
    logp = _batch(lambda v: -0.5 * torch.sum((v - mu) ** 2, -1))
    q0 = torch.randn((4, 3), generator=_gen(8), **KW)
    pairs = {}
    kw = dict(n_warmup=30, n_samples=10, max_depth=4, kernel="nuts_batched")
    pairs["nuts"] = (chain_parallel_nuts(logp, mesh, _gen(1), q0, **kw)[0],
                     warmup_and_sample(logp, _gen(1), q0, **kw)[0])
    kw = dict(n_warmup=30, n_samples=10)
    pairs["chees"] = (chain_parallel_chees(logp, mesh, _gen(2), q0, **kw)[0],
                      run_chees(logp, _gen(2), q0, **kw)[0])
    kw = dict(n_steps=20, n_mc=8, dtype=F64, device="cpu")
    pairs["advi"] = (chain_parallel_advi(logp, mesh, _gen(3), 3, **kw).losses,
                     fit_advi(logp, _gen(3), 3, **kw).losses)
    kw = dict(n_draws=32, per_path_draws=16, max_iters=10)
    pairs["pathfinder"] = (chain_parallel_pathfinder(logp, mesh, _gen(4), q0, **kw)[0],
                           multipath_pathfinder(logp, _gen(4), q0, **kw)[0])
    kw = dict(n_temps=3, n_warmup=10, n_samples=10, n_leapfrog=4)
    pairs["pt"] = (chain_parallel_pt(_bimodal_prior, _bimodal_lik, mesh, _gen(5), q0[:, :1],
                                     **kw).samples,
                   run_parallel_tempering(_bimodal_prior, _bimodal_lik, _gen(5), q0[:, :1],
                                          **kw).samples)
    return {k: (_np(a), _np(b)) for k, (a, b) in pairs.items()}


# the parameter-parallel models and their inputs (numpy, from one seed)


def _param_models(dists, kw):
    return {
        "iid_beta": dists.IIDProduct(dists.Beta(2.0, 3.0, **kw), 512),
        "iid_dirichlet": dists.IIDProduct(dists.Dirichlet(np.ones(5), **kw), 64),
        "tree": dists.NamedProduct.of(
            mu=dists.Normal(0.0, 2.0, **kw), scales=dists.IIDProduct(dists.LogNormal(0.0, 0.5, **kw), 7),
            w=dists.Dirichlet(np.ones(5), **kw), corr=dists.LKJ(4, 2.0, **kw),
            b=dists.Beta(2.0, 3.0, **kw)),
        "tree_2d": dists.NamedProduct.of(
            w=dists.Dirichlet(np.ones(5), **kw), s=dists.IIDProduct(dists.LogNormal(**kw), 3),
            c=dists.LKJ(3, 2.0, **kw)),
        "two_children": dists.NamedProduct.of(w=dists.Dirichlet(np.ones(4), **kw),
                                              s=dists.LogNormal(**kw)),
    }


ROWS = {"iid_beta": 4, "iid_dirichlet": 3, "tree": 3, "tree_2d": 8, "two_children": 2}


def _state(name, dim):
    return np.random.default_rng(23 + len(name)).standard_normal((ROWS[name], dim))


def _param_case(mesh, name, axis="param", batch_axis=None):
    from tpu_bijectors_torch import dists
    from tpu_bijectors_torch.shard import (
        param_parallel_from_linked,
        param_parallel_logdensity,
        shard_params,
    )
    from tpu_bijectors_torch.vectorize import unconstrain

    d = _param_models(dists, KW)[name]
    u = unconstrain(d, device="cpu")
    v = torch.as_tensor(_state(name, u.linked_vec_length))
    out = {}
    if name.startswith("iid"):
        v_loc = shard_params(mesh, v, axis)
        if name == "iid_beta":
            x, ld = param_parallel_from_linked(u, mesh, axis)(v_loc)
            out.update(x=_np(x), ld=_np(ld))
        fn = param_parallel_logdensity(d, mesh, axis)
        out["lp"] = _np(fn(v_loc))
        vg = v_loc.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(vg).sum(), vg)
        out["g"] = _np(g)
        return out
    fn = param_parallel_logdensity(u, mesh, axis, batch_axis_name=batch_axis)
    layout = fn.layout
    vp = layout.pack(v)
    if batch_axis is not None:  # this rank's rows of the chain axis
        n = vp.shape[0] // mesh.size(mesh.mesh_dim_names.index(batch_axis))
        vp = vp[mesh.get_local_rank(batch_axis) * n:][:n]
    v_loc = shard_params(mesh, vp, axis)
    vg = v_loc.clone().requires_grad_(True)
    lp = fn(vg)
    (g,) = torch.autograd.grad(lp.sum(), vg)
    out.update(lp=_np(lp), g=_np(g), assign=layout.assign, seg_len=layout.seg_len,
               packed_dim=layout.packed_dim, lp1=_np(fn(v_loc[0])), rank=mesh.get_local_rank(axis))
    return out


PAIR_CASES = (
    # the first pair of the ("pair", "chain") mesh
    ("nuts_gaussian", "nuts_dirichlet", "resume", "nuts_batched_t", "smc", "smc_batched",
     "pathfinder"),
    # the second
    ("advi_matches_unsharded", "advi_estimators", "pt_bimodal", "nuts_batched"),
)


def _cases(tmp):
    from tpu_bijectors_torch.shard import make_mesh

    pairs = make_mesh(("pair", "chain"), shape=(2, 2))
    ones = make_mesh(("rep", "chain"), shape=(4, 1))
    grid = make_mesh(("chain", "param"), shape=(2, 2))
    line = make_mesh("param")
    pair = pairs.get_local_rank("pair")
    out = {}
    for name in PAIR_CASES[pair]:
        fn = globals()[f"case_{name}"]
        out[name] = fn(pairs, tmp) if name == "resume" else fn(pairs)
    if dist.get_rank() == 0:
        out["world_size_one"] = case_world_size_one(ones)
    if dist.get_rank() == 1:
        out["nuts_dirichlet_unsharded"] = case_nuts_dirichlet(None)
    for name in ("iid_beta", "iid_dirichlet") if pair == 0 else ("tree",):
        out[name] = _param_case(grid, name)  # the pairs of the grid's "param" dim
    out["tree_2d"] = _param_case(grid, "tree_2d", batch_axis="chain")
    out["two_children"] = _param_case(line, "two_children")
    return out


def _rank_main(rank, store, tmp, results):
    os.nice(10)  # the ranks yield the cores to the other test workers
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD)
    try:
        results.put((rank, _cases(tmp)))
    except BaseException:  # noqa: BLE001 - hand the traceback to the test process
        results.put((rank, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{rank: {case: results}} from one spawned group of WORLD gloo ranks."""
    tmp = tmp_path_factory.mktemp("shard")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, str(tmp / "store"), str(tmp), results))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    out = {}
    try:
        while len(out) < WORLD:
            rank, res = results.get(timeout=300)
            out[rank] = res
    except queue.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    failed = {r: res for r, res in out.items() if isinstance(res, str)}
    assert len(out) == WORLD and not failed, f"ranks {sorted(out)} answered; {failed}"
    return out


def _pair(ranks, name):
    """The two ranks' results of a pair case."""
    pair = 0 if name in PAIR_CASES[0] else 1
    return ranks[2 * pair][name], ranks[2 * pair + 1][name]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def test_world_size_one_is_the_unsharded_run(ranks):
    """NUTS, ChEES, ADVI, Pathfinder and tempering on a one-rank group."""
    runs = ranks[0]["world_size_one"]
    assert sorted(runs) == ["advi", "chees", "nuts", "pathfinder", "pt"]
    for sharded, unsharded in runs.values():
        np.testing.assert_array_equal(sharded, unsharded)


def _adaptation_is_shared(a, b):
    """The step size and inverse mass of the pair's ranks, bit for bit."""
    assert np.ndim(a["eps"]) == 0
    np.testing.assert_array_equal(a["eps"], b["eps"])
    np.testing.assert_array_equal(a["inv_mass"], b["inv_mass"])


def test_chain_parallel_nuts_gaussian(ranks):
    a, b = _pair(ranks, "nuts_gaussian")
    _adaptation_is_shared(a, b)
    s = np.concatenate([a["samples"], b["samples"]], axis=1)
    s = s.reshape(-1, 4)
    np.testing.assert_allclose(s.mean(0), MU4, atol=0.1)
    np.testing.assert_allclose(s.var(0), 1.0, atol=0.2)


def test_chain_parallel_matches_single_device_statistically(ranks):
    a, b = _pair(ranks, "nuts_dirichlet")
    w_sh = np.concatenate([a["w"], b["w"]])
    w_lo = ranks[1]["nuts_dirichlet_unsharded"]["w"]
    np.testing.assert_allclose(w_sh.mean(0), w_lo.mean(0), atol=0.03)
    np.testing.assert_allclose(w_sh.mean(0), [2 / 9, 3 / 9, 4 / 9], atol=0.03)


def test_chain_parallel_checkpoint_resume_bitwise(ranks):
    for r in _pair(ranks, "resume"):
        np.testing.assert_array_equal(r["full"][4:], r["tail"])
        assert r["iteration"] == 25 + 8


def test_chain_parallel_with_batched_kernels(ranks):
    """kernel='nuts_batched' and 'nuts_batched_t' (the transposed tree)."""
    for name in ("nuts_batched", "nuts_batched_t"):
        a, b = _pair(ranks, name)
        _adaptation_is_shared(a, b)
        w = np.concatenate([a["w"], b["w"]])
        np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-6)
        np.testing.assert_allclose(w.mean(0), 0.25, atol=0.05)
        if name == "nuts_batched_t":
            s = np.concatenate([a["s"], b["s"]])
            np.testing.assert_allclose(np.log(s).mean(), 0.0, atol=0.15)


def test_chain_parallel_advi_matches_unsharded(ranks):
    a, b = _pair(ranks, "advi_matches_unsharded")
    for r in (a, b):
        for sh, lo in zip(r["sh"], r["lo"]):
            np.testing.assert_allclose(sh, lo, rtol=1e-8, atol=1e-8)
    for x, y in zip(a["sh"], b["sh"]):
        np.testing.assert_array_equal(x, y)


def test_chain_parallel_advi_estimators_and_families(ranks):
    r, _ = _pair(ranks, "advi_estimators")
    mu = np.array([1.0, -0.5])
    np.testing.assert_allclose(r["stl"], mu, atol=0.05)
    np.testing.assert_allclose(r["stl"], r["stl_lo"], atol=1e-6)
    np.testing.assert_allclose(r["iw"], r["iw_lo"], rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(r["iw_loc"], mu, atol=0.15)
    assert "divisible" in r["error"]


def test_chain_parallel_smc(ranks):
    """Per-sample densities, and batch-capable ones on whole blocks."""
    post_var = 1.0 / (1.0 + 1.0 / 0.5**2)
    post_mean = post_var * 1.0 / 0.5**2
    for name in ("smc", "smc_batched"):
        a, b = _pair(ranks, name)
        p = np.concatenate([a["parts"], b["parts"]])
        np.testing.assert_allclose(p.mean(), post_mean, atol=0.06)
        if name == "smc_batched":
            np.testing.assert_allclose(p.var(), post_var, atol=0.06)
        assert a["beta"] == b["beta"] == 1.0
        assert a["log_ev"] == b["log_ev"] and math.isfinite(a["log_ev"])


def test_chain_parallel_pt_bimodal(ranks):
    a, b = _pair(ranks, "pt_bimodal")
    draws = np.concatenate([a["samples"], b["samples"]], axis=1).reshape(-1)
    assert 0.25 < float((draws < 0).mean()) < 0.75
    assert a["samples"].shape[1] == 16
    assert a["swap"].shape == (5,)
    np.testing.assert_array_equal(a["swap"], b["swap"])
    np.testing.assert_array_equal(a["eps"], b["eps"])
    assert np.all(np.isfinite(a["eps"])) and math.isfinite(a["log_ev"])


def test_chain_parallel_pathfinder(ranks):
    a, b = _pair(ranks, "pathfinder")
    np.testing.assert_array_equal(a["draws"], b["draws"])
    np.testing.assert_allclose(a["draws"].mean(0), [1.0, -0.5, 0.25], atol=0.2)
    assert a["draws"].shape == (256, 3) and a["paths"] == 8
    assert "divisible" in a["error"]


def _jax_reference(name):
    """The JAX package's unsharded linked density (and, for the IID Beta
    block, from_linked_vec) on the case's state."""
    import jax
    import jax.numpy as jnp
    from tpu_bijectors import dists as jd
    from tpu_bijectors.vectorize import unconstrain as j_unconstrain

    models = _param_models(_JaxDists(jd, jnp), {})
    u = j_unconstrain(models[name])
    v = jnp.asarray(_state(name, u.linked_vec_length))
    if name.startswith("iid"):
        x, ld = jax.jit(u.from_linked_vec)(v)
        return dict(lp=np.asarray(jax.jit(u.from_linked_vec_with_logpdf)(v)[1]),
                    x=np.asarray(x), ld=np.asarray(ld))
    return dict(lp=np.asarray(jax.jit(u.linked_logdensity)(v)))


class _JaxDists:
    """The JAX package's families with numpy parameters as jnp arrays, for
    `_param_models`."""

    def __init__(self, jd, jnp):
        self.jd, self.jnp = jd, jnp

    def __getattr__(self, name):
        fam = getattr(self.jd, name)
        if name in ("IIDProduct", "NamedProduct"):
            return fam
        return lambda *a, **k: fam(*(self.jnp.asarray(x) if isinstance(x, np.ndarray) else x
                                     for x in a), **k)


@pytest.mark.parametrize("name", ["iid_beta", "iid_dirichlet", "tree"])
def test_param_parallel_matches_the_jax_package(ranks, name):
    """Each rank's (B,) density is the whole model's, at 1e-10 of the JAX
    package's unsharded one; the IID Beta block's x and log-det too, x
    from the ranks' blocks in order. The gradient of the summed density on
    each rank's slice is the unsharded gradient's slice (the packed
    layout's for the tree, zero on its padding)."""
    from tpu_bijectors_torch import dists
    from tpu_bijectors_torch.vectorize import unconstrain

    pair = 0 if name.startswith("iid") else 1
    a, b = ranks[2 * pair][name], ranks[2 * pair + 1][name]
    ref = _jax_reference(name)
    for r in (a, b):
        np.testing.assert_allclose(r["lp"], ref["lp"], rtol=1e-10)
    if name == "iid_beta":
        np.testing.assert_allclose(np.concatenate([a["x"], b["x"]], axis=-1), ref["x"],
                                   atol=1e-12)
        for r in (a, b):
            np.testing.assert_allclose(r["ld"], ref["ld"], rtol=1e-12)
    u = unconstrain(_param_models(dists, KW)[name], device="cpu")
    v = torch.as_tensor(_state(name, u.linked_vec_length)).requires_grad_(True)
    (g,) = torch.autograd.grad(u.linked_logdensity(v).sum(), v)
    g = _np(g)
    if name == "tree":
        g = np.asarray(_layout_pack(a, u, g))
        for r, rank_g in enumerate((a["g"], b["g"])):
            used = sum(u.linked_offsets[c][1] for c in a["assign"][r])
            assert np.all(rank_g[:, used:] == 0.0)
    got = np.concatenate([a["g"], b["g"]], axis=-1)
    np.testing.assert_allclose(got, g, rtol=1e-10, atol=1e-12)


def _layout_pack(r, u, g):
    from tpu_bijectors_torch.shard import ParamLayout

    layout = ParamLayout(tuple(u.linked_offsets), r["assign"], r["seg_len"])
    return _np(layout.pack(torch.as_tensor(g)))


def test_param_parallel_heterogeneous_tree_layout(ranks):
    """Every child assigned exactly once, order kept; the packed dim; a
    single state (1-D) gives the batch's first row."""
    a, b = ranks[2]["tree"], ranks[3]["tree"]
    flat = [c for owned in a["assign"] for c in owned]
    assert flat == list(range(5))
    assert a["packed_dim"] == 2 * a["seg_len"]
    ref = _jax_reference("tree")["lp"]
    for r in (a, b):
        np.testing.assert_allclose(float(r["lp1"]), ref[0], rtol=1e-10)


def test_chain_param_2d_mesh_composition(ranks):
    """("chain", "param") of shape (2, 2): each chain rank's rows, the sum
    over the param ranks alone; the rows in chain order are the JAX
    package's unsharded density."""
    ref = _jax_reference("tree_2d")["lp"]
    by_chain = {}
    for r in range(WORLD):
        got = ranks[r]["tree_2d"]
        by_chain.setdefault(r // 2, []).append(got["lp"])
    for rows in by_chain.values():
        np.testing.assert_array_equal(rows[0], rows[1])
    assert ranks[0]["tree_2d"]["assign"] == ranks[1]["tree_2d"]["assign"]
    np.testing.assert_allclose(np.concatenate([by_chain[0][0], by_chain[1][0]]), ref,
                               rtol=1e-10)


def test_param_parallel_hetero_fewer_children_than_devices(ranks):
    """Four ranks, two children: the trailing ranks own nothing and add
    zero; the density still matches."""
    ref = _jax_reference("two_children")["lp"]
    assigns = ranks[0]["two_children"]["assign"]
    assert len(assigns) == WORLD and assigns[-1] == ()
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["two_children"]["lp"], ref, rtol=1e-10)


def test_checkpoint_roundtrip(tmp_path):
    """A sampler state round-trips through the checkpoint bit for bit (the
    JAX test's case; no ranks needed)."""
    from tpu_bijectors_torch.infer import init_sampler
    from tpu_bijectors_torch.shard import load_sampler_state, save_sampler_state

    q0 = torch.randn((4, 3), generator=_gen(23), **KW)
    state = init_sampler(lambda v: -0.5 * torch.sum(v * v), _gen(23), q0)
    path = str(tmp_path / "ckpt.npz")
    save_sampler_state(path, state)
    loaded = load_sampler_state(path, state)
    for a, b in zip(state[1:], loaded[1:]):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert torch.equal(state.generator.get_state(), loaded.generator.get_state())


def test_resume_reproduces():
    """2 x 50 draws from a returned state equal 100 straight (the JAX
    test's case, unsharded)."""
    from tpu_bijectors_torch.infer import resume_sampling, warmup_and_sample

    def logp(v):
        return -0.5 * torch.sum(v * v)

    q0 = torch.randn((2, 3), generator=_gen(7), **KW)
    full, _, _ = warmup_and_sample(logp, _gen(23), q0, n_warmup=50, n_samples=100, kernel="nuts")
    _, state, _ = warmup_and_sample(logp, _gen(23), q0, n_warmup=50, n_samples=50, kernel="nuts")
    tail, _, _ = resume_sampling(logp, state, 50, kernel="nuts")
    np.testing.assert_array_equal(_np(full[50:]), _np(tail))
