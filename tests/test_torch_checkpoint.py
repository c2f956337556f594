"""The port's sampler checkpoints (`tpu_bijectors_torch.shard.checkpoint`)
against the JAX package's format and behaviour, float64 on the CPU.

A SamplerState (diagonal and dense metric) and a CheesState round-trip
through one .npz bit for bit, the generator included; the file holds the
leaves in order and a `__treedef__` entry as the JAX package's does; a
state resumed from its checkpoint continues an uninterrupted run draw for
draw, in both layouts of the batched kernel and with the dense metric (as
tests/test_shard.py::test_checkpoint_resume_bitwise has it for the JAX
package); a checkpoint of another structure raises ValueError in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bijectors.infer import init_sampler as jinit_sampler
from tpu_bijectors.shard import load_sampler_state as jload
from tpu_bijectors.shard import save_sampler_state as jsave

from tpu_bijectors_torch.infer import chees, run_chees, sampler
from tpu_bijectors_torch.shard import load_sampler_state, save_sampler_state
from tpu_bijectors_torch.shard.checkpoint import _leaves

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of tiny ops: intra-op threads only add overhead."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_bits(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) and type(a) is type(b)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()) and x.device == y.device
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert x.numpy().tobytes() == y.numpy().tobytes()
        else:
            assert type(x) is type(y) and x == y


def _scale_logp(v):
    return -0.5 * torch.sum((v / torch.tensor([0.5, 1.0, 3.0], dtype=F64)) ** 2, dim=-1)


@pytest.mark.parametrize("metric", ["diag", "dense"])
def test_sampler_state_roundtrip_bit_for_bit(tmp_path, metric):
    g = torch.Generator().manual_seed(4)
    q0 = torch.randn((4, 3), generator=g, dtype=F64)
    _, state, _ = sampler.warmup_and_sample(_scale_logp, g, q0, n_warmup=120, n_samples=0,
                                            kernel="nuts_batched", max_depth=4, metric=metric)
    torch.rand(3, generator=g)  # the generator's state moves past the seed's
    path = str(tmp_path / "sub" / "state.npz")
    save_sampler_state(path, state)
    loaded = load_sampler_state(path, state)
    _same_bits(loaded, state)
    assert loaded.generator is not state.generator
    # the JAX package's format: the leaves in order as arr_0, arr_1, ...
    # beside the structure
    jstate = jinit_sampler(lambda q: -0.5 * jnp.sum(q * q), jax.random.PRNGKey(0),
                           jnp.zeros((4, 3)), metric=metric)
    jsave(str(tmp_path / "j.npz"), jstate)
    for f in (path, str(tmp_path / "j.npz")):
        with np.load(f) as data:
            n = len(data.files) - 1
            assert sorted(data.files) == sorted([f"arr_{i}" for i in range(n)] + ["__treedef__"])
    with np.load(path) as data:
        # leaf for leaf: the generator's state where JAX has its key
        assert len(data.files) - 1 == len(_leaves(state)) == len(
            jax.tree_util.tree_leaves(jstate))


def test_chees_state_roundtrip(tmp_path):
    def logp(v):
        return -0.5 * torch.sum(v * v, -1)

    logp.batch_capable = True
    g = torch.Generator().manual_seed(5)
    _, st, _ = run_chees(logp, g, torch.randn((6, 2), generator=g, dtype=F64), n_warmup=20,
                         n_samples=3, metric="dense")
    path = str(tmp_path / "chees.npz")
    save_sampler_state(path, st)
    loaded = load_sampler_state(path, st)
    assert isinstance(loaded, chees.CheesState)
    _same_bits(loaded, st)


@pytest.mark.parametrize("kernel,metric", [("nuts_batched_t", "diag"), ("nuts_batched", "dense"),
                                           ("nuts_batched_t", "dense")])
def test_resume_from_checkpoint_is_bitwise(tmp_path, kernel, metric):
    """The draws, state and stats of 2 x 5 draws with a save and a load in
    between are those of one run of 10 (tests/test_shard.py::
    test_checkpoint_resume_bitwise)."""
    scale = torch.tensor([0.5, 1.0, 3.0], dtype=F64)

    def ld(v):
        if kernel == "nuts_batched_t":
            return -0.5 * torch.sum((v / scale[:, None]) ** 2, dim=0)
        return -0.5 * torch.sum((v / scale) ** 2, dim=-1)

    q0 = torch.randn((4, 3), generator=torch.Generator().manual_seed(2), dtype=F64)
    kw = dict(kernel=kernel, max_depth=4)
    full = sampler.warmup_and_sample(ld, torch.Generator().manual_seed(1), q0, n_warmup=40,
                                     n_samples=10, metric=metric, **kw)
    _, state, _ = sampler.warmup_and_sample(ld, torch.Generator().manual_seed(1), q0,
                                            n_warmup=40, n_samples=0, metric=metric, **kw)
    first = sampler.resume_sampling(ld, state, 5, **kw)
    path = str(tmp_path / "mid.npz")
    save_sampler_state(path, first[1])
    second = sampler.resume_sampling(ld, load_sampler_state(path, first[1]), 5, **kw)
    assert torch.equal(torch.cat([first[0], second[0]]), full[0])
    _same_bits(second[1], full[1])
    for a, b, c in zip(first[2], second[2], full[2]):
        assert torch.equal(torch.cat([a, b]), c)


def test_mismatched_checkpoint_raises(tmp_path):
    g = torch.Generator().manual_seed(0)
    q0 = torch.zeros((2, 3), dtype=F64)
    state = sampler.init_sampler(_scale_logp, g, q0)
    path = str(tmp_path / "s.npz")
    save_sampler_state(path, state)
    with pytest.raises(ValueError, match="leaves"):
        load_sampler_state(path, (state, torch.zeros(1)))
    with pytest.raises(ValueError, match="leaves"):
        load_sampler_state(path, state.ss)
    jstate = jinit_sampler(lambda q: -0.5 * jnp.sum(q * q), jax.random.PRNGKey(0),
                           jnp.zeros((2, 3)))
    jsave(str(tmp_path / "j.npz"), jstate)
    with pytest.raises(ValueError, match="leaves"):
        jload(str(tmp_path / "j.npz"), jstate.ss)
