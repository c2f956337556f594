"""Prior and posterior predictive draws and posterior predictive checks,
PyTorch counterpart of `tpu_bijectors/infer/predictive.py`.

The simulate contract differs from the JAX package's by design. There,
`simulate(key, x)` makes the dataset of one draw x and `jax.vmap` runs it
over split keys; one `torch.Generator` has no per-example split, so here
`simulate(generator, x)` takes the whole leading batch of draws x (every
leaf with a leading (n,) axis) and returns the batch of n datasets, drawn
from `generator`. SBC (sbc.py) takes the same contract.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def prior_predictive(prior, simulate, generator, n: int):
    """n draws from the prior predictive: theta ~ prior, y ~ p(y | theta).
    Returns (theta, y), both with leading (n,) axes."""
    theta = prior.sample(generator, (n,))
    return theta, simulate(generator, theta)


def posterior_predictive(simulate, samples, generator, has_chains: bool | None = None):
    """Replicated datasets from posterior draws.

    samples: the constrained tree `Model.sample` returns (leaves with
    leading (draws, chains) axes) or any tree with one leading draw axis.
    Returns the data with one leading (n_total,) axis.

    has_chains: True, the leaves carry (draws, chains) leading axes;
    False, one flat (draws,) axis. The default (None) infers it from
    whether every leaf shares its first two axes, which cannot tell flat
    draws of a k-vector {"w": (draws, k)} from chained scalar draws: pass
    has_chains=False for flat vector-valued draws (run_ensemble's pushed
    through Model.constrain)."""
    leaves = pytree.tree_leaves(samples)
    if has_chains is None:
        lead = leaves[0].shape[:2] if leaves[0].ndim >= 2 else leaves[0].shape[:1]
        has_chains = all(leaf.ndim >= 2 and leaf.shape[:2] == lead for leaf in leaves)
    n_lead = 2 if has_chains else 1
    flat = pytree.tree_map(lambda leaf: leaf.reshape((-1,) + tuple(leaf.shape[n_lead:])),
                           samples)
    return simulate(generator, flat)


def ppc_pvalue(stat_fn, observed, replicated):
    """Posterior predictive p-value P(T(y_rep) >= T(y_obs)). stat_fn maps
    one dataset to a scalar statistic (vmapped over the replicated leading
    axis). Values near 0 or 1 flag misfit in the direction T measures
    (Gelman, Meng & Stern 1996)."""
    t_obs = stat_fn(observed)
    t_rep = torch.func.vmap(stat_fn)(replicated)
    dtype = t_rep.dtype if t_rep.is_floating_point() else torch.get_default_dtype()
    return torch.mean((t_rep >= t_obs).to(dtype))
