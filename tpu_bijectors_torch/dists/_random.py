"""The families' random draws, every one from an explicit
`torch.Generator` (the port's counterpart of the `jax.random` samplers the
JAX families call). Each takes the generator, the output shape and a
tensor whose dtype and device the draw takes. A draw runs where its
generator lives: a `cuda` generator draws on the card.
"""

from __future__ import annotations

import math

import torch


def normal(g, shape, like):
    return torch.randn(tuple(shape), generator=g, dtype=like.dtype, device=like.device)


def uniform(g, shape, like, tiny: bool = False):
    """U[0, 1), or U[tiny, 1) with `tiny` (the JAX samplers' minval =
    finfo.tiny, for draws that take log u)."""
    u = torch.rand(tuple(shape), generator=g, dtype=like.dtype, device=like.device)
    return torch.clamp_min(u, torch.finfo(like.dtype).tiny) if tiny else u


def gamma(g, conc, shape):
    """Gamma(conc, 1) draws of `shape` (conc broadcast to it)."""
    return torch._standard_gamma(conc.expand(tuple(shape)).contiguous(), generator=g)


def beta(g, a, b, shape):
    ga, gb = gamma(g, a, shape), gamma(g, b, shape)
    return ga / (ga + gb)


def cauchy(g, shape, like):
    return torch.tan(math.pi * (uniform(g, shape, like) - 0.5))


def laplace(g, shape, like):
    """-sign(u) log1p(-|u|), u ~ U(-1, 1)."""
    u = 2.0 * uniform(g, shape, like, tiny=True) - 1.0
    return -torch.sign(u) * torch.log1p(-torch.abs(u))


def logistic(g, shape, like):
    u = uniform(g, shape, like, tiny=True)
    return torch.log(u) - torch.log1p(-u)


def gumbel(g, shape, like):
    return -torch.log(-torch.log(uniform(g, shape, like, tiny=True)))


def exponential(g, shape, like):
    return -torch.log1p(-uniform(g, shape, like))


def student_t(g, df, shape, like):
    """N(0, 1) / sqrt(chi2(df) / df)."""
    n = normal(g, shape, like)
    return n * torch.sqrt(0.5 * df / gamma(g, 0.5 * df, shape))


def categorical(g, logits, shape):
    """Indices drawn with probabilities softmax(logits) over the last axis."""
    probs = torch.softmax(logits, -1)
    n = math.prod(shape)
    idx = torch.multinomial(probs.expand(max(n, 1), -1), 1, replacement=True, generator=g)
    return idx[:n, 0].reshape(tuple(shape))



def poisson(g, rate, shape):
    """Poisson(rate) counts of `shape` (rate broadcast to it), as floats."""
    return torch.poisson(rate.expand(tuple(shape)).contiguous(), generator=g)


def bernoulli(g, p, shape):
    """1 with probability p, else 0 (u < p, the JAX sampler's), as floats."""
    return (uniform(g, shape, p) < p).to(p.dtype)


def binomial(g, count, p, shape):
    """Binomial(count, p) counts of `shape` (both broadcast to it), as floats."""
    return torch.binomial(count.expand(tuple(shape)).contiguous(),
                          p.expand(tuple(shape)).contiguous(), generator=g)
