"""Matrix-variate families, PyTorch counterpart of
`tpu_bijectors/dists/matrix.py`: LKJ, LKJCholesky, Wishart,
InverseWishart, MatrixBeta (the PD link, its density from the link's
factor L beside a Cholesky of I - U) and MatrixTDist (the identity link).

LKJ and LKJCholesky fuse their linked densities on the log-diagonal of
the factor that the inverse link computes anyway (`logpdf_from_factor`):
on the batch-major path the LKJ log-det kernel gives it without forming
the factor (its Cholesky variant for LKJCholesky).

The Wishart families fuse their linked density on the PD links' kernels
(bijectors/pd.py): `fused_linked_logdensity` and its transposed form run
the PD log-density kernel (logJ, sum y_rr and the trace, X and L never
formed), `logpdf_from_factor` takes the factor L that the inverse link
computes anyway. Sampling uses the Bartlett decomposition (the LKJ
families the onion method), every draw from an explicit `torch.Generator`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch

from ..kernels.pd import MAX_K
from ..utils import cholesky_lower
from . import _random as R
from .base import (
    CHOLESKY_CORRELATION,
    CORRELATION,
    POSITIVE_DEFINITE,
    REAL_MATRIX,
    LeafDistribution,
)

LOG2 = math.log(2.0)
LOGPI = math.log(math.pi)


def _lkj_log_normalizer(K: int, eta):
    """log c_K(eta) for the density det(R)^(eta-1) / c_K(eta):

    c_K(eta) = prod_{k=1}^{K-1} 2^{(2 eta - 2 + K - k)(K - k)}
               * B(eta + (K-k-1)/2, eta + (K-k-1)/2)^{K-k}
    (Lewandowski-Kurowicka-Joe 2009)."""
    # made on eta's device: a copy from the host would wait for the card
    km = K - torch.arange(1, K, dtype=eta.dtype, device=eta.device)
    a = eta + (km - 1.0) / 2.0
    lbeta = 2.0 * torch.lgamma(a) - torch.lgamma(2.0 * a)
    return torch.sum((2.0 * eta - 2.0 + km) * km * LOG2 + km * lbeta)


def _sample_lkj_chol_upper(generator, K: int, eta, shape):
    """The onion method: the upper Cholesky factor U (unit-norm columns) of
    LKJ(eta) correlation matrices, batched over `shape`: column j's
    direction from normals, its squared length y_j ~ Beta(j/2, eta +
    (K-1-j)/2) (0-based j >= 1)."""
    shape = tuple(shape)
    up = torch.triu(torch.ones(K, K, dtype=torch.bool, device=eta.device), 1)
    g = torch.where(up, R.normal(generator, shape + (K, K), eta), 0.0)
    norm = torch.sqrt(torch.sum(g * g, -2, keepdim=True))
    u = torch.where(up, g / torch.where(norm == 0, 1.0, norm), 0.0)
    j = torch.arange(1, K, dtype=eta.dtype, device=eta.device)
    y = R.beta(generator, j / 2.0, eta[..., None] + (K - 1.0 - j) / 2.0, shape + (K - 1,))
    zero = torch.zeros(shape + (1,), dtype=eta.dtype, device=eta.device)
    sqrt_y = torch.cat([zero, torch.sqrt(y)], -1)
    diag = torch.cat([zero + 1.0, torch.sqrt(1.0 - y)], -1)
    return u * sqrt_y[..., None, :] + torch.diag_embed(diag)


@dataclass(frozen=True)
class LKJ(LeafDistribution):
    """LKJ(dim, eta) over correlation matrices; density det(R)^(eta-1)/c."""

    dim: int
    eta: object = 1.0

    _params = ("eta",)
    event_ndims = 2

    @property
    def event_shape(self):
        return (self.dim, self.dim)

    def logpdf(self, X):
        L = torch.linalg.cholesky(0.5 * (X + X.transpose(-1, -2)))
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
        return (self.eta - 1.0) * logdet - _lkj_log_normalizer(self.dim, self.eta)

    def logpdf_from_factor(self, log_diag_w, x=None):
        """Density from the log-diagonal of the upper factor W of X = W'W,
        which the VecCorrBijector inverse computes anyway: logdet X =
        2 sum log W_jj. No re-decomposition of X (x is not needed)."""
        logdet = 2.0 * torch.sum(log_diag_w, -1)
        return (self.eta - 1.0) * logdet - _lkj_log_normalizer(self.dim, self.eta)

    def sample(self, generator, sample_shape=()):
        U = _sample_lkj_chol_upper(generator, self.dim, self.eta,
                                   tuple(sample_shape) + self.batch_shape)
        return U.transpose(-1, -2) @ U

    @property
    def support(self):
        return CORRELATION


@dataclass(frozen=True)
class LKJCholesky(LeafDistribution):
    """LKJCholesky(dim, eta, mode) over Cholesky factors of LKJ(eta)
    correlation matrices, lower ('L', the default) or upper ('U'):

      log p(L) = sum_{j=2}^{K} (2 eta - 2 + K - j) log L_jj - log c_K(eta)

    (1-based j; the Jacobian of R -> L is prod_j L_jj^(K-j))."""

    dim: int
    eta: object = 1.0
    mode: str = "L"

    _params = ("eta",)
    event_ndims = 2

    def __post_init__(self, device, dtype):
        if self.mode not in ("L", "U"):
            raise ValueError("mode must be 'L' or 'U'")
        super().__post_init__(device, dtype)

    @property
    def event_shape(self):
        return (self.dim, self.dim)

    def _coeff(self):
        K = self.dim
        jj = torch.arange(1, K + 1, dtype=self.eta.dtype, device=self.eta.device)
        return 2.0 * self.eta[..., None] - 2.0 + K - jj

    def logpdf(self, X):
        d = torch.diagonal(X, dim1=-2, dim2=-1)
        first = torch.arange(self.dim, device=X.device) == 0
        lp = torch.sum(self._coeff() * torch.log(torch.where(first, torch.ones_like(d), d)), -1)
        return lp - _lkj_log_normalizer(self.dim, self.eta)

    def logpdf_from_factor(self, log_diag, x=None):
        """Density from the factor's log-diagonal, which the VecCholesky
        inverse link gives without forming the factor."""
        return torch.sum(self._coeff() * log_diag, -1) - _lkj_log_normalizer(self.dim, self.eta)

    def sample(self, generator, sample_shape=()):
        U = _sample_lkj_chol_upper(generator, self.dim, self.eta,
                                   tuple(sample_shape) + self.batch_shape)
        return U.transpose(-1, -2) if self.mode == "L" else U

    @property
    def support(self):
        return CHOLESKY_CORRELATION


def _mv_lgamma(a, p: int):
    """Multivariate log-gamma log Gamma_p(a)."""
    i = torch.arange(1, p + 1, dtype=a.dtype, device=a.device)
    return 0.25 * p * (p - 1) * LOGPI + torch.sum(torch.lgamma(a[..., None] + 0.5 * (1.0 - i)), -1)


def _bartlett_chol(generator, df, S_chol, K: int, shape):
    """Cholesky factor of a Wishart(df, S) draw by the Bartlett
    decomposition: S_chol A with A lower, A_ii^2 ~ chi2(df - i) (0-based i)
    and N(0, 1) below the diagonal."""
    dtype, device = S_chol.dtype, S_chol.device
    i = torch.arange(K, dtype=dtype, device=device)
    chi_df = df[..., None] - i
    c = torch.sqrt(2.0 * R.gamma(generator, 0.5 * chi_df, tuple(shape) + (K,)))
    n = torch.randn(tuple(shape) + (K, K), generator=generator, dtype=dtype, device=device)
    A = torch.tril(n, -1) + torch.diag_embed(c)
    return S_chol @ A


class _PDFamily(LeafDistribution):
    """What Wishart and InverseWishart share: the event and batch shapes of
    their matrix parameter, and the linked density fused on the PD
    log-density kernel. `pd_terms` gives the kernel's C and mode and the
    density's weight on sum y_rr and its constant; the fused whole-model
    plan (vectorize/fused_plan.py) takes the same terms for its PD loop
    entry."""

    event_ndims = 2
    mode: ClassVar[str]

    def _matrix(self):
        return getattr(self, self._params[1])

    @property
    def event_shape(self):
        return tuple(self._matrix().shape[-2:])

    @property
    def batch_shape(self):
        return tuple(self._matrix().shape[:-2])

    def pd_terms(self, dtype):
        """(C, w, const) in `dtype`: logpdf(X) + logJ = logJ + w sum_r y_rr
        - tr / 2 + const, with tr the PD kernels' trace of C in `mode`."""
        raise NotImplementedError

    def _fusable(self, bijector):
        """Whether the PD log-density kernel serves this leaf: the PD vector
        link, one matrix parameter and a scalar df, K within the kernels'
        limit. Where it does not, the density composes on the PD inverse
        link, which raises beyond that limit off the CPU."""
        from ..bijectors.pd import PDVecBijector

        M = self._matrix()
        return (type(bijector) is PDVecBijector and M.ndim == 2 and self.df.ndim == 0
                and M.shape[-1] <= MAX_K)

    def _fused(self, y):
        from ..bijectors.pd import _pd_logdensity

        C, w, const = self.pd_terms(y.dtype)
        logJ, sumd, tr = _pd_logdensity(y, C.shape[-1], C, self.mode)
        return w * sumd - 0.5 * tr + const + logJ

    def fused_linked_logdensity(self, bijector, y, want_x: bool = True):
        """(x, the linked density) by the PD log-density kernel (the
        vectorize.core hook), its gradient by the trace-gradient kernel;
        x, where wanted (a likelihood's), by the PD inverse link beside it,
        else X and L are never formed. Declines (None) where the kernel
        does not serve the leaf."""
        if not self._fusable(bijector):
            return None
        x = bijector.inverse_and_log_det(y)[0] if want_x else None
        return x, self._fused(y)

    def fused_linked_logdensity_t(self, bijector, yT):
        """The same on the transposed (P, B) block, read in place."""
        if not self._fusable(bijector):
            return None
        return self._fused(yT.transpose(0, 1))

    @property
    def support(self):
        return POSITIVE_DEFINITE


@dataclass(frozen=True)
class Wishart(_PDFamily):
    """Wishart(df, S) over SPD matrices (S the scale matrix); fused in dot
    mode, tr(S^-1 X)."""

    df: object
    scale: object

    _params = ("df", "scale")
    mode = "dot"

    def _const(self, Sc, v, K):
        """The terms without X: -v K log 2 / 2 - v log det S / 2 - log Gamma_K(v/2)."""
        logdetS = 2.0 * torch.sum(torch.log(torch.diagonal(Sc, dim1=-2, dim2=-1)), -1)
        return -0.5 * v * K * LOG2 - 0.5 * v * logdetS - _mv_lgamma(0.5 * v, K)

    def _sinv(self, Sc, K):
        eye = torch.eye(K, dtype=Sc.dtype, device=Sc.device)
        return torch.cholesky_solve(eye, Sc)

    def pd_terms(self, dtype):
        K = self.scale.shape[-1]
        v = self.df.to(dtype)
        Sc = cholesky_lower(self.scale.to(dtype))
        Sinv = self._sinv(Sc, K)
        return 0.5 * (Sinv + Sinv.T), v - K - 1.0, self._const(Sc, v, K)

    def logpdf(self, X):
        K = self.scale.shape[-1]
        v, S = self.df, self.scale
        logdetX = torch.linalg.slogdet(X)[1]
        logdetS = torch.linalg.slogdet(S)[1]
        tr = torch.diagonal(torch.linalg.solve(S, X), dim1=-2, dim2=-1).sum(-1)
        return (0.5 * (v - K - 1.0) * logdetX - 0.5 * tr - 0.5 * v * K * LOG2
                - 0.5 * v * logdetS - _mv_lgamma(0.5 * v, K))

    def logpdf_from_factor(self, L, x=None):
        """Density from the lower Cholesky factor L of X = LL' (the factor the
        PDVecBijector inverse computes anyway): log det X = 2 sum log L_ii.
        The trace is sum(S^-1 * x) where the caller has x (one K x K solve
        for S^-1), else ||Sc^-1 L||_F^2."""
        K = self.scale.shape[-1]
        v = self.df
        Sc = cholesky_lower(self.scale)
        logdetX = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
        if x is not None:
            tr = torch.sum(self._sinv(Sc, K) * x, dim=(-2, -1))
        else:
            A = torch.linalg.solve_triangular(Sc.expand(L.shape), L, upper=False)
            tr = torch.sum(A * A, dim=(-2, -1))
        return 0.5 * (v - K - 1.0) * logdetX - 0.5 * tr + self._const(Sc, v, K)

    def sample(self, generator, sample_shape=()):
        """X draws of shape sample_shape + batch_shape + (K, K) from `generator`."""
        K = self.scale.shape[-1]
        shape = tuple(sample_shape) + self.batch_shape
        L = _bartlett_chol(generator, self.df, cholesky_lower(self.scale), K, shape)
        return L @ L.transpose(-1, -2)


@dataclass(frozen=True)
class InverseWishart(_PDFamily):
    """InverseWishart(df, Psi) over SPD matrices; fused in solve mode,
    tr(Psi X^-1) = ||L^-1 chol(Psi)||_F^2 by forward substitution."""

    df: object
    psi: object

    _params = ("df", "psi")
    mode = "solve"

    def _const(self, Pc, v, K):
        """The terms without X: v log det Psi / 2 - v K log 2 / 2 - log Gamma_K(v/2)."""
        logdetP = 2.0 * torch.sum(torch.log(torch.diagonal(Pc, dim1=-2, dim2=-1)), -1)
        return 0.5 * v * logdetP - 0.5 * v * K * LOG2 - _mv_lgamma(0.5 * v, K)

    def pd_terms(self, dtype):
        K = self.psi.shape[-1]
        v = self.df.to(dtype)
        Pc = cholesky_lower(self.psi.to(dtype))
        return Pc, -(v + K + 1.0), self._const(Pc, v, K)

    def logpdf(self, X):
        K = self.psi.shape[-1]
        v, P = self.df, self.psi
        logdetX = torch.linalg.slogdet(X)[1]
        logdetP = torch.linalg.slogdet(P)[1]
        tr = torch.diagonal(torch.linalg.solve(X, P), dim1=-2, dim2=-1).sum(-1)
        return (0.5 * v * logdetP - 0.5 * (v + K + 1.0) * logdetX - 0.5 * tr
                - 0.5 * v * K * LOG2 - _mv_lgamma(0.5 * v, K))

    def logpdf_from_factor(self, L, x=None):
        """Density from the lower Cholesky factor L of X = LL':
        tr(Psi X^-1) = ||L^-1 chol(Psi)||_F^2 (x is not needed)."""
        K = self.psi.shape[-1]
        v = self.df
        Pc = cholesky_lower(self.psi)
        logdetX = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
        A = torch.linalg.solve_triangular(L, Pc.expand(L.shape), upper=False)
        tr = torch.sum(A * A, dim=(-2, -1))
        return -0.5 * (v + K + 1.0) * logdetX - 0.5 * tr + self._const(Pc, v, K)

    def sample(self, generator, sample_shape=()):
        """X draws: the inverse of Wishart(df, Psi^-1) draws."""
        K = self.psi.shape[-1]
        shape = tuple(sample_shape) + self.batch_shape
        Pinv_chol = cholesky_lower(torch.linalg.inv(self.psi))
        L = _bartlett_chol(generator, self.df, Pinv_chol, K, shape)
        return torch.linalg.inv(L @ L.transpose(-1, -2))


@dataclass(frozen=True)
class MatrixBeta(LeafDistribution):
    """MatrixBeta(p, n1, n2) over p x p SPD matrices U with I - U SPD
    (Gupta and Nagar ch. 5), on the PD link (reference
    src/transformed_distribution.jl:138-139), which like the reference's
    enforces U > 0 alone: logdet(I - U) is NaN or -inf outside U < I.

      logpdf(U) = (n1 - p - 1)/2 logdet U + (n2 - p - 1)/2 logdet(I - U)
                  - log B_p(n1/2, n2/2)

    Draws: S1 ~ Wishart(n1, I), S2 ~ Wishart(n2, I), L = chol(S1 + S2),
    U = L^-1 S1 L^-T."""

    p: int
    n1: object
    n2: object

    _params = ("n1", "n2")
    event_ndims = 2

    def __post_init__(self, device, dtype):
        object.__setattr__(self, "p", int(self.p))
        super().__post_init__(device, dtype)

    @property
    def event_shape(self):
        return (self.p, self.p)

    def _log_norm(self):
        a, b = 0.5 * self.n1, 0.5 * self.n2
        return _mv_lgamma(a, self.p) + _mv_lgamma(b, self.p) - _mv_lgamma(a + b, self.p)

    def _from_logdets(self, logdetU, logdetImU):
        p = self.p
        return (0.5 * (self.n1 - p - 1.0) * logdetU + 0.5 * (self.n2 - p - 1.0) * logdetImU
                - self._log_norm())

    @staticmethod
    def _logdet(M):
        """log det M by Cholesky, its value and gradient NaN where M is not
        positive definite (as the JAX package's factor makes them: U
        outside U < I)."""
        L, info = torch.linalg.cholesky_ex(0.5 * (M + M.transpose(-1, -2)))
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
        return logdet * torch.where(info == 0, 1.0, math.nan).to(logdet.dtype)

    def logpdf(self, U):
        eye = torch.eye(self.p, dtype=U.dtype, device=U.device)
        return self._from_logdets(self._logdet(U), self._logdet(eye - U))

    def logpdf_from_factor(self, L, x=None):
        """The density from the lower Cholesky factor L of U = LL' (the
        factor the PD inverse link computes anyway): logdet U is free; U
        is formed from L where the caller has no x, for logdet(I - U)."""
        logdetU = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
        U = x if x is not None else L @ L.transpose(-1, -2)
        eye = torch.eye(self.p, dtype=L.dtype, device=L.device)
        return self._from_logdets(logdetU, self._logdet(eye - U))

    def sample(self, generator, sample_shape=()):
        p = self.p
        shape = tuple(sample_shape) + self.batch_shape
        eye = torch.eye(p, dtype=self.n1.dtype, device=self.n1.device)
        L1 = _bartlett_chol(generator, self.n1, eye, p, shape)
        L2 = _bartlett_chol(generator, self.n2, eye, p, shape)
        S1 = L1 @ L1.transpose(-1, -2)
        S2 = L2 @ L2.transpose(-1, -2)
        L = cholesky_lower(S1 + S2)
        A = torch.linalg.solve_triangular(L, S1, upper=False)
        U = torch.linalg.solve_triangular(L, A.transpose(-1, -2), upper=False)
        return 0.5 * (U + U.transpose(-1, -2))  # symmetric against rounding

    @property
    def support(self):
        return POSITIVE_DEFINITE


@dataclass(frozen=True)
class MatrixTDist(LeafDistribution):
    """The matrix t-distribution MT(nu, M, Sigma, Omega) (Gupta and Nagar
    thm 4.2.1; reference test/vector/matrix.jl:9): M (n, p), the row scale
    Sigma (n, n) and the column scale Omega (p, p), both SPD. X | S ~
    MN(M, S, Omega) with S ~ InverseWishart(nu + n - 1, Sigma); the
    identity link (real-matrix support)."""

    df: object
    loc: object
    row_scale: object
    col_scale: object

    _params = ("df", "loc", "row_scale", "col_scale")
    event_ndims = 2

    @property
    def event_shape(self):
        return tuple(self.loc.shape[-2:])

    @property
    def batch_shape(self):
        return tuple(self.loc.shape[:-2])

    def logpdf(self, X):
        n, p = self.event_shape
        v = self.df
        Ls, Lo = cholesky_lower(self.row_scale), cholesky_lower(self.col_scale)
        D = X - self.loc
        batch = D.shape[:-2]
        # A = Ls^-1 D Lo^-T: |I + Sigma^-1 D Omega^-1 D'| = |I + A A'|
        A = torch.linalg.solve_triangular(Ls.expand(batch + (n, n)), D, upper=False)
        A = torch.linalg.solve_triangular(Lo.expand(batch + (p, p)), A.transpose(-1, -2),
                                          upper=False).transpose(-1, -2)
        G = torch.eye(n, dtype=X.dtype, device=X.device) + A @ A.transpose(-1, -2)
        logdet = lambda L: 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)  # noqa: E731
        a, b = 0.5 * (v + n + p - 1.0), 0.5 * (v + n - 1.0)
        return (_mv_lgamma(a, n) - _mv_lgamma(b, n) - 0.5 * n * p * LOGPI
                - 0.5 * p * logdet(Ls) - 0.5 * n * logdet(Lo) - a * logdet(cholesky_lower(G)))

    def sample(self, generator, sample_shape=()):
        n, p = self.event_shape
        S = InverseWishart(self.df + n - 1.0, self.row_scale, device=self.df.device).sample(
            generator, sample_shape)
        Lo = cholesky_lower(self.col_scale)
        Z = R.normal(generator, tuple(sample_shape) + self.batch_shape + (n, p), self.loc)
        return self.loc + cholesky_lower(S) @ Z @ Lo.transpose(-1, -2)

    @property
    def support(self):
        return REAL_MATRIX
