"""Prior distributions over GLM coefficient vectors.

JAX replacement for the reference's use of the CRAN ``distributional``
package (reference: R/mcmcglm.R:150,205-212; R/glm_utils.R:103-115;
R/sampling.R:5,23-25).  Two layers:

  * :class:`Distribution` — a small library of pure-JAX distributions with
    ``log_prob`` / ``sample`` / ``mean`` / ``variance`` (the operations the
    reference pulls from ``distributional``: ``density(log=TRUE)``,
    ``generate``, ``mean``, ``covariance``/``variance``).
  * :class:`BetaPrior` — a prior over the full coefficient vector beta with
    the *coordinate-delta* operation ``coord_log_prob(beta, j, b)`` the
    CGGibbs engine needs: the log prior as a function of a proposed value
    ``b`` for coordinate ``j`` only, up to a ``b``-independent constant.
    The reference evaluates the prior on the whole beta vector at every
    slice evaluation (O(d) waste, R/glm_utils.R:214-215); here we
    evaluate only the j-th marginal's contribution (exact for iid and
    per-coordinate priors; for a multivariate-normal prior the quadratic
    form reduces to a scalar quadratic in ``b`` given the off-coordinate
    inner product, computed with one O(d) row gather).

Parity notes (deliberate deviations, SURVEY.md §7):
  * the reference's list-of-priors density is mathematically off — it applies
    every marginal to the *entire* beta vector and sums
    (R/glm_utils.R:113-115).  :class:`StackedPrior` implements the correct
    sum_j log f_j(beta_j).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "Distribution",
    "Normal",
    "Gamma",
    "Exponential",
    "StudentT",
    "Laplace",
    "Uniform",
    "MultivariateNormal",
    "BetaPrior",
    "IIDPrior",
    "StackedPrior",
    "MVNPrior",
    "make_beta_prior",
]

_LOG_2PI = math.log(2.0 * math.pi)


def _f(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype)


class Distribution:
    """Minimal univariate distribution interface (log_prob/sample/moments)."""

    def log_prob(self, x):
        raise NotImplementedError

    def sample(self, key, shape=()):
        raise NotImplementedError

    def mean(self):
        raise NotImplementedError

    def variance(self):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Normal(Distribution):
    """Normal(loc, scale) — analogue of distributional::dist_normal(mean, sd)."""

    loc: float = 0.0
    scale: float = 1.0

    def log_prob(self, x):
        dtype = jnp.result_type(x, jnp.float32)
        z = (x - _f(self.loc, dtype)) / _f(self.scale, dtype)
        return -0.5 * z * z - jnp.log(_f(self.scale, dtype)) - _f(0.5 * _LOG_2PI, dtype)

    def sample(self, key, shape=()):
        return self.loc + self.scale * jax.random.normal(key, shape)

    def mean(self):
        return self.loc

    def variance(self):
        return self.scale**2


@dataclasses.dataclass(frozen=True)
class Gamma(Distribution):
    """Gamma(shape, rate) — analogue of distributional::dist_gamma(shape, rate)."""

    concentration: float = 1.0
    rate: float = 1.0

    def log_prob(self, x):
        dtype = jnp.result_type(x, jnp.float32)
        a = _f(self.concentration, dtype)
        r = _f(self.rate, dtype)
        xin = jnp.maximum(x, jnp.finfo(dtype).tiny)
        lp = a * jnp.log(r) - jax.lax.lgamma(a) + (a - 1.0) * jnp.log(xin) - r * xin
        return jnp.where(x > 0, lp, -jnp.inf)

    def sample(self, key, shape=()):
        return jax.random.gamma(key, self.concentration, shape) / self.rate

    def mean(self):
        return self.concentration / self.rate

    def variance(self):
        return self.concentration / self.rate**2


@dataclasses.dataclass(frozen=True)
class Exponential(Distribution):
    """Exponential(rate) — analogue of distributional::dist_exponential(rate)."""

    rate: float = 1.0

    def log_prob(self, x):
        dtype = jnp.result_type(x, jnp.float32)
        r = _f(self.rate, dtype)
        return jnp.where(x >= 0, jnp.log(r) - r * x, -jnp.inf)

    def sample(self, key, shape=()):
        return jax.random.exponential(key, shape) / self.rate

    def mean(self):
        return 1.0 / self.rate

    def variance(self):
        return 1.0 / self.rate**2


@dataclasses.dataclass(frozen=True)
class StudentT(Distribution):
    """Student-t(df, loc, scale) — analogue of distributional::dist_student_t."""

    df: float = 1.0
    loc: float = 0.0
    scale: float = 1.0

    def log_prob(self, x):
        dtype = jnp.result_type(x, jnp.float32)
        v = _f(self.df, dtype)
        z = (x - _f(self.loc, dtype)) / _f(self.scale, dtype)
        return (
            jax.lax.lgamma((v + 1.0) / 2.0)
            - jax.lax.lgamma(v / 2.0)
            - 0.5 * jnp.log(v * _f(math.pi, dtype))
            - jnp.log(_f(self.scale, dtype))
            - (v + 1.0) / 2.0 * jnp.log1p(z * z / v)
        )

    def sample(self, key, shape=()):
        return self.loc + self.scale * jax.random.t(key, self.df, shape)

    def mean(self):
        return self.loc  # defined for df > 1

    def variance(self):
        return self.scale**2 * self.df / (self.df - 2.0)  # defined for df > 2


@dataclasses.dataclass(frozen=True)
class Laplace(Distribution):
    """Laplace(loc, scale) — the sparse prior in BASELINE config #3."""

    loc: float = 0.0
    scale: float = 1.0

    def log_prob(self, x):
        dtype = jnp.result_type(x, jnp.float32)
        b = _f(self.scale, dtype)
        return -jnp.abs(x - _f(self.loc, dtype)) / b - jnp.log(2.0 * b)

    def sample(self, key, shape=()):
        return self.loc + self.scale * jax.random.laplace(key, shape)

    def mean(self):
        return self.loc

    def variance(self):
        return 2.0 * self.scale**2


@dataclasses.dataclass(frozen=True)
class Uniform(Distribution):
    low: float = 0.0
    high: float = 1.0

    def log_prob(self, x):
        dtype = jnp.result_type(x, jnp.float32)
        width = _f(self.high - self.low, dtype)
        inside = (x >= self.low) & (x <= self.high)
        return jnp.where(inside, -jnp.log(width), -jnp.inf)

    def sample(self, key, shape=()):
        return jax.random.uniform(key, shape, minval=self.low, maxval=self.high)

    def mean(self):
        return 0.5 * (self.low + self.high)

    def variance(self):
        return (self.high - self.low) ** 2 / 12.0


class MultivariateNormal:
    """MVN(loc, cov) — analogue of distributional::dist_multivariate_normal
    (reference usage: vignettes/pospkg.Rmd:224-236)."""

    def __init__(self, loc, cov):
        self.loc = jnp.asarray(loc)
        self.cov = jnp.asarray(cov)

    def log_prob(self, x):
        d = self.loc.shape[-1]
        dtype = jnp.result_type(x, jnp.float32)
        chol = jnp.linalg.cholesky(self.cov.astype(dtype))
        diff = x - self.loc.astype(dtype)
        z = jax.scipy.linalg.solve_triangular(chol, diff, lower=True)
        logdet = jnp.sum(jnp.log(jnp.diagonal(chol)))
        return -0.5 * jnp.sum(z * z, axis=-1) - logdet - 0.5 * d * _f(_LOG_2PI, dtype)

    def sample(self, key, shape=()):
        chol = jnp.linalg.cholesky(self.cov)
        eps = jax.random.normal(key, tuple(shape) + self.loc.shape)
        return self.loc + jnp.matmul(eps, chol.T,
                                     precision=lax.Precision.HIGHEST)

    def mean(self):
        return self.loc

    def covariance(self):
        return self.cov


# --------------------------------------------------------------------------
# Priors over the full coefficient vector
# --------------------------------------------------------------------------


class BetaPrior:
    """Prior over beta in R^d with the coordinate-delta operation the
    CGGibbs engine needs.  All methods are jit/vmap/scan-safe."""

    d: int

    def sample_beta(self, key):
        """Initial beta draw (reference init: R/mcmcglm.R:200-213)."""
        raise NotImplementedError

    def log_prob_beta(self, beta):
        """Full log prior density of the vector (R/glm_utils.R:103-115)."""
        raise NotImplementedError

    def coord_log_prob(self, beta, j, b):
        """Log prior as a function of proposal ``b`` at coordinate ``j``
        (up to a constant in ``b``).  ``j`` may be a traced index."""
        raise NotImplementedError

    def mean_beta(self):
        raise NotImplementedError

    def cov_beta(self):
        """Covariance matrix (for the conjugate oracle, R/sampling.R:5-6)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class IIDPrior(BetaPrior):
    """Each coordinate iid from one univariate distribution — the reference's
    default ``beta_prior = dist_normal(0, 1)`` case (R/mcmcglm.R:150,208)."""

    dist: Distribution
    d: int

    def sample_beta(self, key):
        return self.dist.sample(key, (self.d,))

    def log_prob_beta(self, beta):
        return jnp.sum(self.dist.log_prob(beta))

    def coord_log_prob(self, beta, j, b):
        del beta, j
        return self.dist.log_prob(b)

    def mean_beta(self):
        return jnp.full((self.d,), self.dist.mean())

    def cov_beta(self):
        return jnp.eye(self.d) * self.dist.variance()


class StackedPrior(BetaPrior):
    """Independent, per-coordinate marginal priors — the reference's
    list-of-priors form (R/mcmcglm.R:200-206), with the *correct* density
    sum_j log f_j(beta_j) (the reference's is buggy, R/glm_utils.R:113-115;
    SURVEY.md §7.3)."""

    def __init__(self, dists: Sequence[Distribution]):
        self.dists = list(dists)
        self.d = len(self.dists)

    def sample_beta(self, key):
        keys = jax.random.split(key, self.d)
        return jnp.stack([d.sample(k, ()) for d, k in zip(self.dists, keys)])

    def log_prob_beta(self, beta):
        return sum(d.log_prob(beta[i]) for i, d in enumerate(self.dists))

    def coord_log_prob(self, beta, j, b):
        del beta
        # j may be traced (scan over coordinates): evaluate every marginal at
        # b and select.  O(d) tiny ops — lists of heterogeneous priors are a
        # small-d feature; use IIDPrior for large d.
        vals = jnp.stack([d.log_prob(b) for d in self.dists])
        return vals[j]

    def mean_beta(self):
        return jnp.asarray([d.mean() for d in self.dists])

    def cov_beta(self):
        return jnp.diag(jnp.asarray([d.variance() for d in self.dists]))


class MVNPrior(BetaPrior):
    """Multivariate-normal prior on beta (vignettes/pospkg.Rmd:224-236).

    ``coord_log_prob`` uses the identity: with P = cov^{-1}, r = beta - mu,
    the quadratic form as a function of r_j = b - mu_j is
        -(1/2) [ P_jj r_j^2 + 2 r_j q_j ] + const,
    where q_j = (P r)_j - P_jj r_j uses the *current* beta — one O(d) row
    gather per coordinate instead of the reference's full-vector density at
    every slice evaluation (R/glm_utils.R:214-215).
    """

    def __init__(self, loc, cov):
        self.mvn = MultivariateNormal(loc, cov)
        self.loc = self.mvn.loc
        self.cov = self.mvn.cov
        self.d = int(self.loc.shape[-1])
        self.precision = jnp.linalg.inv(self.cov)

    def sample_beta(self, key):
        return self.mvn.sample(key)

    def log_prob_beta(self, beta):
        return self.mvn.log_prob(beta)

    def coord_log_prob(self, beta, j, b):
        dtype = jnp.result_type(beta, jnp.float32)
        P = self.precision.astype(dtype)
        mu = self.loc.astype(dtype)
        r = beta - mu
        p_row = P[j]  # dynamic row gather, O(d)
        p_jj = p_row[j]
        q_j = jnp.dot(p_row, r, precision=lax.Precision.HIGHEST) - p_jj * r[j]
        rj = b - mu[j]
        return -0.5 * p_jj * rj * rj - rj * q_j

    def mean_beta(self):
        return self.loc

    def cov_beta(self):
        return self.cov


def make_beta_prior(spec, d: int) -> BetaPrior:
    """Normalise a user prior spec into a BetaPrior.

    Accepts: a univariate :class:`Distribution` (applied iid over the d
    coordinates), a sequence of d univariate distributions (per-coordinate
    marginals), a :class:`MultivariateNormal`, or an existing
    :class:`BetaPrior`.  Mirrors the reference's beta_prior handling at
    R/mcmcglm.R:200-213.
    """
    if isinstance(spec, BetaPrior):
        if spec.d != d:
            raise ValueError(
                f"beta_prior dimension {spec.d} does not match number of model parameters {d}"
            )
        return spec
    if isinstance(spec, MultivariateNormal):
        if spec.loc.shape[-1] != d:
            raise ValueError(
                "The multivariate normal `beta_prior` dimension needs to match the "
                "number of parameters in the model (potentially including intercept)"
            )
        return MVNPrior(spec.loc, spec.cov)
    if isinstance(spec, Distribution):
        return IIDPrior(spec, d)
    if isinstance(spec, (list, tuple)):
        if len(spec) != d:
            # message parity with reference: R/mcmcglm.R:202
            raise ValueError(
                "The list length of the `beta_prior` specification needs to match "
                "the number of parameters in the model (potentially including intercept)"
            )
        return StackedPrior(spec)
    raise TypeError(f"cannot interpret beta_prior spec of type {type(spec)!r}")
