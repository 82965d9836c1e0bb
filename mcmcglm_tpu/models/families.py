"""Exponential-family response distributions for the GLM engine.

JAX re-design of the reference's S3 ``log_density`` dispatch
(reference: R/glm_utils.R:24-57) and of R ``stats::family`` objects
(reference: R/family_data_processing.R:3-16).  A :class:`Family` bundles

  * a per-observation log-density ``log_density(mu, y, extra)`` parametrised
    by the GLM mean ``mu`` (matching the reference's parametrisation,
    R/glm_utils.R:8-19), and
  * a :class:`~mcmcglm_tpu.models.links.Link`,
  * an optional *fused* per-observation log-density ``log_density_eta``
    evaluated directly from the linear predictor ``eta``.  The fused
    path matters twice over: it is more numerically stable in float32
    (e.g. Bernoulli/logit via softplus instead of log(sigmoid)) and it lets
    XLA fuse linkinv into the likelihood kernel so the (chains × n) slice
    evaluation does a single pass over the device-resident eta.

Supported out of the box: gaussian, binomial (Bernoulli), poisson,
negative binomial, inverse gaussian — the set used across the reference's
docs (R/glm_utils.R:40-57 plus customising.Rmd:53-68).  New families are a
single ``register_family`` call, mirroring the reference's "implement your
own S3 method" extension recipe (R/glm_utils.R:14-15, customising.Rmd:27-31).

Parity notes (deliberate decisions, see SURVEY.md §7):
  * the reference's negative-binomial method hardcodes ``size = 1``
    (R/glm_utils.R:55-57) even when the family was built with a different
    theta; we default ``size=1`` for parity but honour a user-passed
    ``size`` in ``log_likelihood_extra_args``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Optional

import jax
import jax.numpy as jnp

from .links import Link, get_link

__all__ = [
    "Family",
    "register_family",
    "check_family",
    "gaussian",
    "binomial",
    "poisson",
    "negative_binomial",
    "gamma",
    "inverse_gaussian",
    "FAMILIES",
]

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class Family:
    """A GLM response family bound to a link.

    ``log_density(mu, y, extra)`` returns the per-observation log density —
    the analogue of the reference's ``log_density.<family>`` S3 methods
    (R/glm_utils.R:40-57).  ``extra`` carries nuisance parameters exactly like
    the reference's ``log_likelihood_extra_args`` channel (R/mcmcglm.R:151,
    R/glm_utils.R:40-42), e.g. ``{"sd": 1.0}`` for gaussian.
    """

    name: str
    link: Link
    log_density: Callable[[jax.Array, jax.Array, Mapping[str, jax.Array]], jax.Array]
    # Optional fused eta->logdensity fast paths, keyed by link name.
    _eta_paths: Mapping[str, Callable] = dataclasses.field(default_factory=dict)
    # Optional RELATIVE log densities — equal to the absolute ones up to a
    # per-observation constant that does not depend on eta.  Samplers that
    # only ever compare log densities at different eta (slice comparisons,
    # MH ratios) can use these: the constants cancel exactly.  Terms like
    # lgamma(y + 1) are the most expensive transcendentals in the density,
    # and Pallas' Triton route has no lgamma lowering, so the relative
    # form is also what a fused kernel would need.
    _eta_rel_paths: Mapping[str, Callable] = dataclasses.field(default_factory=dict)
    log_density_rel: Optional[Callable] = None  # mu-parametrised relative form

    @property
    def linkinv(self) -> Callable[[jax.Array], jax.Array]:
        return self.link.linkinv

    def log_density_mu(self, mu, y, extra=None):
        return self.log_density(mu, y, dict(extra or {}))

    def log_density_eta(self, eta, y, extra=None):
        """Per-observation log density as a function of the linear predictor.

        Uses the fused stable path when one is registered for this family's
        link; otherwise composes ``log_density(linkinv(eta))`` — semantically
        the reference's two-step mu = linkinv(eta); log_density(mu)
        (R/glm_utils.R:210-212).
        """
        extra = dict(extra or {})
        fused = self._eta_paths.get(self.link.name)
        if fused is not None:
            return fused(eta, y, extra)
        return self.log_density(self.link.linkinv(eta), y, extra)

    def log_density_eta_rel(self, eta, y, extra=None):
        """Per-observation log density as a function of eta, UP TO an
        eta-independent additive constant per observation.

        Exact for any use that only ever DIFFERENCES log densities across
        eta values (slice-sampling comparisons: the committed-state cache
        and every proposal share the constants, which cancel).  Falls back
        to the absolute form when no relative path is registered — always
        correct, possibly slower / not Pallas-lowerable."""
        extra = dict(extra or {})
        rel = self._eta_rel_paths.get(self.link.name)
        if rel is not None:
            return rel(eta, y, extra)
        if self.log_density_rel is not None:
            return self.log_density_rel(self.link.linkinv(eta), y, extra)
        return self.log_density_eta(eta, y, extra)

    def log_likelihood(self, mu, y, extra=None):
        """Sum of log densities over observations (R/glm_utils.R:93-99)."""
        return jnp.sum(self.log_density_mu(mu, y, extra), axis=-1)

    def with_link(self, link) -> "Family":
        return dataclasses.replace(self, link=get_link(link))


# Registry: family name -> factory(link=...) -> Family.  The string/callable/
# object normalisation mirrors the reference's check_family
# (R/family_data_processing.R:3-16).
FAMILIES: dict[str, Callable[..., Family]] = {}


def register_family(name: str, factory: Callable[..., Family]) -> None:
    FAMILIES[name] = factory


def check_family(family) -> Family:
    """Normalise a family given as string / factory / Family instance.

    Mirrors reference ``check_family`` (R/family_data_processing.R:3-16):
    a character string is looked up, a function is called, a family object
    passes through.
    """
    if isinstance(family, str):
        key = family.strip()
        if key not in FAMILIES:
            raise ValueError(f"'family' not recognized: {family!r}; known: {sorted(FAMILIES)}")
        return FAMILIES[key]()
    if isinstance(family, Family):
        return family
    if callable(family):
        out = family()
        if not isinstance(out, Family):
            raise ValueError("'family' not recognized")
        return out
    raise ValueError("'family' not recognized")


# --------------------------------------------------------------------------
# Gaussian  (reference: R/glm_utils.R:40-42, dnorm(Y, mean=mu, sd=sd, log=T))
# --------------------------------------------------------------------------

def _gaussian_logpdf(mu, y, extra):
    sd = jnp.asarray(extra.get("sd", 1.0), dtype=jnp.result_type(mu))
    z = (y - mu) / sd
    return -0.5 * z * z - jnp.log(sd) - 0.5 * jnp.asarray(_LOG_2PI, jnp.result_type(mu))


def _gaussian_rel(mu, y, extra):
    # drop -log(sd) - 0.5*log(2*pi): eta-independent per observation
    sd = jnp.asarray(extra.get("sd", 1.0), dtype=jnp.result_type(mu))
    z = (y - mu) / sd
    return -0.5 * z * z


def gaussian(link="identity") -> Family:
    return Family(
        name="gaussian",
        link=get_link(link),
        log_density=_gaussian_logpdf,
        _eta_paths={"identity": lambda eta, y, extra: _gaussian_logpdf(eta, y, extra)},
        _eta_rel_paths={"identity": lambda eta, y, extra: _gaussian_rel(eta, y, extra)},
        log_density_rel=_gaussian_rel,
    )


# --------------------------------------------------------------------------
# Binomial / Bernoulli  (reference: R/glm_utils.R:45-47,
#   dbinom(Y, size=1, prob=mu, log=T))
# --------------------------------------------------------------------------

def _bernoulli_logpdf(mu, y, extra):
    # y*log(mu) + (1-y)*log(1-mu); clamp for f32 safety away from {0,1}.
    eps = jnp.finfo(jnp.result_type(mu)).tiny
    mu = jnp.clip(mu, eps, 1.0 - jnp.finfo(jnp.result_type(mu)).eps)
    return y * jnp.log(mu) + (1.0 - y) * jnp.log1p(-mu)


def _bernoulli_logit_eta(eta, y, extra):
    # log p = y*eta - log(1 + exp(eta)) — a single softplus; exact & stable.
    return y * eta - jax.nn.softplus(eta)


def _bernoulli_probit_eta(eta, y, extra):
    # log Phi(eta) for y=1, log Phi(-eta) for y=0 via the stable log-ndtr.
    logcdf = jax.scipy.stats.norm.logcdf
    return jnp.where(y > 0.5, logcdf(eta), logcdf(-eta))


def _bernoulli_cloglog_eta(eta, y, extra):
    # mu = 1 - exp(-exp(eta)): log(1-mu) = -exp(eta); log(mu) = log(1 - exp(-ex)).
    # Direct form for ex > 1e-3; the series log(ex) - ex/2 + O(ex^2) =
    # eta - ex/2 below, where the direct f32 form loses precision.
    dtype = jnp.result_type(eta)
    ex = jnp.exp(eta)
    tiny = jnp.finfo(dtype).tiny
    log_mu = jnp.where(
        ex > 1e-3,
        jnp.log(jnp.maximum(1.0 - jnp.exp(-ex), tiny)),
        eta - 0.5 * ex,
    )
    return jnp.where(y > 0.5, log_mu, -ex)


def binomial(link="logit") -> Family:
    return Family(
        name="binomial",
        link=get_link(link),
        log_density=_bernoulli_logpdf,
        _eta_paths={
            "logit": _bernoulli_logit_eta,
            "probit": _bernoulli_probit_eta,
            "cloglog": _bernoulli_cloglog_eta,
        },
        # Bernoulli log densities have no eta-independent terms to drop
        _eta_rel_paths={
            "logit": _bernoulli_logit_eta,
            "cloglog": _bernoulli_cloglog_eta,
        },
    )


# --------------------------------------------------------------------------
# Poisson  (reference: R/glm_utils.R:50-52, dpois(Y, lambda=mu, log=T))
# --------------------------------------------------------------------------

def _poisson_logpdf(mu, y, extra):
    eps = jnp.finfo(jnp.result_type(mu)).tiny
    mu = jnp.maximum(mu, eps)
    return y * jnp.log(mu) - mu - jax.lax.lgamma(y + 1.0)


def _poisson_log_eta(eta, y, extra):
    # mu = exp(eta): log p = y*eta - exp(eta) - lgamma(y+1)
    return y * eta - jnp.exp(eta) - jax.lax.lgamma(y + 1.0)


def _poisson_log_eta_rel(eta, y, extra):
    # drop lgamma(y + 1): eta-independent
    return y * eta - jnp.exp(eta)


def _poisson_rel(mu, y, extra):
    eps = jnp.finfo(jnp.result_type(mu)).tiny
    mu = jnp.maximum(mu, eps)
    return y * jnp.log(mu) - mu


def poisson(link="log") -> Family:
    return Family(
        name="poisson",
        link=get_link(link),
        log_density=_poisson_logpdf,
        _eta_paths={"log": _poisson_log_eta},
        _eta_rel_paths={"log": _poisson_log_eta_rel},
        log_density_rel=_poisson_rel,
    )


# --------------------------------------------------------------------------
# Negative binomial  (reference: R/glm_utils.R:55-57,
#   dnbinom(Y, size=1, mu=mu, log=T) — note the reference hardcodes size=1)
# --------------------------------------------------------------------------

def _negbin_logpdf(mu, y, extra):
    r = jnp.asarray(extra.get("size", 1.0), dtype=jnp.result_type(mu))
    eps = jnp.finfo(jnp.result_type(mu)).tiny
    mu = jnp.maximum(mu, eps)
    return (
        jax.lax.lgamma(y + r)
        - jax.lax.lgamma(r)
        - jax.lax.lgamma(y + 1.0)
        + r * (jnp.log(r) - jnp.log(r + mu))
        + y * (jnp.log(mu) - jnp.log(r + mu))
    )


def _negbin_log_eta(eta, y, extra):
    # mu = exp(eta): log(r + mu) = log(r) + softplus(eta - log r) — stable.
    r = jnp.asarray(extra.get("size", 1.0), dtype=jnp.result_type(eta))
    log_r = jnp.log(r)
    log_r_plus_mu = log_r + jax.nn.softplus(eta - log_r)
    return (
        jax.lax.lgamma(y + r)
        - jax.lax.lgamma(r)
        - jax.lax.lgamma(y + 1.0)
        + r * (log_r - log_r_plus_mu)
        + y * (eta - log_r_plus_mu)
    )


def _negbin_log_eta_rel(eta, y, extra):
    # drop lgamma(y+r) - lgamma(r) - lgamma(y+1): all eta-independent.
    r = jnp.asarray(extra.get("size", 1.0), dtype=jnp.result_type(eta))
    log_r = jnp.log(r)
    log_r_plus_mu = log_r + jax.nn.softplus(eta - log_r)
    return r * (log_r - log_r_plus_mu) + y * (eta - log_r_plus_mu)


def _negbin_rel(mu, y, extra):
    r = jnp.asarray(extra.get("size", 1.0), dtype=jnp.result_type(mu))
    eps = jnp.finfo(jnp.result_type(mu)).tiny
    mu = jnp.maximum(mu, eps)
    return r * (jnp.log(r) - jnp.log(r + mu)) + y * (jnp.log(mu) - jnp.log(r + mu))


def negative_binomial(link="log") -> Family:
    return Family(
        name="negative.binomial",
        link=get_link(link),
        log_density=_negbin_logpdf,
        _eta_paths={"log": _negbin_log_eta},
        _eta_rel_paths={"log": _negbin_log_eta_rel},
        log_density_rel=_negbin_rel,
    )


# --------------------------------------------------------------------------
# Gamma  (standard R family; not in the reference's method set but part of
# the stats::family universe its check_family accepts — completes coverage)
# --------------------------------------------------------------------------

def _gamma_logpdf(mu, y, extra):
    # shape k (R Gamma glm dispersion = 1/k); mean parametrisation:
    # f(y; mu, k) = (k/mu)^k y^(k-1) exp(-k y / mu) / Gamma(k)
    dtype = jnp.result_type(mu)
    k = jnp.asarray(extra.get("shape", 1.0), dtype)
    eps = jnp.finfo(dtype).tiny
    mu = jnp.maximum(mu, eps)
    return (
        k * (jnp.log(k) - jnp.log(mu))
        + (k - 1.0) * jnp.log(y)
        - k * y / mu
        - jax.lax.lgamma(k)
    )


def _gamma_log_eta(eta, y, extra):
    # mu = exp(eta): k(log k - eta) + (k-1) log y - k y exp(-eta) - lgamma(k)
    dtype = jnp.result_type(eta)
    k = jnp.asarray(extra.get("shape", 1.0), dtype)
    return (
        k * (jnp.log(k) - eta)
        + (k - 1.0) * jnp.log(y)
        - k * y * jnp.exp(-eta)
        - jax.lax.lgamma(k)
    )


def _gamma_log_eta_rel(eta, y, extra):
    # drop k*log(k) + (k-1)*log(y) - lgamma(k): eta-independent
    dtype = jnp.result_type(eta)
    k = jnp.asarray(extra.get("shape", 1.0), dtype)
    return -k * eta - k * y * jnp.exp(-eta)


def _gamma_rel(mu, y, extra):
    dtype = jnp.result_type(mu)
    k = jnp.asarray(extra.get("shape", 1.0), dtype)
    eps = jnp.finfo(dtype).tiny
    mu = jnp.maximum(mu, eps)
    return -k * jnp.log(mu) - k * y / mu


def gamma(link="inverse") -> Family:
    return Family(
        name="Gamma",
        link=get_link(link),
        log_density=_gamma_logpdf,
        _eta_paths={"log": _gamma_log_eta},
        _eta_rel_paths={"log": _gamma_log_eta_rel},
        log_density_rel=_gamma_rel,
    )


# --------------------------------------------------------------------------
# Inverse gaussian  (reference extension recipe: customising.Rmd:53-68,
#   statmod::dinvgauss(Y, mean=mu, shape, dispersion, log=T))
# --------------------------------------------------------------------------

def _invgauss_logpdf(mu, y, extra):
    # statmod parametrisation: dispersion phi (default 1), shape = 1/phi.
    # f(y; mu, phi) = (2 pi phi y^3)^{-1/2} exp(-(y-mu)^2 / (2 y phi mu^2))
    dtype = jnp.result_type(mu)
    if "shape" in extra and "dispersion" not in extra:
        phi = 1.0 / jnp.asarray(extra["shape"], dtype)
    else:
        phi = jnp.asarray(extra.get("dispersion", 1.0), dtype)
    eps = jnp.finfo(dtype).tiny
    mu = jnp.maximum(mu, eps)
    return (
        -0.5 * (jnp.log(phi) + jnp.asarray(_LOG_2PI, dtype) + 3.0 * jnp.log(y))
        - (y - mu) ** 2 / (2.0 * y * phi * mu * mu)
    )


def _invgauss_rel(mu, y, extra):
    # drop -0.5*(log(phi) + log(2*pi) + 3*log(y)): eta-independent
    dtype = jnp.result_type(mu)
    if "shape" in extra and "dispersion" not in extra:
        phi = 1.0 / jnp.asarray(extra["shape"], dtype)
    else:
        phi = jnp.asarray(extra.get("dispersion", 1.0), dtype)
    eps = jnp.finfo(dtype).tiny
    mu = jnp.maximum(mu, eps)
    return -((y - mu) ** 2) / (2.0 * y * phi * mu * mu)


def inverse_gaussian(link="1/mu^2") -> Family:
    return Family(
        name="inverse.gaussian",
        link=get_link(link),
        log_density=_invgauss_logpdf,
        log_density_rel=_invgauss_rel,
    )


register_family("Gamma", gamma)
register_family("gamma", gamma)
register_family("gaussian", gaussian)
register_family("binomial", binomial)
register_family("poisson", poisson)
register_family("negative.binomial", negative_binomial)
register_family("negative_binomial", negative_binomial)
register_family("inverse.gaussian", inverse_gaussian)
register_family("inverse_gaussian", inverse_gaussian)
