"""Link functions for GLM families.

Re-design of R's ``stats::make.link`` machinery used by the
reference via ``family$linkinv`` (reference: R/mcmcglm.R:216,269 and
R/glm_utils.R:210).  Each link is a pure-JAX pair ``(link, linkinv)`` usable
inside ``jit``/``vmap``/``scan``; inverse links are written in numerically
stable forms (logits evaluated via sigmoid/softplus, probit via erfc-based
normal CDF) so that float32 — the engine's working dtype — is sufficient.

Reference parity: the links exercised by the reference docs are identity,
logit, probit and log (vignettes/pospkg.Rmd:100-107, customising.Rmd:53-56);
we provide the full ``stats`` link set.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["Link", "get_link", "register_link", "LINKS"]


@dataclasses.dataclass(frozen=True)
class Link:
    """A GLM link function g with its inverse g^{-1}.

    Attributes:
      name: canonical R name of the link ("identity", "logit", ...).
      link: g(mu) -> eta.
      linkinv: g^{-1}(eta) -> mu  (the hot-path function; reference uses
        ``family$linkinv`` at R/glm_utils.R:210).
      mu_eta: d mu / d eta — derivative of the inverse link, used by the
        HMC/NUTS baselines for gradient sanity checks.
    """

    name: str
    link: Callable[[jax.Array], jax.Array]
    linkinv: Callable[[jax.Array], jax.Array]
    mu_eta: Callable[[jax.Array], jax.Array]

    def __call__(self, eta: jax.Array) -> jax.Array:
        return self.linkinv(eta)


def _logit(mu):
    return jnp.log(mu) - jnp.log1p(-mu)


def _expit(eta):
    return jax.nn.sigmoid(eta)


def _probit_inv(eta):
    # Phi(eta) via erfc for tail stability in f32.
    return 0.5 * jax.lax.erfc(-eta / jnp.sqrt(jnp.asarray(2.0, eta.dtype)))


def _probit(mu):
    return jnp.sqrt(jnp.asarray(2.0, mu.dtype)) * jax.lax.erf_inv(2.0 * mu - 1.0)


def _cloglog_inv(eta):
    # 1 - exp(-exp(eta)), clamped away from {0, 1} like R's make.link does
    # with .Machine$double.eps; we clamp at the dtype's epsilon.
    eps = jnp.finfo(eta.dtype).eps
    return jnp.clip(-jnp.expm1(-jnp.exp(eta)), eps, 1.0 - eps)


def _cauchit_inv(eta):
    return 0.5 + jnp.arctan(eta) / jnp.pi


LINKS: dict[str, Link] = {}


def register_link(link: Link) -> Link:
    """Register a link under its name; mirrors the extensibility story of
    R ``make.link`` (users may add custom links; customising.Rmd:27-31)."""
    LINKS[link.name] = link
    return link


def get_link(name_or_link: "str | Link") -> Link:
    if isinstance(name_or_link, Link):
        return name_or_link
    try:
        return LINKS[name_or_link]
    except KeyError:
        raise ValueError(
            f"unknown link {name_or_link!r}; known: {sorted(LINKS)}"
        ) from None


register_link(
    Link("identity", lambda mu: mu, lambda eta: eta, lambda eta: jnp.ones_like(eta))
)
register_link(
    Link(
        "log",
        jnp.log,
        jnp.exp,
        jnp.exp,
    )
)
register_link(
    Link(
        "logit",
        _logit,
        _expit,
        lambda eta: _expit(eta) * (1.0 - _expit(eta)),
    )
)
register_link(
    Link(
        "probit",
        _probit,
        _probit_inv,
        lambda eta: jnp.exp(-0.5 * eta * eta)
        / jnp.sqrt(2.0 * jnp.pi).astype(eta.dtype if hasattr(eta, "dtype") else jnp.float32),
    )
)
register_link(
    Link(
        "cloglog",
        lambda mu: jnp.log(-jnp.log1p(-mu)),
        _cloglog_inv,
        lambda eta: jnp.exp(eta - jnp.exp(eta)),
    )
)
register_link(
    Link(
        "inverse",
        lambda mu: 1.0 / mu,
        lambda eta: 1.0 / eta,
        lambda eta: -1.0 / (eta * eta),
    )
)
register_link(
    Link(
        "1/mu^2",
        lambda mu: 1.0 / (mu * mu),
        lambda eta: jax.lax.rsqrt(eta),
        lambda eta: -0.5 * eta ** (-1.5),
    )
)
register_link(
    Link(
        "sqrt",
        jnp.sqrt,
        lambda eta: eta * eta,
        lambda eta: 2.0 * eta,
    )
)
register_link(
    Link(
        "cauchit",
        lambda mu: jnp.tan(jnp.pi * (mu - 0.5)),
        _cauchit_inv,
        lambda eta: 1.0 / (jnp.pi * (1.0 + eta * eta)),
    )
)
