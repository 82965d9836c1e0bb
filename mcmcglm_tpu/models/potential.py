"""The log-potential engine: likelihood + prior as a function of one coordinate.

Re-design of the reference's model math layer
(R/glm_utils.R:93-218):

  * :func:`update_linear_predictor` — the O(n) incremental eta update, THE
    CGGibbs trick (reference: R/glm_utils.R:126-132).
  * :func:`log_likelihood` — sum of per-observation log densities
    (reference: R/glm_utils.R:93-99).
  * :func:`log_potential_from_betaj` — the slice-sampling target: likelihood
    of eta after the coordinate change plus the full prior density
    (reference: R/glm_utils.R:187-218), with both the "update" and "naive"
    linear-predictor calculations (R/glm_utils.R:200-208).
  * :func:`make_coord_target` — the *hot-path* form used by the engine: a
    relative log potential
        g(b) = sum_i [ld_i(eta_i + x_ij (b - beta_j)) - ld_i(eta_i)]
               + prior_j(b) - prior_j(beta_j)
    with g(beta_j) = 0 by construction.  Evaluating differences of
    per-observation log densities keeps every compared quantity O(1) in
    magnitude, so float32 — the engine's working dtype — retains ~1e-6 absolute
    precision where an absolute log likelihood of order -1e4 would have only
    ~1e-3.  This is what lets the slice accept/reject comparisons run
    entirely in f32 on the device without float64 emulation.

The per-observation current log densities ``ld_cur`` are cached once per
coordinate update and reused across all slice evaluations of that
coordinate, so each evaluation is a single fused elementwise pass + one
reduction over the observation axis — which the sharded engine turns into a
shard-local reduction + psum over the observation mesh axis.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import jax.numpy as jnp
from jax import lax

from .families import Family, check_family
from .priors import BetaPrior

__all__ = [
    "log_density",
    "update_linear_predictor",
    "log_likelihood",
    "log_potential_from_betaj",
    "make_coord_target",
]


def log_density(family, mu, y, **extra):
    """Per-observation log density dispatched on the family — parity with
    the reference's exported S3 generic (R/glm_utils.R:24-57)."""
    return check_family(family).log_density_mu(mu, y, extra)


def update_linear_predictor(new_beta_j, current_beta_j, current_eta, x_j):
    """eta' = eta + x_j * (new_beta_j - current_beta_j): n actions instead of
    the n*d of a full matvec (reference: R/glm_utils.R:126-132)."""
    return current_eta + x_j * (new_beta_j - current_beta_j)


def log_likelihood(family, mu, y, extra=None):
    """Sum of log densities over observations (reference: R/glm_utils.R:93-99)."""
    family = check_family(family)
    return family.log_likelihood(mu, y, extra)


def log_potential_from_betaj(
    new_beta_j,
    j,
    current_beta,
    current_eta,
    y,
    X,
    family,
    beta_prior: BetaPrior,
    linear_predictor_calc: str = "update",
    extra: Optional[Mapping] = None,
):
    """Absolute log potential after setting coordinate j to ``new_beta_j``.

    Parity function for the reference's exported ``log_potential_from_betaj``
    (R/glm_utils.R:187-218): incremental ("update") or full-matvec ("naive")
    linear predictor, then log likelihood + full log prior density.
    """
    family = check_family(family)
    new_beta = current_beta.at[j].set(new_beta_j)
    if linear_predictor_calc == "update":
        new_eta = update_linear_predictor(
            new_beta_j, current_beta[j], current_eta, X[:, j]
        )
    elif linear_predictor_calc == "naive":
        new_eta = jnp.matmul(X, new_beta, precision=lax.Precision.HIGHEST)
    else:
        raise ValueError("linear_predictor_calc must be 'update' or 'naive'")
    ll = jnp.sum(family.log_density_eta(new_eta, y, extra), axis=-1)
    lp = beta_prior.log_prob_beta(new_beta)
    return ll + lp


def make_coord_target(
    family: Family,
    beta_prior: BetaPrior,
    y,
    extra: Optional[Mapping] = None,
    reduce_fn: Callable = lambda t: jnp.sum(t, axis=-1),
):
    """Build the relative coordinate target factory used by the CGGibbs engine.

    Returns ``target_factory(beta, eta, ld_cur, x_j, j)`` which yields a
    callable ``g(b)`` with ``g(beta[j]) == 0``:

        g(b) = reduce(ld_eta(eta + x_j*(b - beta[j])) - ld_cur)
               + prior.coord_log_prob(beta, j, b) - prior.coord_log_prob(beta, j, beta[j])

    ``ld_cur`` is the cached vector of per-observation log densities at the
    current eta.  ``reduce_fn`` is the observation-axis reduction; the
    sharded engine passes a psum-ed version so the same code runs under
    shard_map over the observation mesh axis.
    """
    extra = dict(extra or {})

    def target_factory(beta, eta, ld_cur, x_j, j):
        beta_j = beta[j]
        lp_cur = beta_prior.coord_log_prob(beta, j, beta_j)

        def g(b):
            eta_new = eta + x_j * (b - beta_j)
            dll = reduce_fn(family.log_density_eta(eta_new, y, extra) - ld_cur)
            dlp = beta_prior.coord_log_prob(beta, j, b) - lp_cur
            return dll + dlp

        return g

    return target_factory
