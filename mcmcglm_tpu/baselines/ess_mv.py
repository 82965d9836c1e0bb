"""Multivariate elliptical slice sampler on the shared GLM posterior.

The whole-vector counterpart of the univariate kernels (qslice ships
``slice_elliptical_mv``; Murray, Adams & MacKay 2010): for a gaussian prior
beta ~ N(mu0, Sigma0), each update draws an auxiliary nu ~ N(mu0, Sigma0)
and slices the LIKELIHOOD along the ellipse

    beta(theta) = (beta - mu0) cos(theta) + (nu - mu0) sin(theta) + mu0.

Device-friendly trick: the likelihood needs eta(theta) = X beta(theta), and the
ellipse is linear in beta — so

    eta(theta) = eta_beta cos(theta) + eta_nu sin(theta) + eta_mu0 terms,

meaning ONE matvec per update (for the freshly drawn nu) and pure
elementwise (C, n) combinations per slice evaluation.  Each evaluation is
matmul-free and memory-light; the d-dimensional update costs O(matvec + evals*n)
instead of the CGGibbs sweep's O(d * evals * n).  Mixing per update is
lower than a full Gibbs sweep (one ellipse vs d conditionals), so which
engine wins in ESS/s is problem-dependent — expose both and measure.

Valid for ANY likelihood; requires a gaussian (iid-normal or MVN) prior.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..models.families import check_family
from ..models.priors import IIDPrior, MVNPrior, Normal
from ..utils.linalg import matvec

__all__ = ["EllipticalSliceGLM"]


class ESSState(NamedTuple):
    beta: jax.Array  # (d,) per chain
    eta: jax.Array  # (n,) per chain — X beta, carried
    key: jax.Array


class EllipticalSliceGLM:
    """Whole-vector elliptical slice sampling for GLMs with gaussian priors."""

    def __init__(
        self,
        X,
        y,
        family,
        prior,
        extra: Optional[Mapping] = None,
        max_shrink: int = 64,
        dtype=jnp.float32,
    ):
        self.family = check_family(family)
        if isinstance(prior, IIDPrior) and isinstance(prior.dist, Normal):
            self._mu0 = jnp.full((prior.d,), prior.dist.loc, dtype)
            self._chol = jnp.eye(prior.d, dtype=dtype) * prior.dist.scale
            self._diag_chol = True
        elif isinstance(prior, MVNPrior):
            self._mu0 = jnp.asarray(prior.loc, dtype)
            self._chol = jnp.linalg.cholesky(jnp.asarray(prior.cov, dtype))
            self._diag_chol = False
        else:
            raise ValueError(
                "EllipticalSliceGLM requires a gaussian prior "
                "(IIDPrior(Normal) or MVNPrior)"
            )
        self.prior = prior
        X = jnp.asarray(X, dtype)
        self.n, self.d = X.shape
        self.Xt = jnp.asarray(X.T)
        self.y = jnp.asarray(y, dtype).reshape(-1)
        self.extra = {k: jnp.asarray(v, dtype) for k, v in dict(extra or {}).items()}
        self.dtype = dtype
        self.max_shrink = max_shrink
        self._eta_mu0 = matvec(self._mu0, self.Xt)
        self._run_cache: dict = {}
        self._init_jit = jax.jit(jax.vmap(self._init_one))

    def _loglik(self, eta):
        return jnp.sum(self.family.log_density_eta(eta, self.y, self.extra), axis=-1)

    def _init_one(self, key):
        k1, k2 = jax.random.split(key)
        beta = jnp.asarray(self.prior.sample_beta(k1), self.dtype)
        eta = matvec(beta, self.Xt)
        return ESSState(beta, eta, k2)

    def init(self, key, n_chains: int) -> ESSState:
        return self._init_jit(jax.random.split(key, n_chains))

    def _update(self, state: ESSState, _):
        beta, eta, key = state
        key, k_nu, k_level, k_theta, k_shrink = jax.random.split(key, 5)
        # auxiliary draw and its linear predictor (the single matvec)
        z = jax.random.normal(k_nu, (self.d,), self.dtype)
        nu_c = jnp.matmul(z, self._chol.T,
                          precision=lax.Precision.HIGHEST)  # nu - mu0
        eta_nu = matvec(nu_c, self.Xt)
        beta_c = beta - self._mu0
        eta_c = eta - self._eta_mu0

        ll0 = self._loglik(eta)
        level = ll0 - jax.random.exponential(k_level, (), self.dtype)

        two_pi = jnp.asarray(2.0 * math.pi, self.dtype)
        theta0 = jax.random.uniform(k_theta, (), self.dtype) * two_pi
        lo0, hi0 = theta0 - two_pi, theta0

        def point(theta):
            c, s = jnp.cos(theta), jnp.sin(theta)
            return (
                beta_c * c + nu_c * s + self._mu0,
                eta_c * c + eta_nu * s + self._eta_mu0,
            )

        def cond(c):
            return (~c[4]) & (c[5] < self.max_shrink)

        def body(c):
            lo, hi, theta, _, _, it, key = c
            b1, e1 = point(theta)
            ok = self._loglik(e1) >= level
            lo = jnp.where((~ok) & (theta < 0), theta, lo)
            hi = jnp.where((~ok) & (theta >= 0), theta, hi)
            key, sub = jax.random.split(key)
            theta_new = lo + (hi - lo) * jax.random.uniform(sub, (), self.dtype)
            return (lo, hi, theta_new, theta, ok, it + 1, key)

        lo, hi, _, theta_acc, ok, n_evals, _ = lax.while_loop(
            cond, body,
            (lo0, hi0, theta0, jnp.zeros((), self.dtype), jnp.asarray(False),
             jnp.zeros((), jnp.int32), k_shrink),
        )
        b_new, e_new = point(theta_acc)
        beta = jnp.where(ok, b_new, beta)
        eta = jnp.where(ok, e_new, eta)
        return ESSState(beta, eta, key), (beta, n_evals)

    def _run_one(self, state, n_steps):
        state, (betas, nev) = lax.scan(self._update, state, None, length=n_steps)
        return state, betas, nev

    def run(self, state: ESSState, n_steps: int):
        from functools import partial

        fn = self._run_cache.get(n_steps)
        if fn is None:
            fn = jax.jit(jax.vmap(partial(self._run_one, n_steps=n_steps)))
            self._run_cache[n_steps] = fn
        return fn(state)

    def sample(self, key, n_samples: int, n_chains: int = 1, chunk_size: int = 0):
        state = self.init(key, n_chains)
        if chunk_size <= 0:
            chunk_size = n_samples
        parts, nevs, done = [], [], 0
        while done < n_samples:
            step = min(chunk_size, n_samples - done)
            state, betas, nev = self.run(state, step)
            parts.append(np.asarray(betas))
            nevs.append(np.asarray(nev))
            done += step
        return np.concatenate(parts, 1), np.concatenate(nevs, 1), state
