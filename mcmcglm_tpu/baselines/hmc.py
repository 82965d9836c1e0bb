"""Hamiltonian Monte Carlo baseline with windowed warmup adaptation.

Cross-validation sampler required by BASELINE.json: HMC on the same log
posterior as the CGGibbs engine.  Pure-JAX, scan-based, vmapped over chains;
the reference package has no gradient-based sampler at all (it exists to
benchmark Gibbs *against* HMC — the arXiv:2410.03630 question the package
is built around, R/mcmcglm.R:5-8 — so providing the HMC side natively
completes that comparison on the device).

Adaptation (Stan-flavoured, simplified to three windows):
  * dual averaging of the step size toward a target accept rate
    (Hoffman & Gelman 2014, Nesterov primal averaging);
  * diagonal mass matrix from a Welford estimate of posterior variances
    over the middle warmup window;
  * final step-size re-adaptation with the new metric.
Each vmapped chain adapts independently (per-lane scalars).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["hmc_sample", "HMCResult"]


class HMCResult(NamedTuple):
    samples: jax.Array  # (C, K, d)
    accept_rate: jax.Array  # (C,)
    step_size: jax.Array  # (C,)
    inv_mass: jax.Array  # (C, d)


class _DAState(NamedTuple):
    log_eps: jax.Array
    log_eps_avg: jax.Array
    h_avg: jax.Array
    mu: jax.Array
    t: jax.Array


def _da_init(eps0):
    return _DAState(
        log_eps=jnp.log(eps0),
        log_eps_avg=jnp.log(eps0),
        h_avg=jnp.zeros_like(eps0),
        mu=jnp.log(10.0 * eps0),
        t=jnp.zeros_like(eps0),
    )


def _da_update(state: _DAState, accept_prob, target=0.8):
    t = state.t + 1.0
    gamma, t0, kappa = 0.05, 10.0, 0.75
    h_avg = (1.0 - 1.0 / (t + t0)) * state.h_avg + (target - accept_prob) / (t + t0)
    log_eps = state.mu - jnp.sqrt(t) / gamma * h_avg
    eta = t ** (-kappa)
    log_eps_avg = eta * log_eps + (1.0 - eta) * state.log_eps_avg
    return _DAState(log_eps, log_eps_avg, h_avg, state.mu, t)


def _leapfrog(logpost_grad, z, r, eps, inv_mass, n_steps):
    # fori_loop: n_steps may be traced (jittered trajectory lengths)
    def step(_, carry):
        z, r = carry
        g = logpost_grad(z)[1]
        r = r + 0.5 * eps * g
        z = z + eps * (inv_mass * r)
        g = logpost_grad(z)[1]
        r = r + 0.5 * eps * g
        return (z, r)

    return lax.fori_loop(0, n_steps, step, (z, r))


def hmc_sample(
    key,
    logpost: Callable,
    init_beta,
    n_warmup: int = 500,
    n_samples: int = 500,
    num_leapfrog: int = 16,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    jitter_steps: bool = True,
) -> HMCResult:
    """Run vmapped HMC chains.

    init_beta: (C, d) initial positions (one per chain).
    Returns post-warmup samples (C, n_samples, d).
    """
    init_beta = jnp.atleast_2d(jnp.asarray(init_beta))
    C, d = init_beta.shape
    vg = jax.value_and_grad(logpost)

    def one_chain(key, z0):
        def hmc_step(z, key, eps, inv_mass, L):
            k_mom, k_acc = jax.random.split(key)
            r0 = jax.random.normal(k_mom, (d,), z.dtype) * lax.rsqrt(inv_mass)
            logp0 = vg(z)[0]
            ke0 = 0.5 * jnp.sum(inv_mass * r0 * r0)
            z1, r1 = _leapfrog(vg, z, r0, eps, inv_mass, L)
            logp1 = vg(z1)[0]
            ke1 = 0.5 * jnp.sum(inv_mass * r1 * r1)
            log_accept = (logp1 - ke1) - (logp0 - ke0)
            log_accept = jnp.where(jnp.isnan(log_accept), -jnp.inf, log_accept)
            accept_prob = jnp.minimum(1.0, jnp.exp(log_accept))
            accept = jnp.log(jax.random.uniform(k_acc, (), z.dtype)) < log_accept
            z_new = jnp.where(accept, z1, z)
            return z_new, accept_prob

        def jittered_L(key):
            if not jitter_steps:
                return num_leapfrog
            # uniform on [1, num_leapfrog] decorrelates trajectory lengths
            return jax.random.randint(key, (), 1, num_leapfrog + 1)

        # --- warmup window 1: step size only (25%)
        w1 = max(n_warmup // 4, 1)
        w2 = max(n_warmup // 2, 1)
        w3 = max(n_warmup - w1 - w2, 1)
        eps0 = jnp.asarray(init_step_size, z0.dtype)
        inv_mass0 = jnp.ones((d,), z0.dtype)

        def warm_step(carry, key):
            z, da, inv_mass, welford = carry
            kL, kS = jax.random.split(key)
            L = jittered_L(kL)
            z, ap = hmc_step(z, kS, jnp.exp(da.log_eps), inv_mass, L)
            da = _da_update(da, ap, target_accept)
            count, mean, m2 = welford
            count += 1.0
            delta = z - mean
            mean = mean + delta / count
            m2 = m2 + delta * (z - mean)
            return (z, da, inv_mass, (count, mean, m2)), None

        welford0 = (jnp.zeros((), z0.dtype), jnp.zeros((d,), z0.dtype), jnp.zeros((d,), z0.dtype))
        keys = jax.random.split(key, w1 + w2 + w3 + n_samples + 1)
        k1, k2, k3, ks, _ = (
            keys[:w1],
            keys[w1 : w1 + w2],
            keys[w1 + w2 : w1 + w2 + w3],
            keys[w1 + w2 + w3 : w1 + w2 + w3 + n_samples],
            keys[-1],
        )

        (z, da, inv_mass, _), _ = lax.scan(
            warm_step, (z0, _da_init(eps0), inv_mass0, welford0), k1
        )
        # --- window 2: step size + variance estimation
        (z, da, inv_mass, (cnt, mean, m2)), _ = lax.scan(
            warm_step, (z, _da_init(jnp.exp(da.log_eps_avg)), inv_mass, welford0), k2
        )
        var = m2 / jnp.maximum(cnt - 1.0, 1.0)
        # regularised diagonal metric (Stan's shrinkage toward unit)
        var = (cnt / (cnt + 5.0)) * var + 1e-3 * (5.0 / (cnt + 5.0))
        inv_mass = jnp.maximum(var, 1e-8)
        # --- window 3: re-adapt step size under the new metric
        (z, da, inv_mass, _), _ = lax.scan(
            warm_step, (z, _da_init(jnp.exp(da.log_eps_avg)), inv_mass, welford0), k3
        )
        eps_final = jnp.exp(da.log_eps_avg)

        def sample_step(carry, key):
            z = carry
            kL, kS = jax.random.split(key)
            L = jittered_L(kL)
            z, ap = hmc_step(z, kS, eps_final, inv_mass, L)
            return z, (z, ap)

        z, (draws, aps) = lax.scan(sample_step, z, ks)
        return draws, jnp.mean(aps), eps_final, inv_mass

    keys = jax.random.split(key, C)
    draws, acc, eps, inv_mass = jax.vmap(one_chain)(keys, init_beta)
    return HMCResult(draws, acc, eps, inv_mass)
