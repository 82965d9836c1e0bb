"""No-U-Turn Sampler baseline — iterative, recursion-free, accelerator-friendly.

Cross-validation sampler required by BASELINE.json ("NUTS/HMC ... baselines
on the same log-density").  The reference package exists to benchmark Gibbs
*against* NUTS/HMC (arXiv:2410.03630, cited at R/mcmcglm.R:5-8) but contains
no such sampler; this module provides the NUTS side natively.

Recursion-free tree building: XLA cannot express NUTS's recursive doubling,
so subtrees are built leaf-by-leaf with a checkpoint stack for the dyadic
U-turn checks.  The indexing scheme (derived independently; equivalent to
the iterative algorithm of Phan & Pradhan's NumPyro implementation):

  * a subtree's leaf ``m`` (0-based, even) becomes the LEFT endpoint of the
    dyadic intervals closing at later odd leaves; store its momentum and the
    momentum prefix-sum *before* it at checkpoint slot ``popcount(m)``
    (live left-endpoints always occupy distinct slots);
  * at odd leaf ``n`` the intervals [n+1-2^k, n] close for k = 1..tz(n+1);
    their left endpoints sit at the CONTIGUOUS slot range
    ``[popcount(n+1)-1, popcount(n+1)+tz(n+1)-2]`` — check each for a
    U-turn using (prefix_incl(n) - prefix_before(a)) as the interval's
    momentum sum.

Sampling is progressive-multinomial within subtrees and biased
(Stan-flavoured, min(1, W_new/W_old)) across the top-level merge.
Everything is bounded: the doubling loop by ``max_depth``, each subtree by
its 2^depth leaf budget, so the kernel vmaps over chains with masked lanes.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .hmc import _da_init, _da_update

__all__ = ["nuts_sample", "NUTSResult"]


class NUTSResult(NamedTuple):
    samples: jax.Array  # (C, K, d)
    accept_rate: jax.Array  # (C,)
    step_size: jax.Array  # (C,)
    inv_mass: jax.Array  # (C, d)
    mean_depth: jax.Array  # (C,)


def _popcount(n):
    return lax.population_count(n.astype(jnp.uint32)).astype(jnp.int32)


def _tz(n):
    """Trailing zero count of a positive int32."""
    n = n.astype(jnp.uint32)
    return lax.population_count(jnp.bitwise_and(~n, n - 1)).astype(jnp.int32)


def _nuts_kernel(key, z0, logpost_vg, eps, inv_mass, max_depth):
    d = z0.shape[-1]
    dtype = z0.dtype
    DIVERGENCE = 1000.0

    def ke(r):
        return 0.5 * jnp.sum(inv_mass * r * r)

    def uturn(sum_r, r_first, r_last):
        return (jnp.dot(sum_r, inv_mass * r_first) <= 0) | (
            jnp.dot(sum_r, inv_mass * r_last) <= 0
        )

    def leapfrog(z, r, step):
        g = logpost_vg(z)[1]
        r = r + 0.5 * step * g
        z = z + step * (inv_mass * r)
        logp, g = logpost_vg(z)
        r = r + 0.5 * step * g
        return z, r, logp

    k_mom, k_loop = jax.random.split(key)
    r0 = jax.random.normal(k_mom, (d,), dtype) * lax.rsqrt(inv_mass)
    logp0 = logpost_vg(z0)[0]
    e0 = logp0 - ke(r0)

    def build_subtree(key, z_start, r_start, step, n_leaves):
        """Simulate up to n_leaves leapfrog leaves; returns subtree ends,
        momentum sum, multinomial proposal, and flags."""
        ckpt_r0 = jnp.zeros((max_depth + 1, d), dtype)
        ckpt_pre0 = jnp.zeros((max_depth + 1, d), dtype)

        def cond(c):
            i, turning, diverging = c[0], c[-3], c[-2]
            return (i < n_leaves) & (~turning) & (~diverging)

        def body(c):
            (i, z, r, prefix, ckpt_r, ckpt_pre, z_prop, log_w, sum_acc,
             turning, diverging, key) = c
            key, k_take = jax.random.split(key)
            z, r, logp = leapfrog(z, r, step)
            dw = (logp - ke(r)) - e0
            dw = jnp.where(jnp.isnan(dw), -jnp.inf, dw)
            diverging = dw < -DIVERGENCE
            sum_acc = sum_acc + jnp.minimum(1.0, jnp.exp(dw))
            new_log_w = jnp.logaddexp(log_w, dw)
            take = jnp.log(jax.random.uniform(k_take, (), dtype)) < dw - new_log_w
            z_prop = jnp.where(take, z, z_prop)
            log_w = new_log_w

            is_even = (i % 2) == 0
            slot = _popcount(i)
            ckpt_r = jnp.where(
                is_even, ckpt_r.at[slot].set(r), ckpt_r
            )
            ckpt_pre = jnp.where(
                is_even, ckpt_pre.at[slot].set(prefix), ckpt_pre
            )
            prefix = prefix + r

            # odd leaf: dyadic intervals [i+1-2^k, i] close for k=1..tz(i+1)
            idx_min = _popcount(i + 1) - 1
            idx_max = idx_min + _tz(i + 1) - 1

            def check_slot(s, turning):
                active = (s >= idx_min) & (s <= idx_max) & (~is_even)
                seg_sum = prefix - ckpt_pre[s]
                return turning | (active & uturn(seg_sum, ckpt_r[s], r))

            turning = lax.fori_loop(0, max_depth + 1, check_slot, turning)
            return (i + 1, z, r, prefix, ckpt_r, ckpt_pre, z_prop, log_w,
                    sum_acc, turning, diverging, key)

        init = (
            jnp.int32(0), z_start, r_start, jnp.zeros((d,), dtype),
            ckpt_r0, ckpt_pre0, z_start, jnp.asarray(-jnp.inf, dtype),
            jnp.zeros((), dtype),
            jnp.asarray(False), jnp.asarray(False), key,
        )
        (i, z, r, prefix, _cr, _cp, z_prop, log_w, sum_acc,
         turning, diverging, _k) = lax.while_loop(cond, body, init)
        return dict(
            n=i, z_end=z, r_end=r, sum_r=prefix, z_prop=z_prop, log_w=log_w,
            sum_acc=sum_acc, turning=turning, diverging=diverging,
        )

    def doubling_cond(c):
        depth, done = c[0], c[-2]
        return (depth < max_depth) & (~done)

    def doubling_body(c):
        (depth, z_left, r_left, z_right, r_right, sum_r, z_prop, log_w,
         sum_acc, n_tot, done, key) = c
        key, k_dir, k_sub, k_acc = jax.random.split(key, 4)
        go_left = jax.random.uniform(k_dir, (), dtype) < 0.5
        step = jnp.where(go_left, -eps, eps)
        z_start = jnp.where(go_left, z_left, z_right)
        r_start = jnp.where(go_left, r_left, r_right)
        sub = build_subtree(k_sub, z_start, r_start, step, 2**depth)
        sub_ok = (~sub["turning"]) & (~sub["diverging"])

        # biased top-level merge (Stan): accept new proposal w.p. min(1, W_new/W_old)
        take = (
            jnp.log(jax.random.uniform(k_acc, (), dtype)) < sub["log_w"] - log_w
        ) & sub_ok
        z_prop = jnp.where(take, sub["z_prop"], z_prop)
        log_w = jnp.where(sub_ok, jnp.logaddexp(log_w, sub["log_w"]), log_w)
        sum_acc = sum_acc + sub["sum_acc"]
        n_tot = n_tot + sub["n"]

        z_left = jnp.where(sub_ok & go_left, sub["z_end"], z_left)
        r_left = jnp.where(sub_ok & go_left, sub["r_end"], r_left)
        z_right = jnp.where(sub_ok & (~go_left), sub["z_end"], z_right)
        r_right = jnp.where(sub_ok & (~go_left), sub["r_end"], r_right)
        # backward-built momenta enter the total sum with as-simulated sign
        sum_r = jnp.where(sub_ok, sum_r + sub["sum_r"], sum_r)
        tree_turning = uturn(sum_r, r_left, r_right)
        done = (~sub_ok) | tree_turning
        return (depth + 1, z_left, r_left, z_right, r_right, sum_r, z_prop,
                log_w, sum_acc, n_tot, done, key)

    init = (
        jnp.int32(0), z0, r0, z0, r0, r0, z0, jnp.zeros((), dtype),
        jnp.zeros((), dtype), jnp.int32(0), jnp.asarray(False), k_loop,
    )
    (depth, _zl, _rl, _zr, _rr, _sr, z_new, _lw, sum_acc, n_tot, _done,
     _key) = lax.while_loop(doubling_cond, doubling_body, init)
    accept_stat = sum_acc / jnp.maximum(n_tot.astype(dtype), 1.0)
    return z_new, accept_stat, depth, n_tot


def nuts_sample(
    key,
    logpost: Callable,
    init_beta,
    n_warmup: int = 500,
    n_samples: int = 500,
    max_depth: int = 8,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
) -> NUTSResult:
    """Run vmapped NUTS chains with the same 3-window warmup as hmc_sample."""
    init_beta = jnp.atleast_2d(jnp.asarray(init_beta))
    C, d = init_beta.shape
    vg = jax.value_and_grad(logpost)

    def one_chain(key, z0):
        def kernel(key, z, eps, inv_mass):
            return _nuts_kernel(key, z, vg, eps, inv_mass, max_depth)

        w1 = max(n_warmup // 4, 1)
        w2 = max(n_warmup // 2, 1)
        w3 = max(n_warmup - w1 - w2, 1)
        eps0 = jnp.asarray(init_step_size, z0.dtype)
        inv_mass0 = jnp.ones((d,), z0.dtype)
        welford0 = (
            jnp.zeros((), z0.dtype),
            jnp.zeros((d,), z0.dtype),
            jnp.zeros((d,), z0.dtype),
        )

        def warm_step(carry, key):
            z, da, inv_mass, welford = carry
            z, acc, _, _ = kernel(key, z, jnp.exp(da.log_eps), inv_mass)
            da = _da_update(da, acc, target_accept)
            count, mean, m2 = welford
            count += 1.0
            delta = z - mean
            mean = mean + delta / count
            m2 = m2 + delta * (z - mean)
            return (z, da, inv_mass, (count, mean, m2)), None

        keys = jax.random.split(key, w1 + w2 + w3 + n_samples)
        k1, k2, k3, ks = (
            keys[:w1],
            keys[w1 : w1 + w2],
            keys[w1 + w2 : w1 + w2 + w3],
            keys[w1 + w2 + w3 :],
        )
        (z, da, inv_mass, _), _ = lax.scan(
            warm_step, (z0, _da_init(eps0), inv_mass0, welford0), k1
        )
        (z, da, inv_mass, (cnt, mean, m2)), _ = lax.scan(
            warm_step, (z, _da_init(jnp.exp(da.log_eps_avg)), inv_mass, welford0), k2
        )
        var = m2 / jnp.maximum(cnt - 1.0, 1.0)
        var = (cnt / (cnt + 5.0)) * var + 1e-3 * (5.0 / (cnt + 5.0))
        inv_mass = jnp.maximum(var, 1e-8)
        (z, da, inv_mass, _), _ = lax.scan(
            warm_step, (z, _da_init(jnp.exp(da.log_eps_avg)), inv_mass, welford0), k3
        )
        eps_final = jnp.exp(da.log_eps_avg)

        def sample_step(z, key):
            z, acc, depth, _ = kernel(key, z, eps_final, inv_mass)
            return z, (z, acc, depth)

        z, (draws, accs, depths) = lax.scan(sample_step, z, ks)
        return draws, jnp.mean(accs), eps_final, inv_mass, jnp.mean(
            depths.astype(z0.dtype)
        )

    keys = jax.random.split(key, C)
    draws, acc, eps, inv_mass, mean_depth = jax.vmap(one_chain)(keys, init_beta)
    return NUTSResult(draws, acc, eps, inv_mass, mean_depth)
