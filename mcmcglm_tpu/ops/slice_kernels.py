"""Univariate slice-sampling kernels in JAX.

From-scratch JAX re-implementations of the algorithms the reference delegates
to the CRAN ``qslice`` package (reference usage: R/mcmcglm.R:154,258-261 and
vignettes/pospkg.Rmd:286-335):

  * :func:`slice_stepping_out` — Neal (2003) stepping-out + shrinkage
    (the reference default, ``qslice::slice_stepping_out``).
  * :func:`slice_doubling` — Neal (2003) doubling + shrinkage with the
    acceptability back-check.
  * :func:`slice_elliptical` — Murray, Adams & MacKay (2010) elliptical
    slice sampler with a N(mu, sigma^2) auxiliary (``qslice::slice_elliptical``).
  * :func:`slice_genelliptical` — Nishihara, Murray & Adams (2014)
    generalized elliptical (Student-t auxiliary) via the scale-mixture
    representation (``qslice::slice_genelliptical``).
  * :func:`slice_latent` — Li & Walker (2020) latent slice sampler with a
    carried bracket-width state (``qslice::slice_latent``).

Design for accelerators (see arXiv:2503.17405 on vectorized MCMC):

  * every rejection loop is a bounded ``lax.while_loop`` whose carry holds
    the last target evaluation, so each loop iteration costs exactly one
    (vectorised) target evaluation;
  * kernels are ``vmap``-able over chains: under vmap the while loops run
    until the slowest lane converges, with finished lanes masked — so the
    per-iteration cost stays one batched O(n) evaluation for the whole
    chain block;
  * the target is evaluated *relative* to the current point: callers that
    already know ``log_target(x0)`` pass it as ``fx0`` (the CGGibbs engine
    passes 0.0 for its relative potential), avoiding a wasted evaluation and
    keeping all compared quantities O(1) in magnitude — which is what makes
    float32 slice acceptance safe without float64 emulation.

Common return type mirrors qslice's ``list(x=, nEvaluations=)`` contract
(usage at R/mcmcglm.R:261).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "SliceResult",
    "SliceKernel",
    "SLICE_KERNELS",
    "get_slice_kernel",
    "register_slice_kernel",
    "slice_stepping_out",
    "slice_stepping_out_batched",
    "slice_doubling",
    "slice_elliptical",
    "slice_genelliptical",
    "slice_latent",
    "slice_quantile",
]


class SliceResult(NamedTuple):
    x: jax.Array  # the new point (qslice `$x`, R/mcmcglm.R:261)
    n_evals: jax.Array  # number of target evaluations (qslice `$nEvaluations`)
    state: jax.Array  # carried kernel state (e.g. latent bracket width s)


def _split(key, n):
    return jax.random.split(key, n)


def _exp_draw(key, dtype):
    return jax.random.exponential(key, (), dtype=dtype)


def _level_from(key, fx0):
    """Slice level on the log scale: log y = f(x0) - Exp(1)."""
    return fx0 - _exp_draw(key, jnp.result_type(fx0, jnp.float32))


# --------------------------------------------------------------------------
# Stepping-out + shrinkage (Neal 2003, Fig. 3 + Fig. 5)
# --------------------------------------------------------------------------

def slice_stepping_out(
    key,
    x0,
    log_target: Callable,
    w,
    max_stepouts: int = 128,
    max_shrink: int = 64,
    fx0=None,
    state=None,
) -> SliceResult:
    """Neal (2003) stepping-out slice sampler for a univariate target.

    Equivalent of ``qslice::slice_stepping_out(x, log_target, w, max)``
    (the reference's default ``qslice_fun``, R/mcmcglm.R:154).  ``w`` is the
    slice width; ``max_stepouts`` plays the role of qslice's ``max`` — the
    total step-out budget m, split randomly between the two directions as in
    Neal's Fig. 3 (J = floor(m*u), K = m-1-J).

    The shrinkage loop is bounded by ``max_shrink``; the interval collapses
    geometrically toward x0, so 64 iterations shrink it below 2^-64 of its
    width — on exhaustion the current point is returned (probability
    negligible; keeps the kernel total).
    """
    del state
    dtype = jnp.result_type(x0, jnp.float32)
    x0 = jnp.asarray(x0, dtype)
    w = jnp.asarray(w, dtype)
    k_level, k_u, k_j, k_shrink = _split(key, 4)

    if fx0 is None:
        fx0 = log_target(x0)
        n_evals0 = jnp.asarray(1, jnp.int32)
    else:
        fx0 = jnp.asarray(fx0, dtype)
        n_evals0 = jnp.asarray(0, jnp.int32)
    level = _level_from(k_level, fx0)

    # Initial interval randomly positioned around x0.
    u = jax.random.uniform(k_u, (), dtype=dtype)
    L0 = x0 - w * u
    R0 = L0 + w
    m = max_stepouts
    uj = jax.random.uniform(k_j, (), dtype=dtype)
    J = jnp.floor(uj * m).astype(jnp.int32)
    K = (m - 1) - J

    def stepout(endpoint0, budget, direction):
        def cond(carry):
            _, budget, f_end, _ = carry
            return (budget > 0) & (f_end > level)

        def body(carry):
            end, budget, _, n = carry
            new_end = end + direction * w
            return (new_end, budget - 1, log_target(new_end), n + 1)

        end, _, _, n = lax.while_loop(
            cond, body, (endpoint0, budget, log_target(endpoint0), jnp.asarray(1, jnp.int32))
        )
        return end, n

    L, nL = stepout(L0, J, jnp.asarray(-1.0, dtype))
    R, nR = stepout(R0, K, jnp.asarray(1.0, dtype))

    # Shrinkage: sample uniformly on (L, R), shrink toward x0 on rejection.
    def shrink_cond(carry):
        _, _, _, accepted, it, _ = carry
        return (~accepted) & (it < max_shrink)

    def shrink_body(carry):
        L, R, _, _, it, key = carry
        key, sub = _split(key, 2)
        x1 = L + (R - L) * jax.random.uniform(sub, (), dtype=dtype)
        f1 = log_target(x1)
        ok = f1 >= level
        newL = jnp.where(~ok & (x1 < x0), x1, L)
        newR = jnp.where(~ok & (x1 >= x0), x1, R)
        return (newL, newR, x1, ok, it + 1, key)

    _, _, x1, accepted, n_shrink, _ = lax.while_loop(
        shrink_cond,
        shrink_body,
        (L, R, x0, jnp.asarray(False), jnp.asarray(0, jnp.int32), k_shrink),
    )
    x_new = jnp.where(accepted, x1, x0)
    n_evals = n_evals0 + nL + nR + n_shrink
    return SliceResult(x_new, n_evals, jnp.zeros((), dtype))


# --------------------------------------------------------------------------
# Batched-proposal stepping-out + shrinkage: the throughput kernel.
# --------------------------------------------------------------------------

def slice_stepping_out_batched(
    key,
    x0,
    log_target: Callable,
    w,
    K: int = 8,
    max_stepouts: int = 128,
    max_shrink_rounds: int = 16,
    fx0=None,
    state=None,
) -> SliceResult:
    """Neal (2003) stepping-out slice sampling with K target evaluations per
    memory pass — *exactly* the same stationary kernel as
    :func:`slice_stepping_out`, restructured for device throughput.

    Why: in the CGGibbs engine each target evaluation streams the (chains, n)
    eta/log-density state from device memory inside one
    ``lax.while_loop`` iteration, and vmapped chains run the loop in
    lockstep to the slowest lane — so the executed iteration count per
    coordinate is the *max* over the chain block, each iteration paying a
    fixed dispatch + memory-pass cost.  This kernel amortises that fixed cost by
    evaluating K candidates per pass (``jax.vmap`` over the proposal axis —
    one fused (K, n) elementwise pass that reads eta once):

      * **stepping out**: candidate endpoints L0 - m*w (m = 0..) and
        R0 + m*w are evaluated K/2-per-direction per round; the final
        endpoint is the *first* candidate at or below the slice level
        (first-crossing detection), capped by Neal's randomized budget split
        J / (max_stepouts-1-J) — identical to the sequential procedure,
        which also stops at the first sub-level endpoint.
      * **shrinkage with rejection reuse**: each round draws K points
        uniformly on the round-start interval [L, R] and evaluates all of
        them in one pass; the points are then folded sequentially through
        Neal's shrink automaton in O(1) scalar ops each.  A point that falls
        outside the *current* (already-shrunk) interval is skipped entirely
        — a uniform draw on [L, R] conditioned to land in [L', R'] subset
        [L, R] is exactly a uniform draw on [L', R'], so the skipped points
        are rejection-sampling overhead, not a distributional change.  Each
        used point either accepts (f >= level) or shrinks the interval
        toward x0, exactly as in the sequential kernel.

    Typical cost: 1-2 stepping rounds + 1-2 shrink rounds = 2-4 memory
    passes per coordinate vs ~7-20 lockstep passes for the sequential
    kernel.  ``n_evals`` counts actual target evaluations (K per round the
    lane is still active).
    """
    del state
    dtype = jnp.result_type(x0, jnp.float32)
    x0 = jnp.asarray(x0, dtype)
    w = jnp.asarray(w, dtype)
    KL = K // 2
    KR = K - KL
    g_vec = lambda xs: log_target(xs) if getattr(log_target, "batched", False) \
        else jax.vmap(log_target)(xs)  # noqa: E731
    k_level, k_u, k_j, k_shrink = _split(key, 4)

    if fx0 is None:
        fx0 = log_target(jnp.zeros((), dtype) + x0)
        n_evals0 = jnp.asarray(1, jnp.int32)
    else:
        fx0 = jnp.asarray(fx0, dtype)
        n_evals0 = jnp.asarray(0, jnp.int32)
    level = _level_from(k_level, fx0)

    u = jax.random.uniform(k_u, (), dtype=dtype)
    L0 = x0 - w * u
    R0 = L0 + w
    m = max_stepouts
    uj = jax.random.uniform(k_j, (), dtype=dtype)
    J = jnp.floor(uj * m).astype(jnp.int32)  # left budget (max step count)
    Kbud = (m - 1) - J  # right budget

    iotaL = jnp.arange(KL, dtype=jnp.int32)
    iotaR = jnp.arange(KR, dtype=jnp.int32)

    def so_cond(c):
        _, _, foundL, foundR, _, _ = c
        return (~foundL) | (~foundR)

    def so_body(c):
        mL, mR, foundL, foundR, (tL, tR), nev = c
        idxL = mL + iotaL
        idxR = mR + iotaR
        cand = jnp.concatenate(
            [L0 - idxL.astype(dtype) * w, R0 + idxR.astype(dtype) * w]
        )
        f = g_vec(cand)
        fL, fR = f[:KL], f[KL:]

        belowL = fL <= level
        anyL = jnp.any(belowL)
        firstL = mL + jnp.argmax(belowL).astype(jnp.int32)
        tL_round = jnp.where(anyL, jnp.minimum(firstL, J), J)
        doneL = anyL | ((mL + KL) > J)
        tL = jnp.where(~foundL & doneL, tL_round, tL)

        belowR = fR <= level
        anyR = jnp.any(belowR)
        firstR = mR + jnp.argmax(belowR).astype(jnp.int32)
        tR_round = jnp.where(anyR, jnp.minimum(firstR, Kbud), Kbud)
        doneR = anyR | ((mR + KR) > Kbud)
        tR = jnp.where(~foundR & doneR, tR_round, tR)

        nev = nev + jnp.where((~foundL) | (~foundR), K, 0)
        return (mL + KL, mR + KR, foundL | doneL, foundR | doneR, (tL, tR), nev)

    zero_i = jnp.zeros((), jnp.int32)
    (_, _, _, _, (tL, tR), n_so) = lax.while_loop(
        so_cond,
        so_body,
        (zero_i, zero_i, jnp.asarray(False), jnp.asarray(False),
         (zero_i, zero_i), zero_i),
    )
    L = L0 - tL.astype(dtype) * w
    R = R0 + tR.astype(dtype) * w

    def sh_cond(c):
        _, _, _, accepted, rnd, _, _ = c
        return (~accepted) & (rnd < max_shrink_rounds)

    def sh_body(c):
        L, R, bnew, accepted, rnd, nev, key = c
        key, sub = _split(key, 2)
        us = jax.random.uniform(sub, (K,), dtype=dtype)
        xs = L + (R - L) * us  # uniform on the ROUND-START interval
        fs = g_vec(xs)
        # fold the K evaluated points through Neal's shrink automaton;
        # points outside the current (shrunk) interval are skipped —
        # see docstring for why this preserves exactness.
        for k in range(K):
            xk, fk = xs[k], fs[k]
            use = (xk >= L) & (xk <= R) & (~accepted)
            ok = fk >= level
            bnew = jnp.where(use & ok, xk, bnew)
            shrink = use & (~ok)
            L = jnp.where(shrink & (xk < x0), xk, L)
            R = jnp.where(shrink & (xk >= x0), xk, R)
            accepted = accepted | (use & ok)
        return (L, R, bnew, accepted, rnd + 1, nev + K, key)

    (_, _, bnew, accepted, _, n_sh, _) = lax.while_loop(
        sh_cond,
        sh_body,
        (L, R, x0, jnp.asarray(False), zero_i, zero_i, k_shrink),
    )
    x_new = jnp.where(accepted, bnew, x0)
    return SliceResult(x_new, n_evals0 + n_so + n_sh, jnp.zeros((), dtype))


# --------------------------------------------------------------------------
# Doubling + shrinkage with acceptability check (Neal 2003, Fig. 4 + 6)
# --------------------------------------------------------------------------

def slice_doubling(
    key,
    x0,
    log_target: Callable,
    w,
    max_doublings: int = 32,
    max_shrink: int = 64,
    fx0=None,
    state=None,
) -> SliceResult:
    """Neal (2003) doubling procedure (``qslice`` offers the same algorithm).

    The interval doubles in a random direction until both ends are below the
    level or the budget p = ``max_doublings`` is spent; proposals from the
    shrinkage loop additionally pass Neal's back-test (Fig. 6) that the
    point could have generated the final interval.
    """
    del state
    dtype = jnp.result_type(x0, jnp.float32)
    x0 = jnp.asarray(x0, dtype)
    w = jnp.asarray(w, dtype)
    k_level, k_u, k_dir, k_shrink = _split(key, 4)

    if fx0 is None:
        fx0 = log_target(x0)
        n_evals0 = jnp.asarray(1, jnp.int32)
    else:
        fx0 = jnp.asarray(fx0, dtype)
        n_evals0 = jnp.asarray(0, jnp.int32)
    level = _level_from(k_level, fx0)

    u = jax.random.uniform(k_u, (), dtype=dtype)
    L0 = x0 - w * u
    R0 = L0 + w
    fL0 = log_target(L0)
    fR0 = log_target(R0)

    def dbl_cond(carry):
        _, _, fL, fR, p, _, _ = carry
        return (p < max_doublings) & ((fL > level) | (fR > level))

    def dbl_body(carry):
        L, R, fL, fR, p, n, key = carry
        key, sub = _split(key, 2)
        go_left = jax.random.uniform(sub, (), dtype=dtype) < 0.5
        width = R - L
        newL = jnp.where(go_left, L - width, L)
        newR = jnp.where(go_left, R, R + width)
        f_new = log_target(jnp.where(go_left, newL, newR))
        newfL = jnp.where(go_left, f_new, fL)
        newfR = jnp.where(go_left, fR, f_new)
        return (newL, newR, newfL, newfR, p + 1, n + 1, key)

    L, R, fL, fR, _, n_dbl, _ = lax.while_loop(
        dbl_cond,
        dbl_body,
        (L0, R0, fL0, fR0, jnp.asarray(0, jnp.int32), jnp.asarray(2, jnp.int32), k_dir),
    )

    def acceptable(x1):
        """Neal (2003) Fig. 6 back-test; costs up to max_doublings evals."""

        def cond(carry):
            hatL, hatR, _, done, _ = carry
            return (~done) & ((hatR - hatL) > 1.1 * w)

        def body(carry):
            hatL, hatR, ok, done, n = carry
            M = 0.5 * (hatL + hatR)
            D = ((x0 < M) & (x1 >= M)) | ((x0 >= M) & (x1 < M))
            go_left = x1 < M
            newL = jnp.where(go_left, hatL, M)
            newR = jnp.where(go_left, M, hatR)
            fl = log_target(newL)
            fr = log_target(newR)
            fail = D & (fl <= level) & (fr <= level)
            return (newL, newR, ok & ~fail, done | fail, n + 2)

        _, _, ok, _, n = lax.while_loop(
            cond,
            body,
            (L, R, jnp.asarray(True), jnp.asarray(False), jnp.asarray(0, jnp.int32)),
        )
        return ok, n

    def shrink_cond(carry):
        _, _, _, accepted, it, _, _ = carry
        return (~accepted) & (it < max_shrink)

    def shrink_body(carry):
        Lb, Rb, _, _, it, n, key = carry
        key, sub = _split(key, 2)
        x1 = Lb + (Rb - Lb) * jax.random.uniform(sub, (), dtype=dtype)
        f1 = log_target(x1)
        ok_level = f1 >= level
        ok_accept, n_acc = acceptable(x1)
        ok = ok_level & ok_accept
        newL = jnp.where(~ok & (x1 < x0), x1, Lb)
        newR = jnp.where(~ok & (x1 >= x0), x1, Rb)
        return (newL, newR, x1, ok, it + 1, n + 1 + n_acc, key)

    _, _, x1, accepted, _, n_shrink, _ = lax.while_loop(
        shrink_cond,
        shrink_body,
        (L, R, x0, jnp.asarray(False), jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32), k_shrink),
    )
    x_new = jnp.where(accepted, x1, x0)
    return SliceResult(x_new, n_evals0 + n_dbl + n_shrink, jnp.zeros((), dtype))


# --------------------------------------------------------------------------
# Elliptical slice sampler (Murray, Adams & MacKay 2010), univariate with
# N(mu, sigma^2) auxiliary — equivalent of qslice::slice_elliptical
# (reference usage: R/mcmcglm.R:142-144, vignettes/pospkg.Rmd:286-296).
# --------------------------------------------------------------------------

def slice_elliptical(
    key,
    x0,
    log_target: Callable,
    mu,
    sigma,
    max_shrink: int = 64,
    fx0=None,
    state=None,
) -> SliceResult:
    del state
    dtype = jnp.result_type(x0, jnp.float32)
    x0 = jnp.asarray(x0, dtype)
    mu = jnp.asarray(mu, dtype)
    sigma = jnp.asarray(sigma, dtype)
    k_level, k_nu, k_theta, k_shrink = _split(key, 4)

    if fx0 is None:
        fx0 = log_target(x0)
        n_evals0 = jnp.asarray(1, jnp.int32)
    else:
        fx0 = jnp.asarray(fx0, dtype)
        n_evals0 = jnp.asarray(0, jnp.int32)
    level = _level_from(k_level, fx0)

    nu = mu + sigma * jax.random.normal(k_nu, (), dtype=dtype)
    two_pi = jnp.asarray(2.0 * math.pi, dtype)
    theta0 = jax.random.uniform(k_theta, (), dtype=dtype) * two_pi
    lo0 = theta0 - two_pi
    hi0 = theta0

    def point(theta):
        return (x0 - mu) * jnp.cos(theta) + (nu - mu) * jnp.sin(theta) + mu

    def cond(carry):
        _, _, _, _, accepted, it, _ = carry
        return (~accepted) & (it < max_shrink)

    def body(carry):
        lo, hi, theta, _, _, it, key = carry
        x1 = point(theta)
        ok = log_target(x1) >= level
        new_lo = jnp.where(~ok & (theta < 0), theta, lo)
        new_hi = jnp.where(~ok & (theta >= 0), theta, hi)
        key, sub = _split(key, 2)
        new_theta = new_lo + (new_hi - new_lo) * jax.random.uniform(sub, (), dtype=dtype)
        return (new_lo, new_hi, new_theta, x1, ok, it + 1, key)

    _, _, _, x1, accepted, n_it, _ = lax.while_loop(
        cond,
        body,
        (lo0, hi0, theta0, x0, jnp.asarray(False), jnp.asarray(0, jnp.int32), k_shrink),
    )
    x_new = jnp.where(accepted, x1, x0)
    return SliceResult(x_new, n_evals0 + n_it, jnp.zeros((), dtype))


# --------------------------------------------------------------------------
# Generalized elliptical slice sampler (Nishihara, Murray & Adams 2014),
# Student-t auxiliary via scale mixture — qslice::slice_genelliptical
# (reference usage: vignettes/pospkg.Rmd:325-335).
# --------------------------------------------------------------------------

def slice_genelliptical(
    key,
    x0,
    log_target: Callable,
    mu,
    sigma,
    df,
    max_shrink: int = 64,
    fx0=None,
    state=None,
) -> SliceResult:
    """Draws the t's mixing scale conditional on x0, then runs one elliptical
    slice update under the induced normal:
        lambda | x0 ~ Gamma((df+1)/2, rate=(df + ((x0-mu)/sigma)^2)/2),
        x | lambda ~ ESS with scale sigma/sqrt(lambda).
    """
    dtype = jnp.result_type(x0, jnp.float32)
    x0 = jnp.asarray(x0, dtype)
    mu = jnp.asarray(mu, dtype)
    sigma = jnp.asarray(sigma, dtype)
    df = jnp.asarray(df, dtype)
    k_lam, k_ess = _split(key, 2)

    z2 = ((x0 - mu) / sigma) ** 2
    shape = (df + 1.0) / 2.0
    rate = (df + z2) / 2.0
    lam = jax.random.gamma(k_lam, shape, (), dtype=dtype) / rate
    sigma_eff = sigma * lax.rsqrt(lam)
    return slice_elliptical(
        k_ess, x0, log_target, mu, sigma_eff, max_shrink=max_shrink, fx0=fx0, state=state
    )


# --------------------------------------------------------------------------
# Latent slice sampler (Li & Walker 2020) — qslice::slice_latent.
# Carries a per-coordinate bracket width s.
# --------------------------------------------------------------------------

def slice_latent(
    key,
    x0,
    log_target: Callable,
    rate=0.3,
    max_shrink: int = 64,
    fx0=None,
    state=None,
) -> SliceResult:
    """Latent slice sampler: the bracket half-width s is itself sampled,
    s | l, x0 ~ 2|l - x0| + Exp(rate), giving an auto-tuned bracket.
    ``state`` carries s between calls (initialised to 1/rate if None)."""
    dtype = jnp.result_type(x0, jnp.float32)
    x0 = jnp.asarray(x0, dtype)
    rate = jnp.asarray(rate, dtype)
    s = jnp.asarray(1.0 / rate if state is None else state, dtype)
    k_level, k_l, k_s, k_shrink = _split(key, 4)

    if fx0 is None:
        fx0 = log_target(x0)
        n_evals0 = jnp.asarray(1, jnp.int32)
    else:
        fx0 = jnp.asarray(fx0, dtype)
        n_evals0 = jnp.asarray(0, jnp.int32)
    level = _level_from(k_level, fx0)

    # latent midpoint l ~ U(x0 - s/2, x0 + s/2)
    l = x0 + s * (jax.random.uniform(k_l, (), dtype=dtype) - 0.5)
    # refresh s: s' = 2|l - x0| + Exp(rate)
    s_new = 2.0 * jnp.abs(l - x0) + _exp_draw(k_s, dtype) / rate
    L0 = l - s_new / 2.0
    R0 = l + s_new / 2.0

    def cond(carry):
        _, _, _, accepted, it, _ = carry
        return (~accepted) & (it < max_shrink)

    def body(carry):
        L, R, _, _, it, key = carry
        key, sub = _split(key, 2)
        x1 = L + (R - L) * jax.random.uniform(sub, (), dtype=dtype)
        ok = log_target(x1) >= level
        newL = jnp.where(~ok & (x1 < x0), x1, L)
        newR = jnp.where(~ok & (x1 >= x0), x1, R)
        return (newL, newR, x1, ok, it + 1, key)

    _, _, x1, accepted, n_it, _ = lax.while_loop(
        cond,
        body,
        (L0, R0, x0, jnp.asarray(False), jnp.asarray(0, jnp.int32), k_shrink),
    )
    x_new = jnp.where(accepted, x1, x0)
    return SliceResult(x_new, n_evals0 + n_it, s_new)


# --------------------------------------------------------------------------
# Quantile slice sampler (Heiner, Johnson, Waller 2024 — the qslice paper's
# own method, qslice::slice_quantile): transform through a pseudo-target's
# CDF and shrink on the unit interval.
# --------------------------------------------------------------------------

def slice_quantile(
    key,
    x0,
    log_target: Callable,
    pseudo_loc=0.0,
    pseudo_scale=1.0,
    pseudo_family: str = "cauchy",
    max_shrink: int = 64,
    fx0=None,
    state=None,
) -> SliceResult:
    """Quantile slice sampler with a normal or cauchy pseudo-target.

    psi = pseudo pdf, F = pseudo CDF.  The transformed target on (0,1) is
    h(u) = f(F^-1(u)) / psi(F^-1(u)); a shrinkage slice update on u with
    initial bracket (0, 1) needs no tuning beyond the pseudo-target.  A
    heavy-tailed cauchy pseudo-target is the safe default.
    """
    del state
    dtype = jnp.result_type(x0, jnp.float32)
    x0 = jnp.asarray(x0, dtype)
    loc = jnp.asarray(pseudo_loc, dtype)
    scale = jnp.asarray(pseudo_scale, dtype)
    k_level, k_shrink = _split(key, 2)

    if pseudo_family == "normal":
        def cdf(x):
            return jax.scipy.stats.norm.cdf(x, loc, scale)

        def ppf(u):
            return loc + scale * jax.scipy.special.ndtri(u)

        def logpdf(x):
            z = (x - loc) / scale
            return -0.5 * z * z - jnp.log(scale) - jnp.asarray(
                0.5 * math.log(2.0 * math.pi), dtype
            )
    elif pseudo_family == "cauchy":
        def cdf(x):
            return 0.5 + jnp.arctan((x - loc) / scale) / jnp.pi

        def ppf(u):
            return loc + scale * jnp.tan(jnp.pi * (u - 0.5))

        def logpdf(x):
            z = (x - loc) / scale
            return -jnp.log(jnp.pi * scale * (1.0 + z * z))
    else:
        raise ValueError("pseudo_family must be 'normal' or 'cauchy'")

    eps = jnp.asarray(1e-7, dtype)

    def log_h_from_x(x, fx=None):
        fx = log_target(x) if fx is None else fx
        return fx - logpdf(x)

    u0 = jnp.clip(cdf(x0), eps, 1.0 - eps)
    if fx0 is None:
        h0 = log_h_from_x(x0)
        n_evals0 = jnp.asarray(1, jnp.int32)
    else:
        h0 = jnp.asarray(fx0, dtype) - logpdf(x0)
        n_evals0 = jnp.asarray(0, jnp.int32)
    level = _level_from(k_level, h0)

    def cond(carry):
        _, _, _, _, accepted, it, _ = carry
        return (~accepted) & (it < max_shrink)

    def body(carry):
        lo, hi, _, _, _, it, key = carry
        key, sub = _split(key, 2)
        u1 = lo + (hi - lo) * jax.random.uniform(sub, (), dtype=dtype)
        u1c = jnp.clip(u1, eps, 1.0 - eps)
        x1 = ppf(u1c)
        ok = log_h_from_x(x1) >= level
        new_lo = jnp.where(~ok & (u1 < u0), u1, lo)
        new_hi = jnp.where(~ok & (u1 >= u0), u1, hi)
        return (new_lo, new_hi, x1, u1, ok, it + 1, key)

    _, _, x1, _, accepted, n_it, _ = lax.while_loop(
        cond,
        body,
        (
            jnp.zeros((), dtype),
            jnp.ones((), dtype),
            x0,
            u0,
            jnp.asarray(False),
            jnp.asarray(0, jnp.int32),
            k_shrink,
        ),
    )
    x_new = jnp.where(accepted, x1, x0)
    return SliceResult(x_new, n_evals0 + n_it, jnp.zeros((), dtype))


# --------------------------------------------------------------------------
# Registry — the pluggable slice-kernel story ("all functions are available",
# R/mcmcglm.R:35-39) with required-tuning validation matching the reference's
# argument check (R/mcmcglm.R:167-169).
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SliceKernel:
    name: str
    fn: Callable
    required: tuple
    state_init: Optional[Callable] = None  # tuning-dict -> initial state scalar

    def __call__(self, key, x0, log_target, state=None, fx0=None, **tuning):
        return self.fn(key, x0, log_target, fx0=fx0, state=state, **tuning)

    def init_state(self, tuning):
        if self.state_init is None:
            return jnp.zeros(())
        return jnp.asarray(self.state_init(tuning))


SLICE_KERNELS: dict = {}


def register_slice_kernel(kernel: SliceKernel) -> SliceKernel:
    SLICE_KERNELS[kernel.name] = kernel
    return kernel


def get_slice_kernel(name_or_kernel) -> SliceKernel:
    if isinstance(name_or_kernel, SliceKernel):
        return name_or_kernel
    if callable(name_or_kernel) and not isinstance(name_or_kernel, str):
        # bare function: wrap with no required-arg validation
        return SliceKernel(getattr(name_or_kernel, "__name__", "custom"), name_or_kernel, ())
    try:
        return SLICE_KERNELS[name_or_kernel]
    except KeyError:
        raise ValueError(
            f"unknown slice kernel {name_or_kernel!r}; known: {sorted(SLICE_KERNELS)}"
        ) from None


register_slice_kernel(SliceKernel("stepping_out", slice_stepping_out, ("w",)))
register_slice_kernel(
    SliceKernel("stepping_out_batched", slice_stepping_out_batched, ("w",))
)
register_slice_kernel(SliceKernel("doubling", slice_doubling, ("w",)))
register_slice_kernel(SliceKernel("elliptical", slice_elliptical, ("mu", "sigma")))
register_slice_kernel(
    SliceKernel("genelliptical", slice_genelliptical, ("mu", "sigma", "df"))
)
register_slice_kernel(SliceKernel("quantile", slice_quantile, ()))
register_slice_kernel(
    SliceKernel(
        "latent",
        slice_latent,
        (),
        state_init=lambda tuning: 1.0 / float(tuning.get("rate", 0.3)),
    )
)
