"""The free-running CGGibbs per-pass automaton (classic and K-speculative).

Extracted from freerun.py (pure refactor; the bitwise run/run_passes and
warmup equivalence tests in tests/test_freerun_spec.py are the guard).
``run_pass`` advances every chain by ONE target evaluation;
``run_pass_spec`` by a K-proposal speculative battery (see the design
docstring in freerun.py).  Both take the
engine (``freerun.FreeRunCGGibbs``) first and return
``(new_state, sweep_count, draws, nevbuf)``; the state class is reused
via ``type(s)`` so no circular import of FreeRunState is needed.

Reference hot loop being reproduced: R/mcmcglm.R:226-274 with the O(n)
incremental eta update of R/glm_utils.R:126-132.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["run_pass", "run_pass_spec"]


def run_pass(eng, s: FreeRunState, sweep_count, draws, nevbuf,
          n_sweeps: int, adapt: bool, shrink_only: bool,
          stepout_sweeps=None):
    """One target evaluation + automaton advance for every chain."""
    dtype = eng.dtype
    C = s.beta.shape[0]
    rows = jnp.arange(C)
    active = sweep_count < n_sweeps

    # pass-level randomness: ONE batched uniform block (each separate
    # (C,)-draw pays a fixed threefry dispatch cost).  Width 1 + nb where
    # nb = eng._n_begin_u (3 for stepping_out -> (C, 4), bitwise the
    # historical block; 4 for latent, whose begin also draws the first
    # shrink proposal).
    nb = eng._n_begin_u
    key, k_u = jax.random.split(s.key)
    R4 = jax.random.uniform(k_u, (C, 1 + nb), dtype=dtype)
    u_shrink = R4[:, 0]

    # pseudo_adapt: the current coordinate's pseudo-target, gathered
    # once from the per-(chain, coordinate) buffers (constant across the
    # coordinate episode — the buffers only change at this lane's commit)
    if eng.slice_kernel == "quantile" and eng.q_adapt:
        q_loc_l = jnp.take_along_axis(s.qloc, s.j[:, None], axis=1)[:, 0]
        q_scale_l = jnp.exp(
            jnp.take_along_axis(s.logw, s.j[:, None], axis=1)[:, 0]
        )
    else:
        q_loc_l = q_scale_l = None

    # 1-2. the single fused evaluation.  Angular kernels
    # (elliptical/genelliptical) carry the ANGLE in the xprop register
    # and the auxiliary point nu in w; the proposal is mapped through
    # the ellipse here, so the evaluation itself stays kernel-agnostic.
    xg = jnp.take(eng.Xt, s.j, axis=0)  # (C, n) row gather
    if eng.is_angular:
        xp_x = eng.ellipse_point(s.b0, s.w, s.xprop)
    elif eng.slice_kernel == "quantile":
        # xprop carries u in (0, 1)
        xp_x = eng.quantile_ppf(s.xprop, q_loc_l, q_scale_l)
    else:
        xp_x = s.xprop
    delta = xp_x - s.b0
    e = s.eta + xg * delta[:, None]
    ld_e = eng._ld_eta(e, eng.y, eng.extra)
    if eng.eval_cache == "scalar":
        lsum_e = eng.reduce_fn(ld_e)
        dll = lsum_e - s.ld0
    else:
        dll = eng.reduce_fn(ld_e - s.ld0)
    f = dll + (
        jnp.asarray(eng._coord_lp(s.beta, s.j, xp_x), dtype) - s.lp0
    )
    if eng.slice_kernel == "quantile":
        # transformed target h = f - log psi: the pseudo-density
        # correction relative to the committed point
        f = f + (
            eng.quantile_logpdf(s.b0, q_loc_l, q_scale_l)
            - eng.quantile_logpdf(xp_x, q_loc_l, q_scale_l)
        )
    above = f > s.level

    stepping = s.phase == 0
    left = s.stepdir == 0

    # 3a. stepping-out transitions (this pass tested endpoint s.xprop)
    step_more_L = stepping & left & above & (s.budL > 0)
    L = jnp.where(step_more_L, s.L - s.w, s.L)
    budL = jnp.where(step_more_L, s.budL - 1, s.budL)
    done_L = stepping & left & ~step_more_L  # left endpoint is final
    step_more_R = stepping & ~left & above & (s.budR > 0)
    R = jnp.where(step_more_R, s.R + s.w, s.R)
    budR = jnp.where(step_more_R, s.budR - 1, s.budR)
    done_R = stepping & ~left & ~step_more_R  # both endpoints final

    stepdir = jnp.where(done_L, 1, s.stepdir)
    phase = jnp.where(done_R, 1, s.phase)
    enter_shrink = done_R

    # 3b. shrinkage transitions
    shrinking = s.phase == 1
    accept_move = shrinking & (f >= s.level) & active
    exhausted = shrinking & (f < s.level) & (
        s.n_shrink + 1 >= eng.max_shrink
    ) & active
    rej = shrinking & (f < s.level)
    # shrink pivot: angular brackets close toward theta = 0 (the
    # current point), quantile brackets toward u0 = F(b0) (the w
    # register), x-space brackets toward b0
    if eng.is_angular:
        piv = jnp.zeros_like(s.b0)
    elif eng.slice_kernel == "quantile":
        piv = s.w
    else:
        piv = s.b0
    L = jnp.where(rej & (s.xprop < piv), s.xprop, L)
    R = jnp.where(rej & (s.xprop >= piv), s.xprop, R)
    n_shrink = jnp.where(shrinking, s.n_shrink + 1, s.n_shrink)

    # 4. commit.  accept-with-move: the evaluated e / ld(e) are the new
    #    state.  Shrink exhaustion commits b0 (state unchanged) — same
    #    fallback as slice_stepping_out's bounded loop.
    commit = accept_move | exhausted
    b_star = jnp.where(accept_move, xp_x, s.b0)
    eta = jnp.where(accept_move[:, None], e, s.eta)
    if eng.eval_cache == "scalar":
        ld0 = jnp.where(accept_move, lsum_e, s.ld0)
    else:
        ld0 = jnp.where(accept_move[:, None], ld_e, s.ld0)
    # beta[c, j_c] = b_star: a no-op write of b0 for non-committing lanes
    beta = eng._commit_row(s.beta, s.j, b_star)

    logw = s.logw
    if adapt and eng.slice_kernel == "stepping_out":
        # Robbins-Monro pull of log w_j toward ~3x the accepted move;
        # gated one-hot select touches only committing lanes' (c, j)
        # adapt only on accept-with-move commits: a shrink-exhausted
        # commit has move = 0 and would pull log w toward log(1e-6) —
        # a width death-spiral for sticky coordinates.  (latent: logw
        # carries the kernel's own refreshed bracket width instead —
        # no Robbins-Monro, see _begin_coord_latent.)
        move = jnp.abs(b_star - s.b0)
        target = jnp.log(eng.adapt_c * move + 1e-6)
        lw_j = jnp.take_along_axis(s.logw, s.j[:, None], axis=1)[:, 0]
        new_lw = (1.0 - eng._adapt_rate) * lw_j + eng._adapt_rate * target
        logw = eng._commit_row(s.logw, s.j, new_lw, gate=accept_move)

    qloc = getattr(s, "qloc", None)
    if adapt and eng.slice_kernel == "quantile" and eng.q_adapt:
        # Robbins-Monro pull of the coordinate's pseudo-target: loc_j
        # toward accepted draws (an EWMA of the conditional's center),
        # log scale_j toward log(pseudo_c * |draw - loc_j|) (pseudo_c x
        # the mean absolute deviation).  Warmup-only; frozen for
        # sampling (adapt=False), so the collected kernel is fixed and
        # exact — the Heiner et al. 2024 adaptation recipe.
        r = eng._adapt_rate
        new_loc = (1.0 - r) * q_loc_l + r * b_star
        target_q = jnp.log(eng.q_c * jnp.abs(b_star - q_loc_l) + 1e-6)
        lw_j = jnp.log(q_scale_l)
        new_lw = (1.0 - r) * lw_j + r * target_q
        logw = eng._commit_row(s.logw, s.j, new_lw, gate=accept_move)
        qloc = eng._commit_row(s.qloc, s.j, new_loc, gate=accept_move)

    # coordinate / sweep bookkeeping
    nev_new = s.nev + active.astype(jnp.int32)
    j_next = jnp.where(commit, s.j + 1, s.j)
    sweep_done = commit & (j_next >= eng.d)
    slot = jnp.where(sweep_done, sweep_count, n_sweeps)  # OOB => dropped
    draws, nevbuf = eng._sweep_buffers(
        draws, nevbuf, rows, slot, beta, nev_new, sweep_done
    )
    sweep_count = jnp.where(sweep_done, sweep_count + 1, sweep_count)
    j_next = jnp.where(sweep_done, 0, j_next)

    # fresh automaton registers for lanes that committed; in two-phase
    # warmup a lane switches to the shrink-only kernel once ITS sweep
    # count crosses the stepout quota (per-lane: chains are free-running)
    so_eff = shrink_only
    if stepout_sweeps is not None and not shrink_only:
        so_eff = sweep_count >= stepout_sweeps
    reg = eng._begin_coord(key, beta, logw, j_next, so_eff,
                            ubatch=R4[:, 1:1 + nb], qloc=qloc)
    logw_j = reg.pop("logw_j", None)
    if logw_j is not None:  # latent: commit the refreshed bracket width
        logw = eng._commit_row(logw, j_next, logw_j, gate=commit)

    def pick(name, old):
        return jnp.where(commit, reg[name], old)

    # non-commit proposal for the next pass:
    #   stepping: the (possibly moved) endpoint of the active direction
    #   entering/continuing shrinkage: uniform on the current (L, R)
    x_shrink = L + (R - L) * u_shrink
    in_shrink = (shrinking | enter_shrink) & ~commit
    xprop_nc = jnp.where(
        in_shrink, x_shrink, jnp.where(stepdir == 0, L, R)
    )

    # freeze INACTIVE lanes' automaton registers (see the identical
    # block in _pass_spec: idle lanes that burned their shrink budget
    # at a run boundary spuriously exhaust-committed b0 on resume,
    # freezing the post-wrap coordinate — the intercept)
    def keep(new, old):
        return jnp.where(active, new, old)

    fields = dict(
        beta=beta, eta=eta, ld0=ld0, key=key, logw=logw,
        j=j_next,
        phase=keep(pick("phase", phase), s.phase),
        stepdir=keep(pick("stepdir", stepdir), s.stepdir),
        level=pick("level", s.level),
        L=keep(pick("L", L), s.L), R=keep(pick("R", R), s.R),
        budL=keep(pick("budL", budL), s.budL),
        budR=keep(pick("budR", budR), s.budR),
        b0=pick("b0", s.b0), lp0=pick("lp0", s.lp0),
        w=pick("w", s.w),
        xprop=keep(pick("xprop", xprop_nc), s.xprop),
        n_shrink=keep(pick("n_shrink", n_shrink), s.n_shrink),
        nev=nev_new,
    )
    if qloc is not None:  # QuantileState (pseudo_adapt)
        fields["qloc"] = qloc
    return type(s)(**fields), sweep_count, draws, nevbuf



def run_pass_spec(eng, s: FreeRunState, sweep_count, draws, nevbuf,
               n_sweeps: int, adapt: bool, shrink_only: bool,
               stepout_sweeps=None):
    """K target evaluations + automaton advance per chain per pass.

    The enabling fact: in Neal's shrinkage the ALL-REJECTIONS proposal
    path is deterministic given the uniforms — rejecting x moves the
    interval endpoint on whichever side of b0 x falls, a comparison
    that needs no target evaluation.  So x_1..x_K can be generated up
    front, all K targets evaluated in ONE fused (C, K, n) reduce that
    reads eta and the gathered X^T rows once, and the FIRST acceptor
    selected — its predecessors were genuinely rejected, so the
    committed draw has exactly the single-proposal kernel's
    distribution.  The same holds for stepping-out: the keep-stepping
    endpoint sequence L, L-w, L-2w, ... is deterministic, so a pass
    tests a K-endpoint battery (used during warmup).

    Throughput: when the pass is bound by memory traffic or by its
    fixed per-pass cost rather than by the log-density arithmetic, the
    K-1 extra evaluations ride nearly free while passes-per-coordinate
    drops from the mean evaluation count (~2.8 at adapted widths)
    toward ~1.  Wasted speculative evaluations cost arithmetic only.
    `nev` still
    counts ALGORITHMIC evaluations consumed (identical in law to the
    spec_k=1 engine), not speculative ones executed.
    """
    dtype = eng.dtype
    K = eng.spec_k
    C = s.beta.shape[0]
    rows = jnp.arange(C)
    active = sweep_count < n_sweeps

    nb = eng._n_begin_u
    key, k_u = jax.random.split(s.key)
    # ONE batched uniform block: K shrink proposals + the nb uniforms
    # _begin_coord needs (3 for stepping_out — level, position, stepout
    # split — bitwise the historical block; 4 for latent)
    RU = jax.random.uniform(k_u, (C, K + nb), dtype=dtype)
    U = RU[:, :K]

    stepping = s.phase == 0
    left = s.stepdir == 0

    # -- speculative proposal batteries, (C, K) --
    # shrink: all-rejections chain (deterministic interval recursion);
    # pivot at theta = 0 for the angular kernels, u0 (the w register)
    # for quantile, b0 otherwise
    if eng.is_angular:
        piv = jnp.zeros_like(s.b0)
    elif eng.slice_kernel == "quantile":
        piv = s.w
    else:
        piv = s.b0
    xs_sh, Ls_sh, Rs_sh = [], [], []
    Lc, Rc = s.L, s.R
    for k in range(K):
        x = Lc + (Rc - Lc) * U[:, k]
        xs_sh.append(x)
        Lc = jnp.where(x < piv, x, Lc)
        Rc = jnp.where(x >= piv, x, Rc)
        Ls_sh.append(Lc)
        Rs_sh.append(Rc)
    xs_sh = jnp.stack(xs_sh, 1)
    Ls_sh = jnp.stack(Ls_sh, 1)
    Rs_sh = jnp.stack(Rs_sh, 1)
    # stepping: endpoint battery in the active direction
    ks = jnp.arange(K, dtype=dtype)[None, :]
    x_step = jnp.where(
        left[:, None],
        s.L[:, None] - ks * s.w[:, None],
        s.R[:, None] + ks * s.w[:, None],
    )
    xs = jnp.where(stepping[:, None], x_step, xs_sh)
    # pseudo_adapt: the current coordinate's pseudo-target, gathered once
    # from the per-(chain, coordinate) buffers
    if eng.slice_kernel == "quantile" and eng.q_adapt:
        q_loc_l = jnp.take_along_axis(s.qloc, s.j[:, None], axis=1)[:, 0]
        q_scale_l = jnp.exp(
            jnp.take_along_axis(s.logw, s.j[:, None], axis=1)[:, 0]
        )
    else:
        q_loc_l = q_scale_l = None
    # angular/quantile: xs live in the bracket space (angle / unit
    # interval); map to x for everything that sees x-space (evaluation,
    # prior, commit)
    if eng.is_angular:
        xs_eval = eng.ellipse_point(s.b0[:, None], s.w[:, None], xs)
    elif eng.slice_kernel == "quantile":
        xs_eval = eng.quantile_ppf(
            xs,
            None if q_loc_l is None else q_loc_l[:, None],
            None if q_scale_l is None else q_scale_l[:, None],
        )
    else:
        xs_eval = xs

    # -- one fused K-proposal evaluation --
    deltas = xs_eval - s.b0[:, None]  # (C, K)
    fprior = (
        jnp.asarray(eng._coord_lp_k(s.beta, s.j, xs_eval), dtype)
        - s.lp0[:, None]
    )  # (C, K)
    if eng.slice_kernel == "quantile":
        fprior = fprior + (
            eng.quantile_logpdf(s.b0, q_loc_l, q_scale_l)[:, None]
            - eng.quantile_logpdf(
                xs_eval,
                None if q_loc_l is None else q_loc_l[:, None],
                None if q_scale_l is None else q_scale_l[:, None],
            )
        )
    shrinking = s.phase == 1
    # >= 1 for active shrink lanes; clamped because inactive lanes keep
    # evaluating past their quota without ever committing
    rem = jnp.maximum(eng.max_shrink - s.n_shrink, 0)
    xg = jnp.take(eng.Xt, s.j, axis=0)  # (C, n) row gather
    e = s.eta[:, None, :] + xg[:, None, :] * deltas[:, :, None]
    ld_e = eng._ld_eta(e, eng.y, eng.extra)  # (C, K, n)
    if eng.eval_cache == "scalar":
        lsum_abs = eng.reduce_fn(ld_e)
        dll = lsum_abs - s.ld0[:, None]
    else:
        dll = eng.reduce_fn(ld_e - s.ld0[:, None, :])
    f = dll + fprior  # (C, K)

    # -- stepping-out: consume the battery along the keep-stepping path --
    above = f > s.level[:, None]
    na = ~above
    m_na = jnp.where(na.any(1), jnp.argmax(na, 1), K).astype(jnp.int32)
    bud = jnp.where(left, s.budL, s.budR)
    moves = jnp.minimum(jnp.minimum(m_na, bud), K)  # w-steps taken
    done_dir = moves < K
    consumed_step = jnp.minimum(moves, K - 1) + 1
    movesf = moves.astype(dtype)
    L_step = jnp.where(left, s.L - movesf * s.w, s.L)
    R_step = jnp.where(left, s.R, s.R + movesf * s.w)
    budL = jnp.where(left, s.budL - moves, s.budL)
    budR = jnp.where(left, s.budR, s.budR - moves)
    done_L = stepping & left & done_dir
    done_R = stepping & ~left & done_dir
    stepdir = jnp.where(done_L, 1, s.stepdir)
    phase = jnp.where(done_R, 1, s.phase)

    # -- shrinkage: first acceptor in the battery --
    acc = f >= s.level[:, None]
    validk = jnp.arange(K, dtype=jnp.int32)[None, :] < rem[:, None]
    accv = acc & validk
    any_acc = accv.any(1)
    idx = jnp.argmax(accv, 1).astype(jnp.int32)
    consumed_sh = jnp.where(any_acc, idx + 1,
                            jnp.minimum(jnp.int32(K), rem))
    accept_move = shrinking & any_acc & active
    exhausted = shrinking & ~any_acc & (
        s.n_shrink + consumed_sh >= eng.max_shrink
    ) & active
    last = jnp.clip(consumed_sh - 1, 0, K - 1)
    L_sh = jnp.take_along_axis(Ls_sh, last[:, None], 1)[:, 0]
    R_sh = jnp.take_along_axis(Rs_sh, last[:, None], 1)[:, 0]
    n_shrink = jnp.where(shrinking, s.n_shrink + consumed_sh, s.n_shrink)
    L = jnp.where(stepping, L_step, L_sh)
    R = jnp.where(stepping, R_step, R_sh)

    # -- commit --
    x_star = jnp.take_along_axis(xs_eval, idx[:, None], 1)[:, 0]
    commit = accept_move | exhausted
    b_star = jnp.where(accept_move, x_star, s.b0)
    delta_star = jnp.where(accept_move, x_star - s.b0,
                           jnp.zeros((), dtype))
    eta = s.eta + xg * delta_star[:, None]
    if eng.eval_cache == "scalar":
        # refresh the cache with the accepted proposal's FRESH sum, not
        # the accumulated s.ld0 + dll_star: the accumulated form lets
        # f32 error random-walk per chain over thousands of commits,
        # which biases every subsequent slice test by a persistent
        # per-chain epsilon, seen as per-chain intercept offsets (a
        # pooled intercept ESS that plateaus across windows, the
        # signature of between-chain mean variance).  The classic
        # _pass always stored the fresh sum; this restores parity.
        lsum_star = jnp.take_along_axis(lsum_abs, idx[:, None], 1)[:, 0]
        ld0 = jnp.where(accept_move, lsum_star, s.ld0)
    else:
        # per-observation cache: recompute at the committed eta (the
        # battery's (C, K, n) densities are reduction-fused, never
        # materialised).  spec_k is built for the scalar cache; this
        # path stays exact but pays one extra transcendental stream.
        ld0 = jnp.where(
            accept_move[:, None],
            eng._ld_eta(eta, eng.y, eng.extra),
            s.ld0,
        )
    beta = eng._commit_row(s.beta, s.j, b_star)

    logw = s.logw
    if adapt and eng.slice_kernel == "stepping_out":
        move = jnp.abs(b_star - s.b0)
        target = jnp.log(eng.adapt_c * move + 1e-6)
        lw_j = jnp.take_along_axis(s.logw, s.j[:, None], axis=1)[:, 0]
        new_lw = (1.0 - eng._adapt_rate) * lw_j + eng._adapt_rate * target
        logw = eng._commit_row(s.logw, s.j, new_lw, gate=accept_move)

    qloc = getattr(s, "qloc", None)
    if adapt and eng.slice_kernel == "quantile" and eng.q_adapt:
        # warmup-only pseudo-target pull; frozen for sampling — see the
        # identical block (with rationale) in run_pass
        r = eng._adapt_rate
        new_loc = (1.0 - r) * q_loc_l + r * b_star
        target_q = jnp.log(eng.q_c * jnp.abs(b_star - q_loc_l) + 1e-6)
        lw_j = jnp.log(q_scale_l)
        new_lw = (1.0 - r) * lw_j + r * target_q
        logw = eng._commit_row(s.logw, s.j, new_lw, gate=accept_move)
        qloc = eng._commit_row(s.qloc, s.j, new_loc, gate=accept_move)

    consumed = jnp.where(stepping, consumed_step, consumed_sh)
    nev_new = s.nev + jnp.where(active, consumed, 0)
    j_next = jnp.where(commit, s.j + 1, s.j)
    sweep_done = commit & (j_next >= eng.d)
    slot = jnp.where(sweep_done, sweep_count, n_sweeps)
    draws, nevbuf = eng._sweep_buffers(
        draws, nevbuf, rows, slot, beta, nev_new, sweep_done
    )
    sweep_count = jnp.where(sweep_done, sweep_count + 1, sweep_count)
    j_next = jnp.where(sweep_done, 0, j_next)

    so_eff = shrink_only
    if stepout_sweeps is not None and not shrink_only:
        so_eff = sweep_count >= stepout_sweeps
    reg = eng._begin_coord(key, beta, logw, j_next, so_eff,
                            ubatch=RU[:, K:K + nb], qloc=qloc)
    logw_j = reg.pop("logw_j", None)
    if logw_j is not None:  # latent: commit the refreshed bracket width
        logw = eng._commit_row(logw, j_next, logw_j, gate=commit)

    def pick(name, old):
        return jnp.where(commit, reg[name], old)

    # INACTIVE lanes (sweep quota filled; idling while slower chains
    # finish) must not advance their automaton registers: their
    # evaluations are discarded, but letting them shrink their
    # interval / burn their shrink budget while idle meant that at
    # the NEXT run's first pass they resumed with rem=0 and
    # spuriously exhaust-committed b0 — and since an idle lane
    # always sits on the first coordinate after its sweep wrapped
    # (j=0), the INTERCEPT froze for every chain that idled >=
    # max_shrink evaluations in a boundary tail (with many chains and
    # thin=1 collection, for a large share of them).  Freezing the
    # registers keeps the lane's coordinate draw intact across the
    # boundary — it resumes exactly where it paused.
    def keep(new, old):
        return jnp.where(active, new, old)

    fields = dict(
        beta=beta, eta=eta, ld0=ld0, key=key, logw=logw,
        j=j_next,
        phase=keep(pick("phase", phase), s.phase),
        stepdir=keep(pick("stepdir", stepdir), s.stepdir),
        level=pick("level", s.level),
        L=keep(pick("L", L), s.L), R=keep(pick("R", R), s.R),
        budL=keep(pick("budL", budL), s.budL),
        budR=keep(pick("budR", budR), s.budR),
        b0=pick("b0", s.b0), lp0=pick("lp0", s.lp0),
        w=pick("w", s.w),
        xprop=pick("xprop", s.xprop),  # unused in spec mode
        n_shrink=keep(pick("n_shrink", n_shrink), s.n_shrink),
        nev=nev_new,
    )
    if qloc is not None:  # QuantileState (pseudo_adapt)
        fields["qloc"] = qloc
    return type(s)(**fields), sweep_count, draws, nevbuf

