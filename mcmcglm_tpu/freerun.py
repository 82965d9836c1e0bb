"""Free-running CGGibbs: lockstep-free slice-within-Gibbs on accelerators.

The throughput problem this solves
----------------------------------
The scan/while CGGibbs engine (engine.py) vmaps Neal's stepping-out +
shrinkage ``lax.while_loop`` over chains, so every loop runs until the
SLOWEST chain lane converges: with ~5 useful target evaluations per
coordinate (mean) the block executes 12-20 (the max across 256 lanes).
Each evaluation is a (chains, n) sweep of log-density transcendentals
(softplus/exp), so those wasted lockstep evaluations are wasted device time
one-for-one.

The design
----------
Each chain runs the *standard sequential CGGibbs algorithm* — identical
slice kernel, identical stationary distribution — but as an explicit
automaton that advances exactly ONE target evaluation per device pass.
Chains are free-running: within one pass, chain A can be shrinking
coordinate 17 of sweep 3 while chain B is stepping out coordinate 901 of
sweep 2.  Every lane does useful work on every pass, so the executed
evaluation count per chain-sweep equals the per-chain MEAN (~4-5 per
coordinate), not the cross-chain max.  Idle waste only appears at the very
end of a run, when early-finishing lanes wait for the last chain to
complete its sweep quota — an O(1/sqrt(d * sweeps)) fraction by the CLT.

Per pass, for all C chains fused into one XLA computation:

  1. gather each lane's coordinate column:  xg = X^T[j_c]          (C, n)
  2. evaluate the relative target ONCE per lane:
         e = eta + xg * (xprop - b0)
         f = logL(e) - logL_cached + prior_delta(xprop)            (C,)
     where the committed-state log likelihood is cached either per
     observation ((C, n); exact relative differences, the float32-safe
     trick of models/potential.py) or as the reduced scalar ((C,);
     eval_cache="scalar" — drops two of the five (C, n) device-memory
     streams per pass)
  3. advance each lane's automaton with O(1) scalar selects:
     stepping-out endpoint tests, shrinkage accept/reject, interval
     updates — exactly the slice_stepping_out schedule (Neal 2003).
  4. an ACCEPTING evaluation commits for free: the accepted ``e`` IS the
     new eta and its ``ld(e)`` IS the refreshed log-density cache — this
     engine has no separate commit or cache-refresh pass at all.

The loop is a single hand-batched ``lax.while_loop`` (NOT vmap-of-while:
JAX's batching rule for while wraps every carry in a per-iteration select,
which would stream the whole draws buffer through HBM on every pass);
draws/beta/width updates are drop-mode scatters so each pass writes only
the rows it actually changed.

The reference's hot loop is R/mcmcglm.R:226-274 (k over samples, j over
coordinates, one univariate slice draw per (k, j) with the O(n)
incremental eta update of R/glm_utils.R:126-132); this engine reproduces
that exact per-chain schedule while keeping every lane of the device busy
with useful evaluations.  Equivalence with :class:`~mcmcglm_tpu.engine.CGGibbs`
is distributional (tests/test_freerun.py): same kernel, different PRNG
stream consumption order.
"""

from __future__ import annotations

from functools import partial
from typing import Mapping, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .models.families import Family, check_family
from .models.priors import BetaPrior
from .utils.linalg import matvec

__all__ = ["FreeRunCGGibbs", "FreeRunState", "QuantileState"]


class FreeRunState(NamedTuple):
    # problem state, batched over chains
    beta: jax.Array  # (C, d)
    eta: jax.Array  # (C, n)
    # log-density cache at the committed eta:
    #   eval_cache="per_obs": (C, n) per-observation log densities
    #   eval_cache="scalar":  (C,) reduced log likelihood
    ld0: jax.Array
    key: jax.Array  # single PRNG key; each pass draws (C,)-vectors from it
    logw: jax.Array  # (C, d) per-coordinate log slice widths (adaptation)
    # automaton registers, all (C,)
    j: jax.Array  # current coordinate, int32
    phase: jax.Array  # 0 = stepping out, 1 = shrinking
    stepdir: jax.Array  # 0 = testing left endpoint, 1 = right
    level: jax.Array  # relative slice level (= -Exp(1))
    L: jax.Array
    R: jax.Array
    budL: jax.Array  # remaining left step budget, int32
    budR: jax.Array
    b0: jax.Array  # current beta[:, j]
    lp0: jax.Array  # prior coord log prob at b0
    w: jax.Array  # slice width for the current coordinate
    xprop: jax.Array  # proposal to evaluate next pass
    n_shrink: jax.Array  # shrink evals this coordinate, int32
    nev: jax.Array  # (C,) total target evaluations, int32


class QuantileState(NamedTuple):
    """FreeRunState extended with the adapted quantile pseudo-target's
    per-(chain, coordinate) location buffer (``pseudo_adapt=True``; the
    log pseudo-scale rides in the kernel-unused ``logw`` buffer).  Field
    prefix matches FreeRunState so the run drivers, sharded wrappers and
    checkpointing stay state-class-agnostic (same pattern as
    ops/freerun_doubling.py's DoublingState)."""

    beta: jax.Array
    eta: jax.Array
    ld0: jax.Array
    key: jax.Array
    logw: jax.Array  # (C, d) log pseudo-target scales
    j: jax.Array
    phase: jax.Array
    stepdir: jax.Array
    level: jax.Array
    L: jax.Array
    R: jax.Array
    budL: jax.Array
    budR: jax.Array
    b0: jax.Array
    lp0: jax.Array
    w: jax.Array
    xprop: jax.Array
    n_shrink: jax.Array
    nev: jax.Array
    qloc: jax.Array  # (C, d) pseudo-target locations


class FreeRunCGGibbs:
    """Lockstep-free CGGibbs sampler (all six univariate slice kernels).

    Same problem signature as :class:`~mcmcglm_tpu.engine.CGGibbs`
    restricted to ``sample_method='slice_sampling'`` (or the exact
    ``coord_sampler='conjugate'`` path) with
    ``linear_predictor_calc='update'``; every registered qslice-style
    kernel — stepping_out, doubling, latent, elliptical, genelliptical,
    quantile — runs on the automaton.  Any :class:`BetaPrior` whose
    ``coord_log_prob`` accepts a traced coordinate index is supported
    (all built-ins do).
    """

    def __init__(
        self,
        X,
        y,
        family,
        prior: BetaPrior,
        extra: Optional[Mapping] = None,
        tuning: Optional[Mapping] = None,
        reduce_fn=None,
        obs_weights=None,
        max_stepouts: int = 128,
        max_shrink: int = 64,
        shrink_only: bool = True,
        adapt_c: Optional[float] = None,
        dtype=jnp.float32,
        eval_cache: str = "auto",
        offset=None,
        spec_k: int = 1,
        battery_impl: str = "auto",
        x_storage: str = "f32",
        coord_sampler: str = "slice",
        slice_kernel: str = "stepping_out",
    ):
        # slice_kernel="latent": the Li & Walker (2020) latent slice
        # sampler at freerun pass rates.  Latent is pure shrinkage with a
        # per-(chain, coordinate) carried bracket width s (refreshed at
        # every coordinate begin as s' = 2|l - b0| + Exp(rate)), so the
        # entire pass machinery — evaluation batteries, eval caches,
        # commits, sharding — is reused
        # unchanged; only the coordinate-begin register construction
        # differs (_begin_coord_latent) and the logw buffer carries log s
        # instead of adapted stepping-out widths.  This closes the
        # reference's "all functions from qslice" claim
        # (R/mcmcglm.R:35-39) for a second kernel at full engine speed;
        # elliptical / genelliptical additionally run at freerun speed:
        # both are pure shrinkage on the ANGLE bracket (theta_lo, theta_hi)
        # (Murray et al. 2010; Nishihara et al. 2014 via the t scale
        # mixture), so the automaton carries theta in the xprop register,
        # the auxiliary point nu in the (otherwise unused) w register,
        # shrinks with a pivot at theta = 0 instead of b0, and maps theta
        # through the ellipse before the (kernel-agnostic) fused
        # evaluation — see _begin_coord_elliptical and the is_angular
        # branches in ops/freerun_passes.py.
        # quantile (Heiner/Johnson/Waller 2024, qslice's own method) is
        # the same pattern once more: shrinkage on the UNIT interval with
        # the pivot at u0 = F(b0) (carried in the w register), proposals
        # mapped through the pseudo-target quantile function, and the
        # pseudo-density correction folded into the slice comparison —
        # see _begin_coord_quantile and the quantile branches in
        # ops/freerun_passes.py.
        # doubling (Neal 2003, Figs. 4-6) completes the set: its Fig. 6
        # back-test — a nested evaluation loop in the lockstep kernel —
        # unrolls to two more automaton phases at one evaluation per
        # pass (ops/freerun_doubling.py; spec_k=1 only, since the
        # K-speculative all-rejections recursion assumes proposal
        # acceptance needs no further evaluations, which the back-test
        # breaks).
        if slice_kernel not in (
            "stepping_out", "latent", "elliptical", "genelliptical",
            "quantile", "doubling",
        ):
            raise ValueError(
                "freerun slice_kernel must be one of 'stepping_out', "
                "'doubling', 'latent', 'elliptical', 'genelliptical' or "
                f"'quantile' (got {slice_kernel!r})"
            )
        if slice_kernel != "stepping_out" and coord_sampler == "conjugate":
            raise ValueError(
                "coord_sampler='conjugate' draws exact normals — it has "
                f"no slice kernel; drop slice_kernel={slice_kernel!r}"
            )
        self.slice_kernel = slice_kernel
        self.is_angular = slice_kernel in ("elliptical", "genelliptical")
        # uniforms consumed per coordinate begin: stepping_out needs
        # (level, interval position, stepout split); latent needs
        # (level, midpoint, width Exp, first proposal); elliptical needs
        # (level, nu normal score, theta0); doubling needs (level,
        # interval position)
        self._n_begin_u = (
            4 if slice_kernel == "latent"
            else 2 if slice_kernel == "doubling"
            else 3
        )
        # one K-proposal battery exists, the XLA formulation in
        # ops/freerun_passes.py; "auto" stays the default spelling
        if battery_impl not in ("auto", "xla"):
            raise ValueError(
                "battery_impl must be 'auto' or 'xla' (the fused Pallas "
                f"batteries were removed), got {battery_impl!r}"
            )
        if slice_kernel == "doubling":
            if spec_k != 1:
                raise ValueError(
                    "slice_kernel='doubling' requires spec_k=1: the "
                    "speculative battery's all-rejections proposal "
                    "recursion does not compose with the Fig. 6 "
                    "back-test (ops/freerun_doubling.py)"
                )
        # coord_sampler="conjugate": exact normal coordinate conditionals
        # (gaussian family + identity link + diagonal normal prior only;
        # the reference's "normal-normal" validation path, R/sampling.R:
        # 19-35, at freerun pass rates).  One pass per coordinate, no
        # slice machinery — see ops/freerun_conjugate.py.
        if coord_sampler not in ("slice", "conjugate"):
            raise ValueError(
                f"coord_sampler must be 'slice' or 'conjugate', got "
                f"{coord_sampler!r}"
            )
        self.coord_sampler = coord_sampler
        self.family: Family = check_family(family)
        # The engine only ever COMPARES log densities across eta values
        # (slice level tests; the committed-state cache is differenced),
        # so it evaluates the RELATIVE form: eta-independent per-obs
        # constants dropped.  Exact (constants cancel), cheaper (no
        # lgamma(y+1) streams).
        self._ld_eta = self.family.log_density_eta_rel
        self.prior = prior
        self.dtype = dtype
        X = jnp.asarray(X, dtype)
        # x_storage="bf16": the design matrix is ROUNDED to bfloat16 once,
        # up front, and every consumer — the init matvec and the row
        # gathers — computes in f32 on the SAME rounded values (rows are
        # still stored f32).
        # The engine is therefore an EXACT sampler for the posterior of
        # X' = bf16(X): there is no within-sampler error to compare
        # against the Exp(1) slice level at all; the only change is a
        # one-time ~2^-9-relative perturbation of the design (a data
        # change far below measurement error of X in any real dataset;
        # posterior-shift quantified in tests/test_freerun_spec.py).
        # Rounding up front (not per-path) is what avoids the round-3
        # frozen-offset bug class: a MIXED-precision design (f32 init
        # matvec, bf16 updates) would freeze the per-chain residual
        # (X - X') beta0 into eta for the chain's lifetime.
        if x_storage not in ("f32", "bf16"):
            raise ValueError(
                f"x_storage must be 'f32' or 'bf16', got {x_storage!r}"
            )
        self.x_storage = x_storage
        if x_storage == "bf16":
            X = X.astype(jnp.bfloat16).astype(dtype)
        self.n, self.d = X.shape
        # fixed additive eta component (R's offset() term): enters only at
        # eta initialisation — the incremental updates preserve it
        if offset is not None:
            offset = jnp.asarray(offset, dtype).reshape(-1)
            if offset.shape[0] != self.n:
                raise ValueError(
                    f"offset length {offset.shape[0]} != n observations {self.n}"
                )
        self.offset = offset
        if prior.d != self.d:
            raise ValueError(
                f"prior dimension {prior.d} != number of model parameters {self.d}"
            )
        self.Xt = jnp.asarray(X.T)  # (d, n)
        self.y = jnp.asarray(y, dtype).reshape(-1)
        self.extra = {k: jnp.asarray(v, dtype) for k, v in dict(extra or {}).items()}
        tuning = dict(tuning or {})
        if (
            "w" not in tuning
            and coord_sampler == "slice"
            and slice_kernel in ("stepping_out", "doubling")
        ):
            raise ValueError(
                "A tuning parameter for the slice kernel is missing: ['w'] "
                f"required by {slice_kernel!r}"
            )
        self.w0 = float(tuning.get("w", 1.0))  # unused by 'conjugate'
        # doubling budget (Fig. 4's p; the lockstep slice_doubling's
        # max_doublings keyword, default 32 there too).  Capped at 60:
        # p doublings scale the interval by 2^p, and past ~2^60 * w a
        # float32 interval risks overflow before the budget bites.
        self.max_doublings = min(int(tuning.get("max_doublings", 32)), 60)
        # latent's only tuning: the Exp rate of the width refresh (the
        # lockstep slice_latent default, ops/slice_kernels.py)
        self.rate = float(tuning.get("rate", 0.3))
        # elliptical family tuning (same names as the lockstep registry)
        if self.is_angular:
            if "sigma" not in tuning:
                raise ValueError(
                    "A tuning parameter for the slice kernel is missing: "
                    f"['sigma'] required by {slice_kernel!r}"
                )
            if slice_kernel == "genelliptical" and "df" not in tuning:
                raise ValueError(
                    "A tuning parameter for the slice kernel is missing: "
                    "['df'] required by 'genelliptical'"
                )
        self.ell_mu = float(tuning.get("mu", 0.0))
        self.ell_sigma = float(tuning.get("sigma", 1.0))
        self.ell_df = float(tuning.get("df", 1.0))
        # quantile pseudo-target (lockstep slice_quantile defaults)
        self.q_loc = float(tuning.get("pseudo_loc", 0.0))
        self.q_scale = float(tuning.get("pseudo_scale", 1.0))
        self.q_family = str(tuning.get("pseudo_family", "cauchy"))
        if slice_kernel == "quantile" and self.q_family not in (
            "normal", "cauchy"
        ):
            raise ValueError(
                "pseudo_family must be 'normal' or 'cauchy', got "
                f"{self.q_family!r}"
            )
        # pseudo_adapt=True: per-(chain, coordinate) pseudo-target loc and
        # scale, tuned during WARMUP by the same Robbins-Monro machinery
        # as the stepping-out widths and FROZEN for sampling — the sound
        # adaptation of Heiner, Johnson & Waller 2024 (tune the
        # pseudo-target on warmup draws, then fix it; any FIXED
        # pseudo-target yields an exact kernel, so the collected chain's
        # law is untouched).  loc_j is pulled toward accepted draws (an
        # EWMA estimate of the coordinate's conditional center); the log
        # scale toward log(pseudo_c * |draw - loc_j|), i.e. pseudo_c x
        # the mean absolute deviation.  Motivation: the fixed global
        # pseudo-target's failure modes are exactly (a) coordinates
        # sitting far from loc and (b) scale mismatch on narrow/skewed
        # conditionals.  The per-lane values live in QuantileState.qloc and
        # the (otherwise unused) logw buffer; initialised from
        # pseudo_loc / pseudo_scale.
        self.q_adapt = bool(tuning.get("pseudo_adapt", False))
        self.q_c = float(tuning.get("pseudo_c", 5.0))
        if self.q_adapt and slice_kernel != "quantile":
            raise ValueError(
                "pseudo_adapt=True is a quantile-kernel tuning parameter; "
                f"drop it for slice_kernel={slice_kernel!r}"
            )
        if obs_weights is not None:
            ow = jnp.asarray(obs_weights, dtype).reshape(-1)
            if ow.shape[0] != self.n:
                raise ValueError(
                    f"obs_weights length {ow.shape[0]} != n observations {self.n}"
                )
            if reduce_fn is None:
                reduce_fn = lambda t: jnp.sum(t * ow, axis=-1)  # noqa: E731
        self.reduce_fn = reduce_fn or (lambda t: jnp.sum(t, axis=-1))
        self.max_stepouts = int(max_stepouts)
        self.max_shrink = int(max_shrink)
        # sampling runs use the m=1 shrink-only kernel by default (see
        # _begin_coord); warmup always uses the full stepping-out schedule
        self.shrink_only = bool(shrink_only)
        self._adapt_rate = 0.08
        # warmup width target: w ~= adapt_c * typical accepted move.  Larger
        # c widens intervals -> better per-sweep mixing (less slice
        # truncation) at the cost of more shrink evaluations: small c
        # gives ~1.3 evals/coord but poor per-draw mixing, c=40 ~3
        # evals/coord at several times the ESS per draw.  With a K-proposal
        # battery wider widths cost less (extra evaluations share a pass);
        # pass adapt_c explicitly to trade pass cost for per-draw mixing.
        self.adapt_c = float(adapt_c if adapt_c is not None else 40.0)
        # eval_cache: how the committed-state log likelihood is cached for
        # the relative slice comparison f = logL(prop) - logL(current).
        #   "per_obs": cache per-observation log densities (C, n); reduce
        #       the per-observation DIFFERENCES — exact cancellation, but
        #       two extra (C, n) memory streams per pass (read + refresh).
        #   "scalar": cache the reduced scalar (C,); compare full-magnitude
        #       sums — 5 -> 3 (C, n) streams per pass, at roundoff ~ eps *
        #       sqrt(log2 n) * sum|ld| on the slice log scale.
        #   "auto": "scalar" when that roundoff estimate (from the log
        #       density at eta = 0) is far below the Exp(1) slice level,
        #       else "per_obs".
        if eval_cache not in ("auto", "scalar", "per_obs"):
            raise ValueError(
                f"eval_cache must be 'auto', 'scalar' or 'per_obs', got {eval_cache!r}"
            )
        if eval_cache == "auto":
            ld_at0 = np.asarray(
                self._ld_eta(
                    jnp.zeros((self.n,), dtype), self.y, self.extra
                )
            )
            eps = float(np.finfo(np.dtype(dtype)).eps)
            err = (
                eps
                * float(np.sqrt(np.log2(max(self.n, 4))))
                * float(np.sum(np.abs(ld_at0)))
            )
            eval_cache = "scalar" if err < 0.01 else "per_obs"
        self.eval_cache = eval_cache
        # spec_k: speculative proposals evaluated per pass (see _pass_spec).
        # 1 = classic one-evaluation automaton; K>1 batches K target
        # evaluations into one fused pass.
        self.spec_k = int(spec_k)
        if not 1 <= self.spec_k <= 32:
            raise ValueError(f"spec_k must be in [1, 32], got {spec_k}")
        # batched prior hooks (prior API is per-chain)
        self._coord_lp = jax.vmap(self.prior.coord_log_prob, in_axes=(0, 0, 0))
        # same, over a (C, K) proposal battery
        self._coord_lp_k = jax.vmap(self._coord_lp, in_axes=(None, None, 1),
                                    out_axes=1)
        # the state pytree class: doubling extends FreeRunState with the
        # Fig. 6 back-test registers (ops/freerun_doubling.py); the run
        # drivers and sharded wrappers are state-class-agnostic
        if slice_kernel == "doubling" and coord_sampler == "slice":
            from .ops.freerun_doubling import DoublingState

            self.state_cls = DoublingState
        elif self.q_adapt:
            self.state_cls = QuantileState
        else:
            self.state_cls = FreeRunState
        self._run_cache: dict = {}
        if coord_sampler == "conjugate":
            from .ops.freerun_conjugate import conjugate_params

            m, s2 = conjugate_params(self)
            self._conj_m = jnp.asarray(m, dtype)
            self._conj_s2 = jnp.asarray(s2, dtype)
            # sum_i w_i x_ij^2, the static part of the conditional precision
            self._conj_sxx = self.reduce_fn(self.Xt**2)  # (d,)
            sd = self.extra.get("sd", jnp.asarray(1.0, dtype))
            self._conj_inv_sigma2 = 1.0 / (sd * sd)

    # -- coordinate initialisation (batched) ---------------------------------

    def _begin_coord(self, key, beta, logw, j, shrink_only, ubatch=None,
                     qloc=None):
        """Level + initial interval for each lane's coordinate j.  Returns a
        dict of fresh automaton registers.

        ``ubatch`` (C, 3) optionally supplies the three uniforms (level,
        interval position, stepout split) drawn as ONE batched call by the
        pass — each separate (C,)-draw pays a fixed threefry dispatch
        cost.  Same law either way.

        ``shrink_only=True`` is Neal's procedure with a step-out budget of
        m = 1: the randomly-positioned width-w interval is used directly
        (J = K = 0, so Fig. 3's while conditions short-circuit and the
        endpoints are never evaluated) and the lane starts in the shrinkage
        phase with a uniform draw on (L, R).  This is an exact slice kernel
        for any w; with warmup-adapted widths (~3-4x the conditional scale)
        it needs ~2-3 evaluations per coordinate — the default sampling
        configuration.  ``shrink_only=False`` is the full stepping-out
        schedule (used for warmup, where widths may start badly sized).

        ``shrink_only`` may also be a (C,) bool array — the two-phase
        warmup mode, where each lane switches from the full stepping-out
        schedule to the shrink-only kernel once its own warmup sweep count
        crosses the stepout quota (see :meth:`warmup`).  PRNG consumption
        is identical across all three modes."""
        if self.slice_kernel == "latent":
            return self._begin_coord_latent(key, beta, logw, j, ubatch)
        if self.is_angular:
            return self._begin_coord_elliptical(key, beta, logw, j, ubatch)
        if self.slice_kernel == "quantile":
            return self._begin_coord_quantile(key, beta, logw, j, ubatch,
                                              qloc=qloc)
        if self.slice_kernel == "doubling":
            return self._begin_coord_doubling(key, beta, logw, j, ubatch)
        dtype = self.dtype
        C = beta.shape[0]
        if ubatch is None:
            k_level, k_u, k_j = jax.random.split(key, 3)
            level = -jax.random.exponential(k_level, (C,), dtype=dtype)
            u = jax.random.uniform(k_u, (C,), dtype=dtype)
            uj = jax.random.uniform(k_j, (C,), dtype=dtype)
        else:
            # -Exp(1) from a uniform: log1p(-u) is exact for u in [0, 1)
            level = jnp.log1p(-ubatch[:, 0])
            u = ubatch[:, 1]
            uj = ubatch[:, 2]
        w = jnp.exp(jnp.take_along_axis(logw, j[:, None], axis=1)[:, 0])
        b0 = jnp.take_along_axis(beta, j[:, None], axis=1)[:, 0]
        L = b0 - w * u
        R = L + w
        lp0 = jnp.asarray(self._coord_lp(beta, j, b0), dtype)
        zero = jnp.zeros((C,), jnp.int32)
        if isinstance(shrink_only, bool) and shrink_only:
            J = zero
            K = zero
            phase = jnp.ones((C,), jnp.int32)
            xprop = L + (R - L) * uj  # first shrink proposal
        elif isinstance(shrink_only, bool):
            J = jnp.floor(uj * self.max_stepouts).astype(jnp.int32)
            K = (self.max_stepouts - 1) - J
            phase = zero
            xprop = L
        else:  # per-lane (C,) bool: select between the two register sets
            so = shrink_only
            J_full = jnp.floor(uj * self.max_stepouts).astype(jnp.int32)
            J = jnp.where(so, 0, J_full)
            K = jnp.where(so, 0, (self.max_stepouts - 1) - J_full)
            phase = so.astype(jnp.int32)
            xprop = jnp.where(so, L + (R - L) * uj, L)
        return dict(
            level=level, L=L, R=R, budL=J, budR=K, b0=b0, lp0=lp0, w=w,
            xprop=xprop, phase=phase, stepdir=zero, n_shrink=zero,
        )

    def _begin_coord_latent(self, key, beta, logw, j, ubatch=None):
        """Latent-slice coordinate begin (Li & Walker 2020; lockstep
        reference ops/slice_kernels.py slice_latent, qslice::slice_latent).

        Reads the carried bracket width s = exp(logw[c, j]) from the LAST
        visit of this coordinate, draws the latent midpoint
        l ~ U(b0 - s/2, b0 + s/2), refreshes s' = 2|l - b0| + Exp(rate)
        and opens the shrink-only bracket (l - s'/2, l + s'/2).  Returns
        the standard register dict plus ``logw_j`` = log s' for the caller
        to commit into the logw buffer (the automaton's per-coordinate
        carried-state slot; stepping_out uses the same buffer for adapted
        widths).  Four uniforms per begin: level, midpoint, width Exp,
        first shrink proposal."""
        dtype = self.dtype
        C = beta.shape[0]
        if ubatch is None:
            k1, k2, k3, k4 = jax.random.split(key, 4)
            u_lvl = jax.random.uniform(k1, (C,), dtype=dtype)
            u_l = jax.random.uniform(k2, (C,), dtype=dtype)
            u_s = jax.random.uniform(k3, (C,), dtype=dtype)
            u_first = jax.random.uniform(k4, (C,), dtype=dtype)
        else:
            u_lvl, u_l, u_s, u_first = (
                ubatch[:, 0], ubatch[:, 1], ubatch[:, 2], ubatch[:, 3]
            )
        level = jnp.log1p(-u_lvl)  # -Exp(1), exact for u in [0, 1)
        s = jnp.exp(jnp.take_along_axis(logw, j[:, None], axis=1)[:, 0])
        b0 = jnp.take_along_axis(beta, j[:, None], axis=1)[:, 0]
        latent_l = b0 + s * (u_l - 0.5)
        s_new = 2.0 * jnp.abs(latent_l - b0) - jnp.log1p(-u_s) / self.rate
        L = latent_l - 0.5 * s_new
        R = latent_l + 0.5 * s_new
        lp0 = jnp.asarray(self._coord_lp(beta, j, b0), dtype)
        zero = jnp.zeros((C,), jnp.int32)
        return dict(
            level=level, L=L, R=R, budL=zero, budR=zero, b0=b0, lp0=lp0,
            w=s_new, xprop=L + (R - L) * u_first,
            phase=jnp.ones((C,), jnp.int32), stepdir=zero, n_shrink=zero,
            logw_j=jnp.log(s_new),
        )

    def ellipse_point(self, b0, nu, theta):
        """The elliptical proposal map: x(theta) on the ellipse through
        the current point b0 and the auxiliary draw nu around mu
        (Murray et al. 2010; lockstep slice_elliptical's ``point``)."""
        mu = self.ell_mu
        return (
            (b0 - mu) * jnp.cos(theta) + (nu - mu) * jnp.sin(theta) + mu
        )

    def _begin_coord_elliptical(self, key, beta, logw, j, ubatch=None):
        """Elliptical-slice coordinate begin (Murray, Adams & MacKay 2010;
        lockstep reference ops/slice_kernels.py slice_elliptical,
        qslice::slice_elliptical — reference usage R/mcmcglm.R:142-144).

        Draws the auxiliary nu ~ N(mu, sigma_eff^2) (carried in the ``w``
        register), the initial angle theta0 ~ U(0, 2pi) with bracket
        (theta0 - 2pi, theta0), and stores THETA in the xprop register —
        the pass maps it through :meth:`ellipse_point` before the fused
        evaluation and shrinks the bracket with a pivot at theta = 0
        (see the ``is_angular`` branches in ops/freerun_passes.py).

        genelliptical (Nishihara et al. 2014): sigma_eff = sigma /
        sqrt(lambda) with lambda | b0 ~ Gamma((df+1)/2, rate=(df +
        ((b0-mu)/sigma)^2)/2) drawn from a folded subkey — the t
        auxiliary as a per-visit normal scale mixture, exactly the
        lockstep slice_genelliptical composition."""
        dtype = self.dtype
        C = beta.shape[0]
        if ubatch is None:
            k1, k2, k3 = jax.random.split(key, 3)
            u_lvl = jax.random.uniform(k1, (C,), dtype=dtype)
            u_nu = jax.random.uniform(k2, (C,), dtype=dtype)
            u_th = jax.random.uniform(k3, (C,), dtype=dtype)
        else:
            u_lvl, u_nu, u_th = ubatch[:, 0], ubatch[:, 1], ubatch[:, 2]
        level = jnp.log1p(-u_lvl)  # -Exp(1)
        b0 = jnp.take_along_axis(beta, j[:, None], axis=1)[:, 0]
        sigma_eff = jnp.asarray(self.ell_sigma, dtype)
        if self.slice_kernel == "genelliptical":
            z2 = ((b0 - self.ell_mu) / self.ell_sigma) ** 2
            shape = (self.ell_df + 1.0) / 2.0
            rate = (self.ell_df + z2) / 2.0
            lam = (
                jax.random.gamma(
                    jax.random.fold_in(key, 0x9E11), shape, (C,),
                    dtype=dtype
                )
                / rate
            )
            sigma_eff = sigma_eff * lax.rsqrt(lam)
        # nu from a uniform via the normal quantile: one ubatch slot,
        # same batched-RNG discipline as the other kernels' begins
        from jax.scipy.special import ndtri

        u_nu = jnp.clip(u_nu, 1e-7, 1.0 - 1e-7)
        nu = self.ell_mu + sigma_eff * jnp.asarray(ndtri(u_nu), dtype)
        two_pi = jnp.asarray(2.0 * np.pi, dtype)
        theta0 = u_th * two_pi
        lp0 = jnp.asarray(self._coord_lp(beta, j, b0), dtype)
        zero = jnp.zeros((C,), jnp.int32)
        return dict(
            level=level, L=theta0 - two_pi, R=theta0, budL=zero, budR=zero,
            b0=b0, lp0=lp0, w=nu, xprop=theta0,
            phase=jnp.ones((C,), jnp.int32), stepdir=zero, n_shrink=zero,
        )

    # -- quantile pseudo-target maps (lockstep slice_quantile parity) ------

    def quantile_ppf(self, u, loc=None, scale=None):
        """Pseudo-target quantile function, with the lockstep kernel's
        eps-clip so endpoint proposals stay finite.  ``loc``/``scale``
        (optional per-lane arrays, broadcastable against ``u``) override
        the global pseudo-target — the ``pseudo_adapt`` path."""
        loc = self.q_loc if loc is None else loc
        scale = self.q_scale if scale is None else scale
        u = jnp.clip(u, 1e-7, 1.0 - 1e-7)
        if self.q_family == "normal":
            from jax.scipy.special import ndtri

            return loc + scale * ndtri(u)
        return loc + scale * jnp.tan(jnp.pi * (u - 0.5))

    def quantile_cdf(self, x, loc=None, scale=None):
        loc = self.q_loc if loc is None else loc
        scale = self.q_scale if scale is None else scale
        if self.q_family == "normal":
            return jax.scipy.stats.norm.cdf(x, loc, scale)
        return 0.5 + jnp.arctan((x - loc) / scale) / jnp.pi

    def quantile_logpdf(self, x, loc=None, scale=None):
        if loc is None and scale is None and self.q_family == "normal":
            # scalar-scale fast path: the log-normaliser is a python float
            z = (x - self.q_loc) / self.q_scale
            return -0.5 * z * z - float(
                np.log(self.q_scale) + 0.5 * np.log(2.0 * np.pi)
            )
        loc = self.q_loc if loc is None else loc
        scale = self.q_scale if scale is None else scale
        z = (x - loc) / scale
        if self.q_family == "normal":
            return (
                -0.5 * z * z - jnp.log(scale)
                - float(0.5 * np.log(2.0 * np.pi))
            )
        return -jnp.log(jnp.pi * scale * (1.0 + z * z))

    def _begin_coord_quantile(self, key, beta, logw, j, ubatch=None,
                              qloc=None):
        """Quantile-slice coordinate begin (Heiner, Johnson & Waller 2024;
        lockstep reference ops/slice_kernels.py slice_quantile,
        qslice::slice_quantile).

        The transformed target h(u) = f(F^-1(u)) / psi(F^-1(u)) is slice-
        sampled by pure shrinkage on the unit interval: bracket (0, 1),
        pivot u0 = F(b0) (carried in the ``w`` register), proposals mapped
        through :meth:`quantile_ppf` and the pseudo-density correction
        psi(b0)/psi(x) folded into the slice comparison by the pass.

        ``pseudo_adapt``: the coordinate's pseudo-target is read from the
        per-(chain, coordinate) buffers — loc from ``qloc``, scale from
        ``exp(logw)`` — so u0 pivots at the ADAPTED CDF of b0; the pass
        gathers the same (c, j) values for its ppf/logpdf maps, and the
        buffers only ever change at this lane's own commit, so loc/scale
        are constant across a coordinate episode (the within-episode
        invariance a slice kernel requires)."""
        dtype = self.dtype
        C = beta.shape[0]
        if ubatch is None:
            k1, k2 = jax.random.split(key, 2)
            u_lvl = jax.random.uniform(k1, (C,), dtype=dtype)
            u_first = jax.random.uniform(k2, (C,), dtype=dtype)
        else:
            u_lvl, u_first = ubatch[:, 0], ubatch[:, 1]
        level = jnp.log1p(-u_lvl)  # -Exp(1), on the h scale
        b0 = jnp.take_along_axis(beta, j[:, None], axis=1)[:, 0]
        if self.q_adapt:
            loc = jnp.take_along_axis(qloc, j[:, None], axis=1)[:, 0]
            scale = jnp.exp(
                jnp.take_along_axis(logw, j[:, None], axis=1)[:, 0]
            )
            u0 = jnp.clip(
                jnp.asarray(self.quantile_cdf(b0, loc, scale), dtype),
                1e-7, 1.0 - 1e-7,
            )
        else:
            u0 = jnp.clip(
                jnp.asarray(self.quantile_cdf(b0), dtype), 1e-7, 1.0 - 1e-7
            )
        lp0 = jnp.asarray(self._coord_lp(beta, j, b0), dtype)
        zero = jnp.zeros((C,), jnp.int32)
        return dict(
            level=level, L=jnp.zeros((C,), dtype), R=jnp.ones((C,), dtype),
            budL=zero, budR=zero, b0=b0, lp0=lp0, w=u0, xprop=u_first,
            phase=jnp.ones((C,), jnp.int32), stepdir=zero, n_shrink=zero,
        )

    def _begin_coord_doubling(self, key, beta, logw, j, ubatch=None):
        """Doubling-slice coordinate begin (Neal 2003 Fig. 4; lockstep
        reference ops/slice_kernels.py slice_doubling — the qslice
        algorithm the reference advertises through R/mcmcglm.R:35-39).

        Randomly positions the width-w interval around b0 and schedules
        the INITIAL LEFT endpoint as the first evaluation; the expansion
        then proceeds one endpoint evaluation per pass, doubling a
        coin-chosen side while either endpoint is above the level
        (ops/freerun_doubling.py).  ``budL`` carries the remaining
        doubling budget p; the back-test registers start cleared.  Two
        uniforms per begin: level, interval position.  Widths are the
        fixed user ``w`` (no adaptation — lockstep parity; doubling's
        geometric expansion is itself the defence against a badly
        sized w)."""
        dtype = self.dtype
        C = beta.shape[0]
        if ubatch is None:
            k1, k2 = jax.random.split(key, 2)
            u_lvl = jax.random.uniform(k1, (C,), dtype=dtype)
            u_pos = jax.random.uniform(k2, (C,), dtype=dtype)
        else:
            u_lvl, u_pos = ubatch[:, 0], ubatch[:, 1]
        level = jnp.log1p(-u_lvl)  # -Exp(1), exact for u in [0, 1)
        w = jnp.exp(jnp.take_along_axis(logw, j[:, None], axis=1)[:, 0])
        b0 = jnp.take_along_axis(beta, j[:, None], axis=1)[:, 0]
        L = b0 - w * u_pos
        R = L + w
        lp0 = jnp.asarray(self._coord_lp(beta, j, b0), dtype)
        zero = jnp.zeros((C,), jnp.int32)
        false = jnp.zeros((C,), bool)
        return dict(
            level=level, L=L, R=R,
            budL=jnp.full((C,), self.max_doublings, jnp.int32), budR=zero,
            b0=b0, lp0=lp0, w=w, xprop=L,
            phase=zero, stepdir=zero, n_shrink=zero,
            x1=b0, eL=L, eR=R, e_aL=false, e_aR=false,
            hatL=L, hatR=R, h_aL=false, h_aR=false, dsep=false,
        )

    def init(self, key, n_chains: int, beta0=None) -> FreeRunState:
        """Initial state for ``n_chains`` chains.  ``beta0`` (optional,
        (d,) or (C, d)) overrides the default prior draw — e.g. the prior
        mean or a penalised-MLE point for very wide models, where a raw
        prior draw starts O(sqrt(d)) from the posterior bulk (the
        R reference always inits from the prior, R/mcmcglm.R:200-213)."""
        if beta0 is not None:
            beta0 = jnp.asarray(beta0, self.dtype)
            if beta0.ndim == 1:
                beta0 = jnp.broadcast_to(beta0[None, :], (n_chains, self.d))
        return jax.jit(partial(self._init, n_chains=n_chains))(key, beta0)

    def _init(self, key, beta0=None, *, n_chains: int):
        dtype = self.dtype
        C = n_chains
        k_init, k_coord, k_run = jax.random.split(key, 3)
        beta = jax.vmap(self.prior.sample_beta)(
            jax.random.split(k_init, C)
        ).astype(dtype)
        if beta0 is not None:
            beta = jnp.asarray(beta0, dtype)
        eta = jax.vmap(lambda b: matvec(b, self.Xt))(beta)
        if self.offset is not None:
            eta = eta + self.offset[None, :]
        ld0 = self._ld_eta(eta, self.y, self.extra)
        if self.eval_cache == "scalar":
            ld0 = self.reduce_fn(ld0)
        w_init = (
            1.0 / self.rate if self.slice_kernel == "latent"
            else self.q_scale if self.q_adapt
            else self.w0
        )
        logw = jnp.full((C, self.d), jnp.log(jnp.asarray(w_init, dtype)))
        qloc = (
            jnp.full((C, self.d), jnp.asarray(self.q_loc, dtype))
            if self.q_adapt else None
        )
        j0 = jnp.zeros((C,), jnp.int32)
        reg = self._begin_coord(k_coord, beta, logw, j0, shrink_only=False,
                                qloc=qloc)
        logw_j = reg.pop("logw_j", None)
        if logw_j is not None:  # latent: commit the refreshed width
            logw = self._commit_row(logw, j0, logw_j)
        if qloc is not None:
            reg["qloc"] = qloc
        return self.state_cls(
            beta=beta, eta=eta, ld0=ld0, key=k_run, logw=logw,
            j=j0, nev=jnp.zeros((C,), jnp.int32),
            **reg,
        )

    def _commit_row(self, arr, j, val, gate=None):
        """arr[c, j_c] = val_c (for lanes where ``gate``), as a one-hot
        dense select instead of a scatter: a plain ~2x(C, d) elementwise
        stream that fuses with its neighbours, where a per-pass scatter
        is a kernel of its own."""
        hit = (
            lax.broadcasted_iota(jnp.int32, (1, arr.shape[1]), 1)
            == j[:, None]
        )
        if gate is not None:
            hit = hit & gate[:, None]
        return jnp.where(hit, val[:, None], arr)

    @staticmethod
    def _sweep_buffers(draws, nevbuf, rows, slot, beta, nev_new, sweep_done):
        """Record completed sweeps into the draws/nevbuf buffers.

        The drop-mode scatters only change anything on passes where some
        lane finished a sweep — for most passes every slot is OOB and the
        scatter is a pure no-op that still streams its (C, d) update
        tensor.  Gating them under lax.cond
        skips that traffic on no-completion passes; on completion passes
        the scatter is bitwise the previous behavior.  nevbuf records
        each chain's cumulative evals at sweep completion -> honest
        per-sweep counts (diff on the host)."""

        def write(d_nb):
            d_, nb_ = d_nb
            return (d_.at[rows, slot].set(beta, mode="drop"),
                    nb_.at[rows, slot].set(nev_new, mode="drop"))

        return lax.cond(jnp.any(sweep_done), write, lambda d_nb: d_nb,
                        (draws, nevbuf))

    # -- the pass (ops/freerun_passes.py) ---------------------------------

    def _pass(self, s, sweep_count, draws, nevbuf, n_sweeps, adapt,
              shrink_only, stepout_sweeps=None):
        """One target evaluation + automaton advance for every chain."""
        from .ops.freerun_passes import run_pass

        return run_pass(self, s, sweep_count, draws, nevbuf, n_sweeps,
                        adapt, shrink_only, stepout_sweeps)

    def _pass_spec(self, s, sweep_count, draws, nevbuf, n_sweeps, adapt,
                   shrink_only, stepout_sweeps=None):
        """K target evaluations + automaton advance per chain per pass."""
        from .ops.freerun_passes import run_pass_spec

        return run_pass_spec(self, s, sweep_count, draws, nevbuf, n_sweeps,
                             adapt, shrink_only, stepout_sweeps)

    def _pass_conj(self, s, sweep_count, draws, nevbuf, n_sweeps, adapt,
                   shrink_only, stepout_sweeps=None):
        """One exact conjugate coordinate draw per chain per pass."""
        from .ops.freerun_conjugate import run_pass_conj

        return run_pass_conj(self, s, sweep_count, draws, nevbuf, n_sweeps,
                             adapt, shrink_only, stepout_sweeps)

    def _pass_doubling(self, s, sweep_count, draws, nevbuf, n_sweeps, adapt,
                       shrink_only, stepout_sweeps=None):
        """One evaluation + doubling-automaton advance per chain."""
        from .ops.freerun_doubling import run_pass_doubling

        return run_pass_doubling(self, s, sweep_count, draws, nevbuf,
                                 n_sweeps, adapt, shrink_only,
                                 stepout_sweeps)

    def _step_fn(self):
        """The per-pass kernel for this engine's configuration."""
        if self.coord_sampler == "conjugate":
            return self._pass_conj
        if self.slice_kernel == "doubling":
            return self._pass_doubling
        return self._pass_spec if self.spec_k > 1 else self._pass

    # -- runs -------------------------------------------------------------

    def _run(self, state: FreeRunState, n_sweeps: int, adapt: bool,
             shrink_only: bool, stepout_sweeps=None):
        C = state.beta.shape[0]
        draws0 = jnp.zeros((C, n_sweeps, self.d), self.dtype)
        nevbuf0 = jnp.zeros((C, n_sweeps), jnp.int32)

        def cond(carry):
            _, sweep_count, _, _ = carry
            return jnp.any(sweep_count < n_sweeps)

        step = self._step_fn()

        def body(carry):
            s, sweep_count, draws, nevbuf = carry
            return step(s, sweep_count, draws, nevbuf, n_sweeps, adapt,
                        shrink_only, stepout_sweeps)

        state, _, draws, nevbuf = lax.while_loop(
            cond, body, (state, jnp.zeros((C,), jnp.int32), draws0, nevbuf0)
        )
        return state, draws, nevbuf

    def _run_pass_block(self, state: FreeRunState, sweep_count, *,
                        n_sweeps: int, n_passes: int, adapt: bool,
                        shrink_only: bool, stepout_sweeps=None,
                        draws=None, nevbuf=None):
        """Advance by at most ``n_passes`` device passes toward a quota of
        ``n_sweeps`` completed sweeps per chain.

        Unlike :meth:`_run`, the loop condition also bounds the pass count
        and ``sweep_count`` is a carried argument, so a long run can be
        split into dispatches of bounded wall-clock.  Sweep-granular
        dispatching pays the cross-chain sweep tail (the slowest lane's evaluation
        count) on EVERY dispatch; a pass-granular dispatch pays it once at
        the end of the whole run — the pod-scale mode.

        ``draws``/``nevbuf`` optionally carry REAL collection buffers
        ((C, n_sweeps, d) / (C, n_sweeps)) across dispatches (the
        :meth:`run_passes` collection mode); when None, dummy 1-slot
        buffers make this a pure advance (the warmup mode)."""
        C = state.beta.shape[0]
        collect = draws is not None
        if draws is None:
            draws = jnp.zeros((C, 1, self.d), self.dtype)
        if nevbuf is None:
            nevbuf = jnp.zeros((C, draws.shape[1]), jnp.int32)

        def cond(carry):
            _, sweep_count, _, _, p = carry
            return jnp.any(sweep_count < n_sweeps) & (p < n_passes)

        step = self._step_fn()

        def body(carry):
            s, sweep_count, draws, nevbuf, p = carry
            s, sweep_count, draws, nevbuf = step(
                s, sweep_count, draws, nevbuf, n_sweeps, adapt, shrink_only,
                stepout_sweeps
            )
            return s, sweep_count, draws, nevbuf, p + 1

        state, sweep_count, draws, nevbuf, _ = lax.while_loop(
            cond, body,
            (state, sweep_count, draws, nevbuf, jnp.zeros((), jnp.int32)),
        )
        if collect:
            return state, sweep_count, draws, nevbuf
        return state, sweep_count

    def run_passes(self, state: FreeRunState, sweep_count, draws, nevbuf,
                   n_sweeps: int, n_passes: int):
        """Pass-bounded, barrier-free sampling collection (pod mode).

        Advances at most ``n_passes`` device passes toward ``n_sweeps``
        completed sweeps per chain, recording every completed sweep's
        draw into the CARRIED ``draws`` (C, n_sweeps, d) buffer (device-
        resident across dispatches; pass ``None`` to allocate).  Unlike
        chunked :meth:`run` / thin=1 :meth:`run_thinned` — which impose a
        full cross-chain barrier at every chunk boundary, paying the
        slowest lane's tail per chunk — chains here run FREELY across
        sweep boundaries for the whole collection; the single tail is paid once at the very end.
        Call repeatedly until ``(sweep_count >= n_sweeps).all()``:

            sc, draws, nevbuf = None, None, None
            while True:
                state, sc, draws, nevbuf = eng.run_passes(
                    state, sc, draws, nevbuf, n_sweeps, n_passes)
                if (np.asarray(sc) >= n_sweeps).all():
                    break

        Identical in law to :meth:`run` (same per-pass kernel; same
        drop-mode sweep recording)."""
        C = int(state.beta.shape[0])
        if sweep_count is None:
            sweep_count = jnp.zeros((C,), jnp.int32)
        if draws is None:
            draws = jnp.zeros((C, n_sweeps, self.d), self.dtype)
        if nevbuf is None:
            nevbuf = jnp.zeros((C, n_sweeps), jnp.int32)
        key_ = ("run_passes", n_sweeps, n_passes, C)
        fn = self._run_cache.get(key_)
        if fn is None:
            # draws rides positionally WITH donation: carried as an
            # undonated kwarg, each dispatch holds input + output copies of
            # the (C, n_sweeps, d) buffer (~2x peak, ~5 GB at the
            # C=4096/n_sweeps=150/d=1000 pod scale) — the sharded variant
            # donates it for exactly this reason (freerun_sharded.py).
            def impl(st, sc, dr, nb):
                return self._run_pass_block(
                    st, sc, n_sweeps=n_sweeps, n_passes=n_passes,
                    adapt=False, shrink_only=self.shrink_only,
                    draws=dr, nevbuf=nb,
                )

            fn = jax.jit(impl, donate_argnums=(2,))
            self._run_cache[key_] = fn
        return fn(state, sweep_count, draws, nevbuf)

    def _auto_stepout(self, n_sweeps: int) -> int:
        """Default stepping-out quota for two-phase warmup: a few full
        stepping-out sweeps to locate each coordinate's scale, then the
        shrink-only kernel (with adaptation continuing) for the rest.
        Rationale: a full stepping-out coordinate costs >= 3 device passes
        (left endpoint battery + right endpoint battery + >= 1 shrink)
        even when widths are already well-sized, vs ~1 pass shrink-only —
        and the Robbins-Monro width pull is identical in both modes, so
        only the first few sweeps (where w may be off by orders of
        magnitude and stepping-out's linear walk finds the scale in one
        visit) benefit from the full schedule.  Warmup draws are
        discarded, so the kernel mix does not touch the collected chain's
        law — and the shrink-only kernel is itself exact (m=1)."""
        return min(n_sweeps, max(3, min(10, n_sweeps // 5)))

    def warmup_passes(self, state: FreeRunState, sweep_count, n_sweeps: int,
                      n_passes: int, stepout_sweeps: Optional[int] = None):
        """Advance adaptive warmup by at most ``n_passes`` device passes
        toward ``n_sweeps`` completed warmup sweeps per chain.

        Returns ``(state, sweep_count)``; call repeatedly (passing the
        returned ``sweep_count`` back in) until
        ``(sweep_count >= n_sweeps).all()``.  Identical in law to a single
        ``warmup(state, n_sweeps)`` call — same per-pass kernel, same PRNG
        consumption — but each dispatch's wall-clock is bounded by the pass
        budget instead of by the slowest chain's sweep, without paying the
        cross-chain tail once per sweep.

        ``stepout_sweeps`` as in :meth:`warmup` (two-phase schedule; the
        per-lane switch keys off the carried ``sweep_count``, so chunked
        pass-bounded dispatches see the same schedule as one big call)."""
        if stepout_sweeps is None:
            stepout_sweeps = self._auto_stepout(n_sweeps)
        key_ = ("passes", n_sweeps, n_passes, int(stepout_sweeps),
                int(state.beta.shape[0]))
        fn = self._run_cache.get(key_)
        if fn is None:
            fn = jax.jit(partial(
                self._run_pass_block, n_sweeps=n_sweeps, n_passes=n_passes,
                adapt=True, shrink_only=False,
                stepout_sweeps=int(stepout_sweeps),
            ))
            self._run_cache[key_] = fn
        return fn(state, sweep_count)

    def run(self, state: FreeRunState, n_sweeps: int):
        """Advance every chain by ``n_sweeps`` completed Gibbs sweeps.

        Returns (state, draws (C, n_sweeps, d), nev_at_sweep (C, n_sweeps))
        — nev_at_sweep[c, s] is chain c's CUMULATIVE target-evaluation
        count at the completion of its s-th sweep in this run, so honest
        per-sweep counts are its first difference (against the pre-run
        ``state.nev``)."""
        return self._run_cached(state, n_sweeps, adapt=False,
                                shrink_only=self.shrink_only)

    # -- thinned collection with streaming moments (pod-scale mode) --------

    def _run_thinned_impl(self, state: FreeRunState, moments, n_outer: int,
                          thin: int, shrink_only: bool, ess=None):
        """lax.scan over n_outer blocks of `thin` free-running sweeps each;
        every block's draws are merged into per-chain Welford moments on
        device (chunk-merge form: within-block centering keeps the update
        float32-safe) and only the block's LAST draw is retained — memory is
        O(C*(n_outer + thin)*d) instead of O(C*n_outer*thin*d).  The merge
        runs once per `thin` sweeps, ~3*d passes of (C, n) traffic each, so
        its (C, d)-sized streams are free by comparison.

        ``ess`` optionally carries a :class:`~mcmcglm_tpu.parallel.pooled.
        ESSState`: each kept draw also feeds the on-device streaming
        autocovariance accumulator (SURVEY §8.3 — min-ESS without ever
        gathering the (C, K, d) draw tensor to host)."""
        from .parallel.pooled import update_ess

        def outer(carry, _):
            st, (cnt, mean, m2), es = carry
            st, draws, _ = self._run(st, thin, adapt=False,
                                     shrink_only=shrink_only)
            mu_c = jnp.mean(draws, axis=1)  # (C, d)
            m2_c = jnp.sum((draws - mu_c[:, None, :]) ** 2, axis=1)
            cnt2 = cnt + float(thin)
            delta = mu_c - mean
            ratio = (float(thin) / cnt2)[:, None]
            mean2 = mean + delta * ratio
            m22 = m2 + m2_c + delta * delta * (cnt * float(thin) / cnt2)[:, None]
            if es is not None:
                es = update_ess(es, draws[:, -1])
            return (st, (cnt2, mean2, m22), es), draws[:, -1]

        (state, mom, ess), kept = lax.scan(
            outer, (state, moments, ess), None, length=n_outer
        )
        kept = jnp.swapaxes(kept, 0, 1)  # (n_outer, C, d) -> (C, n_outer, d)
        return state, mom, kept, ess

    def run_thinned(self, state: FreeRunState, n_outer: int, thin: int,
                    moments=None, ess: bool = False, ess_max_lag: int = 64):
        """Advance chains by ``n_outer * thin`` sweeps, keeping every
        ``thin``-th draw and streaming per-chain Welford moments on device —
        the pod-scale collection mode (mirrors CGGibbs.run_thinned; feeds
        parallel.pooled.pooled_summary).

        Returns (state, moments, draws (C, n_outer, d), n_evals (C,)) —
        ``moments`` is a ChainMoments with per-chain count (C,), and
        ``n_evals`` is the cumulative per-chain evaluation counter.

        ``ess=True`` additionally streams the split-chain autocovariance
        accumulator on device (parallel.pooled.ESSState; window
        ``ess_max_lag``) and returns it as a FIFTH element — feed it to
        ``pooled.ess_from_state`` for min-ESS with only (d,)-sized host
        transfers (SURVEY §8.3)."""
        from .parallel.pooled import ChainMoments, init_ess

        C = int(state.beta.shape[0])
        if moments is None:
            moments = ChainMoments(
                count=jnp.zeros((C,), self.dtype),
                mean=jnp.zeros((C, self.d), self.dtype),
                m2=jnp.zeros((C, self.d), self.dtype),
            )
        ess_state = (
            init_ess(C, self.d, planned=n_outer, max_lag=ess_max_lag,
                     dtype=self.dtype)
            if ess else None
        )
        key_ = ("thinned", n_outer, thin, self.shrink_only, C, bool(ess),
                ess_max_lag if ess else None)
        fn = self._run_cache.get(key_)
        if fn is None:
            def impl(st, mom, es):
                st, (cnt, mean, m2), draws, es = self._run_thinned_impl(
                    st, (mom.count, mom.mean, mom.m2), n_outer, thin,
                    self.shrink_only, ess=es,
                )
                return st, ChainMoments(cnt, mean, m2), draws, es

            fn = jax.jit(impl)
            self._run_cache[key_] = fn
        state, moments, draws, ess_state = fn(state, moments, ess_state)
        if ess:
            return state, moments, draws, state.nev, ess_state
        return state, moments, draws, state.nev

    def warmup(self, state: FreeRunState, n_sweeps: int,
               stepout_sweeps: Optional[int] = None):
        """Adaptive warmup: per-(chain, coordinate) slice widths pulled
        toward ~adapt_c x the accepted move (Robbins-Monro in log space),
        FROZEN afterwards — identical policy to CGGibbs.warmup.

        Two-phase schedule: the first ``stepout_sweeps`` sweeps (default
        :meth:`_auto_stepout`; round-3 warmup used the full schedule
        throughout and was ~4x the per-sweep sampling cost at pod scale)
        run the full stepping-out kernel; the rest run the cheap
        shrink-only kernel with adaptation continuing.  Pass
        ``stepout_sweeps=n_sweeps`` for the round-3 behavior, ``0`` for
        shrink-only-throughout (e.g. resuming an already-adapted state)."""
        if stepout_sweeps is None:
            stepout_sweeps = self._auto_stepout(n_sweeps)
        return self._run_cached(state, n_sweeps, adapt=True,
                                shrink_only=False,
                                stepout_sweeps=int(stepout_sweeps))

    def _run_cached(self, state, n_sweeps, adapt, shrink_only,
                    stepout_sweeps=None):
        key_ = (n_sweeps, adapt, shrink_only, stepout_sweeps,
                int(state.beta.shape[0]))
        fn = self._run_cache.get(key_)
        if fn is None:
            fn = jax.jit(partial(self._run, n_sweeps=n_sweeps, adapt=adapt,
                                 shrink_only=shrink_only,
                                 stepout_sweeps=stepout_sweeps))
            self._run_cache[key_] = fn
        state, draws, nevbuf = fn(state)
        return state, draws, nevbuf

    def sample(self, key, n_samples: int, n_chains: int = 1, chunk_size: int = 0,
               progress=None):
        """Init from the prior then collect n_samples sweeps per chain.
        Returns (betas (C, n_samples + 1, d), n_evals (C,), state) — row 0
        is the init draw, matching CGGibbs.sample."""
        state = self.init(key, n_chains)
        parts = [np.asarray(state.beta)[:, None, :]]
        if chunk_size <= 0:
            chunk_size = n_samples
        done = 0
        while done < n_samples:
            step = min(chunk_size, n_samples - done)
            state, draws, _ = self.run(state, step)
            parts.append(np.asarray(draws))
            done += step
            if progress is not None:
                progress(done, n_samples)
        return np.concatenate(parts, axis=1), np.asarray(state.nev), state
