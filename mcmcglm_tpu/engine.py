"""The CGGibbs sampling engine: coordinate-wise slice-within-Gibbs in JAX.

Re-design of the reference's hot loop (R/mcmcglm.R:226-274):
the R double loop (k over samples, j over coordinates) becomes

    lax.scan over sweeps
      └─ lax.scan over coordinates
           └─ bounded while_loop slice kernel (ops/slice_kernels.py)
                └─ fused elementwise + reduction over observations

vmapped over a chain axis — chains are the data-parallel axis of this
workload (the reference has no chain parallelism at all; its only
parallelism is process-level experiment parallelism, R/slice_utilities.R:72-79).

Key design decisions:

  * The design matrix is stored transposed, ``Xt`` of shape (d, n): the
    coordinate scan consumes contiguous (n,) rows, so each slice evaluation
    streams a contiguous vector — ideal memory access (the reference
    gathers a column ``X[, j]`` per coordinate, R/mcmcglm.R:268).
  * State per chain is (beta, eta, ld_cur, kernel_state, key):
    eta is carried and updated incrementally in O(n) per coordinate (the
    CGGibbs trick, R/glm_utils.R:126-132); ld_cur caches per-observation log
    densities at the current state, making slice evaluations *relative* —
    O(1)-magnitude comparisons that are float32-safe (see
    models/potential.py).
  * Only beta samples are collected; the reference retains the full
    {beta, eta, mu} history for every iteration (O(K·(n+d)) memory,
    R/mcmcglm.R:188,227) — deliberately not copied (SURVEY.md §7.5).
  * The "naive" linear-predictor mode recomputes eta with a full matvec per
    slice evaluation, kept for benchmarking the CGGibbs claim
    (R/glm_utils.R:206-208, linear_predictor_calc="naive") — on a device
    that matvec is a (chains, d) @ (d, n) matmul.
  * The conjugate "normal-normal" coordinate sampler (R/sampling.R:19-35) is
    implemented against the posterior precision matrix so each conditional
    is an O(d) row product, and — unlike the reference, which solves two
    O(d^3) linear systems per coordinate draw (R/sampling.R:27-32) — all
    factorisations are precomputed once.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Mapping, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .models.families import Family, check_family
from .utils.linalg import matvec
from .models.potential import make_coord_target
from .models.priors import BetaPrior
from .ops.slice_kernels import SliceKernel, get_slice_kernel

__all__ = ["EngineConfig", "ChainState", "CGGibbs"]

# kernels whose per-coordinate width w may be warmup-adapted (log w carried
# in the kernel-state slot)
_ADAPTIVE_KERNELS = ("stepping_out", "stepping_out_batched")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static sampler configuration (mirrors the reference's match.arg enums,
    R/mcmcglm.R:152-163)."""

    sample_method: str = "slice_sampling"  # or "normal-normal"
    linear_predictor_calc: str = "update"  # or "naive"
    slice_kernel: Any = "stepping_out"
    dtype: Any = jnp.float32

    def __post_init__(self):
        if self.sample_method not in ("slice_sampling", "normal-normal"):
            raise ValueError(
                "sample_method must be 'slice_sampling' or 'normal-normal'"
            )
        if self.linear_predictor_calc not in ("update", "naive"):
            raise ValueError("linear_predictor_calc must be 'update' or 'naive'")


class ChainState(NamedTuple):
    beta: jax.Array  # (d,) per chain
    eta: jax.Array  # (n,) per chain — carried linear predictor
    ld_cur: jax.Array  # (n,) per chain — cached per-obs log densities
    kernel_state: jax.Array  # (d,) per chain — carried slice-kernel state
    key: jax.Array  # PRNG key per chain
    chain_tuning: dict  # per-chain tuning scalars (e.g. a swept slice width)


class CGGibbs:
    """Compiled CGGibbs sampler over a fixed (X, y, family, prior) problem.

    Parameters
    ----------
    X : (n, d) design matrix (the reference's model matrix,
        R/family_data_processing.R:31-33).
    y : (n,) response vector.
    family : Family | str | factory — normalised via check_family.
    prior : BetaPrior over the d coefficients.
    extra : the ``log_likelihood_extra_args`` channel (R/mcmcglm.R:151).
    tuning : slice-kernel tuning parameters (the reference's ``...``
        passthrough to qslice_fun, R/mcmcglm.R:155,258-261), e.g. {"w": 0.5}.
    """

    def __init__(
        self,
        X,
        y,
        family,
        prior: BetaPrior,
        extra: Optional[Mapping] = None,
        config: EngineConfig = EngineConfig(),
        tuning: Optional[Mapping] = None,
        reduce_fn=None,
        chain_tuning_names: tuple = (),
        obs_weights=None,
        offset=None,
    ):
        self.config = config
        dtype = config.dtype
        self.family: Family = check_family(family)
        self.prior = prior
        X = jnp.asarray(X, dtype)
        self.n, self.d = X.shape
        # fixed additive eta component (R's offset() model-frame term);
        # the incremental coordinate updates never touch it — it only
        # enters eta's initialisation (and full recomputes on the naive path)
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
        self.Xt = jnp.asarray(X.T)  # (d, n): row per coordinate (XLA owns layout)
        self.y = jnp.asarray(y, dtype).reshape(-1)
        self.extra = {k: jnp.asarray(v, dtype) for k, v in dict(extra or {}).items()}
        # string-valued tuning (e.g. quantile's pseudo_family="cauchy")
        # passes through untouched; numeric tuning is device-typed
        self.tuning = {
            k: (v if isinstance(v, str) else jnp.asarray(v, dtype))
            for k, v in dict(tuning or {}).items()
        }
        if obs_weights is not None:
            w = jnp.asarray(obs_weights, dtype).reshape(-1)
            if w.shape[0] != self.n:
                raise ValueError(
                    f"obs_weights length {w.shape[0]} != n observations {self.n}"
                )
            self.obs_weights = w
            if reduce_fn is None:
                reduce_fn = lambda t: jnp.sum(t * w, axis=-1)  # noqa: E731
        else:
            self.obs_weights = None
        self.reduce_fn = reduce_fn or (lambda t: jnp.sum(t, axis=-1))

        if config.sample_method == "slice_sampling":
            self.kernel: SliceKernel = get_slice_kernel(config.slice_kernel)
            missing = [
                k
                for k in self.kernel.required
                if k not in self.tuning and k not in chain_tuning_names
            ]
            if missing:
                # parity with the reference's tuning-arg validation
                # (R/mcmcglm.R:167-169)
                raise ValueError(
                    "A tuning parameter for the slice kernel is missing: "
                    f"{missing} required by {self.kernel.name!r}. For the default "
                    "'stepping_out' a slice width w needs to be provided"
                )
        else:
            self.kernel = None
            self._prepare_conjugate()

        self._target_factory = make_coord_target(
            self.family, self.prior, self.y, self.extra, reduce_fn=self.reduce_fn
        )
        self._init_jit = jax.jit(jax.vmap(self._init_one))
        self._run_cache: dict = {}
        self._w_adapted = False  # set by warmup(): kernel_state carries log w
        self._adapt_rate = 0.08

    # -- initialisation ----------------------------------------------------

    def _init_one(self, key, chain_tuning) -> ChainState:
        """Init from a prior draw; eta0 = X beta0 is the ONLY full matvec in
        the whole run (reference: R/mcmcglm.R:200-216)."""
        dtype = self.config.dtype
        k_init, k_run = jax.random.split(key)
        beta = jnp.asarray(self.prior.sample_beta(k_init), dtype)
        eta = matvec(beta, self.Xt)
        if self.offset is not None:
            eta = eta + self.offset
        ld = self.family.log_density_eta(eta, self.y, self.extra)
        if self.kernel is not None:
            kstate = jnp.full(
                (self.d,),
                self.kernel.init_state({**self.tuning, **chain_tuning}),
                dtype,
            )
        else:
            kstate = jnp.zeros((self.d,), dtype)
        return ChainState(beta, eta, ld, kstate, k_run, chain_tuning)

    def init(self, key, n_chains: int, chain_tuning: Optional[Mapping] = None) -> ChainState:
        """Build the vmapped initial state.  ``chain_tuning`` optionally maps
        tuning names to (n_chains,) arrays — per-chain tuning values (used by
        the single-compile sweep harness, sweep.py)."""
        keys = jax.random.split(key, n_chains)
        ct = {
            k: jnp.asarray(v, self.config.dtype)
            for k, v in dict(chain_tuning or {}).items()
        }
        for k, v in ct.items():
            if v.shape[:1] != (n_chains,):
                raise ValueError(
                    f"chain_tuning[{k!r}] must have leading dim n_chains={n_chains}"
                )
        return self._init_jit(keys, ct)

    # -- conjugate normal-normal path -------------------------------------

    def _prepare_conjugate(self):
        """Precompute the gaussian-gaussian posterior's mean and precision
        (reference computes these per coordinate draw, R/sampling.R:4-14;
        we factor once).  cov_post = (X'X/sigma^2 + cov_prior^{-1})^{-1},
        mu_post = cov_post X'y / sigma^2  (R/sampling.R:8-9)."""
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        X = self.Xt.T.astype(dtype)
        y = self.y.astype(dtype)
        if self.offset is not None:
            # gaussian identity-link: an offset shifts the response
            y = y - self.offset.astype(dtype)
        sigma = jnp.asarray(self.extra.get("sd", 1.0), dtype)
        cov_prior = jnp.asarray(self.prior.cov_beta(), dtype)
        # the conjugate oracle: full f32 products (a GPU may otherwise
        # run an f32 matmul in TF32, ~3 decimal digits)
        mm = partial(jnp.matmul, precision=lax.Precision.HIGHEST)
        if self.obs_weights is not None:
            W = self.obs_weights.astype(dtype)
            XtWX = mm((X * W[:, None]).T, X)
            XtWy = mm(X.T, W * y)
        else:
            XtWX = mm(X.T, X)
            XtWy = mm(X.T, y)
        prec_post = XtWX / sigma**2 + jnp.linalg.inv(cov_prior)
        cov_post = jnp.linalg.inv(prec_post)
        mu_post = mm(cov_post, XtWy) / sigma**2
        self._conj_mu = mu_post.astype(self.config.dtype)
        self._conj_prec = prec_post.astype(self.config.dtype)

    def _conjugate_draw(self, key, beta, j):
        """beta_j | beta_{-j} ~ N(mu_j - Q_j,-j (beta_-j - mu_-j)/Q_jj, 1/Q_jj)
        — the Schur-complement conditional (R/sampling.R:27-34) expressed via
        the precision matrix Q (note: the reference buggily passes the
        conditional *variance* as dist_normal's sd, R/sampling.R:32-34; we
        use the correct standard deviation — SURVEY.md §7.4)."""
        Q_row = self._conj_prec[j]
        q_jj = Q_row[j]
        r = beta - self._conj_mu
        off = jnp.dot(Q_row, r) - q_jj * r[j]
        mean = self._conj_mu[j] - off / q_jj
        sd = lax.rsqrt(q_jj)
        return mean + sd * jax.random.normal(key, (), dtype=self.config.dtype)

    # -- the sweep ---------------------------------------------------------

    def _coord_step(self, carry, xs, adapt=False):
        beta, eta, ld, kstate, key, chain_tuning = carry
        j, x_j = xs
        key, sub = jax.random.split(key)
        tuning = {**self.tuning, **chain_tuning}
        adaptive_w = adapt or self._w_adapted
        if adaptive_w and self.kernel is not None and self.kernel.name in _ADAPTIVE_KERNELS:
            # per-coordinate slice width lives in the kernel-state slot as
            # log w (see warmup()); frozen after adaptation
            tuning = dict(tuning)
            tuning["w"] = jnp.exp(kstate[j])

        if self.config.sample_method == "normal-normal":
            b_new = self._conjugate_draw(sub, beta, j)
            n_evals = jnp.zeros((), jnp.int32)
        elif self.config.linear_predictor_calc == "update":
            g = self._target_factory(beta, eta, ld, x_j, j)
            res = self.kernel(
                sub, beta[j], g, state=kstate[j], fx0=jnp.zeros((), self.config.dtype),
                **tuning,
            )
            b_new = res.x
            n_evals = res.n_evals
            kstate = kstate.at[j].set(jnp.asarray(res.state, kstate.dtype))
        else:  # naive: full matvec per slice evaluation (R/glm_utils.R:206-208)
            beta_j = beta[j]
            lp_cur = self.prior.coord_log_prob(beta, j, beta_j)
            ll_cur = self.reduce_fn(ld)

            def g(b):
                beta_new = beta.at[j].set(b)
                eta_new = matvec(beta_new, self.Xt)
                if self.offset is not None:
                    eta_new = eta_new + self.offset
                ll = self.reduce_fn(self.family.log_density_eta(eta_new, self.y, self.extra))
                lp = self.prior.coord_log_prob(beta, j, b)
                return (ll - ll_cur) + (lp - lp_cur)

            res = self.kernel(
                sub, beta_j, g, state=kstate[j], fx0=jnp.zeros((), self.config.dtype),
                **tuning,
            )
            b_new = res.x
            n_evals = res.n_evals
            kstate = kstate.at[j].set(jnp.asarray(res.state, kstate.dtype))

        if adapt and self.kernel is not None and self.kernel.name in _ADAPTIVE_KERNELS:
            # Robbins-Monro in log space: pull w toward ~3x the typical
            # accepted move size (the slice width that keeps step-out and
            # shrinkage iterations both small).  Only during warmup —
            # adaptation during sampling would break detailed balance.
            move = jnp.abs(b_new - beta[j])
            target = jnp.log(3.0 * move + 1e-6)
            kstate = kstate.at[j].set(
                (1.0 - self._adapt_rate) * kstate[j] + self._adapt_rate * target
            )

        # Commit: incremental O(n) eta update (R/mcmcglm.R:264-269) and
        # refresh of the cached per-observation log densities.
        eta = eta + x_j * (b_new - beta[j])
        beta = beta.at[j].set(b_new)
        ld = self.family.log_density_eta(eta, self.y, self.extra)
        return (beta, eta, ld, kstate, key, chain_tuning), n_evals

    def _sweep(self, state: ChainState, _, adapt=False):
        carry = (
            state.beta,
            state.eta,
            state.ld_cur,
            state.kernel_state,
            state.key,
            state.chain_tuning,
        )
        xs = (jnp.arange(self.d), self.Xt)
        carry, n_evals = lax.scan(
            partial(self._coord_step, adapt=adapt), carry, xs
        )
        new_state = ChainState(*carry)
        return new_state, (new_state.beta, jnp.sum(n_evals))

    def sweep_fn(self):
        """The single-sweep function (one full Gibbs pass over the d
        coordinates) for one chain — the jittable 'training step'."""
        return lambda state: self._sweep(state, None)

    # -- multi-sweep runs --------------------------------------------------

    def _run_one(self, state: ChainState, n_steps: int, adapt: bool = False):
        state, (betas, n_evals) = lax.scan(
            partial(self._sweep, adapt=adapt), state, None, length=n_steps
        )
        return state, betas, n_evals

    def run(self, state: ChainState, n_steps: int):
        """Advance every chain by ``n_steps`` sweeps.

        Returns (new_state, betas, n_evals) with betas of shape
        (chains, n_steps, d) and n_evals of shape (chains, n_steps).
        Compiled once per distinct n_steps.
        """
        key_ = (n_steps, self._w_adapted)
        fn = self._run_cache.get(key_)
        if fn is None:
            fn = jax.jit(jax.vmap(partial(self._run_one, n_steps=n_steps)))
            self._run_cache[key_] = fn
        return fn(state)

    def warmup(self, state: ChainState, n_steps: int):
        """Adaptive warmup: runs ``n_steps`` sweeps while tuning a
        per-(chain, coordinate) stepping-out slice width toward ~3x the
        typical accepted move (Robbins-Monro in log space, carried in the
        kernel-state slot).  After this call the engine samples with the
        tuned, FROZEN widths (adaptation during sampling would break
        detailed balance).  Only supported for the stepping_out kernel;
        a no-op otherwise.

        The reference has no adaptation at all — w is a fixed user tuning
        parameter (R/mcmcglm.R:40-41); adaptive widths cut the lockstep
        slice-evaluation count across vmapped chains, which is the dominant
        cost term on an accelerator.
        """
        if self.kernel is None or self.kernel.name not in _ADAPTIVE_KERNELS:
            state, betas, nev = self.run(state, n_steps)
            return state, betas, nev
        if not self._w_adapted:
            # seed log-w state from the static tuning w
            w0 = jnp.asarray(self.tuning.get("w", 1.0), self.config.dtype)
            state = state._replace(
                kernel_state=jnp.full_like(state.kernel_state, jnp.log(w0))
            )
            self._w_adapted = True
        key_ = (n_steps, "warmup")
        fn = self._run_cache.get(key_)
        if fn is None:
            fn = jax.jit(
                jax.vmap(partial(self._run_one, n_steps=n_steps, adapt=True))
            )
            self._run_cache[key_] = fn
        return fn(state)

    def reset_adaptation(self):
        """Return the engine to the un-adapted sampling mode.

        ``warmup()`` flips the engine into adapted-width mode: thereafter
        ``run()`` reads per-(chain, coordinate) log widths from the
        kernel-state slot (and the jit cache keys on the mode).  States
        created *before* the reset (whose kernel-state slot carries log
        widths) must not be passed to ``run()`` after it — call ``init()``
        for a fresh un-adapted state.  This makes the mode flip explicit
        and reversible instead of a one-way instance trap.
        """
        self._w_adapted = False

    def _run_one_thinned(self, state: ChainState, moments, n_outer: int, thin: int):
        from .parallel.pooled import update_moments

        def outer(carry, _):
            state, mom = carry

            def inner(c, _):
                st, mm = c
                st, (beta, nev) = self._sweep(st, None)
                return (st, update_moments(mm, beta)), nev

            (state, mom), nevs = lax.scan(inner, (state, mom), None, length=thin)
            return (state, mom), (state.beta, jnp.sum(nevs))

        (state, mom), (draws, nev) = lax.scan(
            outer, (state, moments), None, length=n_outer
        )
        return state, mom, draws, nev

    def run_thinned(self, state: ChainState, n_outer: int, thin: int, moments=None):
        """Advance chains n_outer*thin sweeps keeping only every thin-th
        draw, while accumulating per-chain Welford moments on device —
        the pod-scale collection mode (parallel/pooled.py): memory is
        O(C*(n_outer + 1)*d) instead of O(C*n_outer*thin*d).

        Returns (state, moments, draws (C, n_outer, d), n_evals).
        """
        from .parallel.pooled import ChainMoments, init_moments

        n_chains = state.beta.shape[0]
        if moments is None:
            m = init_moments(n_chains, self.d, self.config.dtype)
            # per-chain moments ride the chain vmap as (d,) leaves
            moments = ChainMoments(
                count=jnp.zeros((n_chains,), self.config.dtype),
                mean=m.mean,
                m2=m.m2,
            )
        key_ = ("thinned", n_outer, thin)
        fn = self._run_cache.get(key_)
        if fn is None:
            fn = jax.jit(
                jax.vmap(partial(self._run_one_thinned, n_outer=n_outer, thin=thin))
            )
            self._run_cache[key_] = fn
        return fn(state, moments)

    def sample(
        self,
        key,
        n_samples: int,
        n_chains: int = 1,
        chunk_size: int = 0,
        progress=None,
        chain_tuning: Optional[Mapping] = None,
    ):
        """Full sampling run: init from the prior, then n_samples sweeps.

        Returns (betas, n_evals, final_state) where betas has shape
        (chains, n_samples + 1, d) — row 0 is the init draw, matching the
        reference's iteration-0 bookkeeping (R/mcmcglm.R:193-198,222).

        ``chunk_size`` > 0 runs in host-visible chunks (progress callbacks +
        bounded device memory for the collected history); 0 runs one scan.
        """
        state = self.init(key, n_chains, chain_tuning=chain_tuning)
        init_beta = np.asarray(state.beta)[:, None, :]
        if chunk_size <= 0:
            chunk_size = n_samples
        chunks_betas = [init_beta]
        chunks_nev = []
        done = 0
        while done < n_samples:
            step = min(chunk_size, n_samples - done)
            state, betas, n_evals = self.run(state, step)
            chunks_betas.append(np.asarray(betas))
            chunks_nev.append(np.asarray(n_evals))
            done += step
            if progress is not None:
                progress(done, n_samples)
        betas = np.concatenate(chunks_betas, axis=1)
        n_evals = np.concatenate(chunks_nev, axis=1) if chunks_nev else np.zeros(
            (n_chains, 0), np.int32
        )
        return betas, n_evals, state
