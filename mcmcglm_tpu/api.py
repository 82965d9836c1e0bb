"""The top-level ``mcmcglm`` entry point.

JAX re-design of the reference's single public fitting function
(R/mcmcglm.R:147-299): same conceptual signature — formula + data + family +
beta_prior + slice tuning — returning a results object with
samples/coef/quantile/trace_plot methods, with accelerator-first extensions
(multiple vmapped chains, explicit PRNG seed, dtype policy, array-first
input, chunked execution with progress reporting).

Differences from the reference, on purpose:
  * ``n_chains`` vmaps independent chains (reference is single-chain).
  * burn-in bookkeeping and quantile subsetting follow the documented
    (not buggy) behavior — see results.py.
  * memory: only beta draws are kept (reference keeps beta/eta/mu for every
    iteration, R/mcmcglm.R:188).
"""

from __future__ import annotations

import time
from typing import Any, Mapping, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .engine import CGGibbs, EngineConfig
from .formula import Design, build_design, design_from_arrays
from .models.families import check_family
from .models.priors import Normal, make_beta_prior
from .ops.slice_kernels import get_slice_kernel
from .results import MCMCGLM

__all__ = ["mcmcglm"]


def mcmcglm(
    formula: Optional[str] = None,
    family="gaussian",
    data=None,
    beta_prior=None,
    log_likelihood_extra_args: Optional[Mapping[str, Any]] = None,
    linear_predictor_calc: str = "update",
    sample_method: str = "slice_sampling",
    slice_fn="stepping_out",
    *,
    n_samples: int = 500,
    burnin: int = 100,
    n_chains: int = 1,
    seed: int = 0,
    X=None,
    y=None,
    columns: Optional[Sequence[str]] = None,
    add_intercept: bool = False,
    dtype=jnp.float32,
    chunk_size: int = 0,
    progress: bool = False,
    qslice_fun=None,
    engine: str = "auto",
    adapt_w: bool = False,
    weights=None,
    thin: int = 1,
    mesh=None,
    engine_opts: Optional[Mapping[str, Any]] = None,
    **tuning,
) -> MCMCGLM:
    """Draw MCMC samples from a GLM posterior with the CGGibbs sampler.

    Mirrors the reference's argument surface (R/mcmcglm.R:147-157):

    - ``formula`` + ``data`` — R-style formula over a DataFrame/dict, OR
      ``X=``, ``y=`` arrays directly.
    - ``family`` — string / factory / Family (reference check_family,
      R/family_data_processing.R:3-16).
    - ``beta_prior`` — a Distribution (iid over coordinates), a list of
      per-coordinate Distributions, a MultivariateNormal, or a BetaPrior.
      Defaults to Normal(0, 1) (R/mcmcglm.R:150).
    - ``log_likelihood_extra_args`` — nuisance parameters for the family's
      log density, e.g. ``{"sd": 1.0}`` for gaussian (R/mcmcglm.R:151).
      Defaults to ``{"sd": 1.0}`` for gaussian parity.
    - ``linear_predictor_calc`` — "update" (CGGibbs O(n)) or "naive"
      (full matvec; benchmark parity, R/glm_utils.R:200-208).
    - ``sample_method`` — "slice_sampling" or the conjugate "normal-normal"
      testing oracle (R/mcmcglm.R:152-153).
    - ``slice_fn`` — slice kernel name or SliceKernel (the reference's
      ``qslice_fun``; that spelling is accepted as an alias).
    - ``**tuning`` — kernel tuning parameters, e.g. ``w=0.5`` for
      stepping_out (the reference's ``...`` passthrough, R/mcmcglm.R:155).
    - ``adapt_w`` — tune a per-(chain, coordinate) stepping-out slice width
      during burn-in (Robbins-Monro toward ~3x the typical accepted move),
      then sample with the widths frozen.  Cuts the lockstep slice-eval
      count dramatically when w is mis-specified (measured 8318 -> 504
      evals/sweep from w=0.01 on a p=100 logistic model); the reference has
      no adaptation at all (w is a raw tuning parameter, R/mcmcglm.R:40-41).
    - ``engine`` — "auto" / "freerun" / "xla".
      "freerun" is the lockstep-free automaton engine (freerun.py): every
      chain advances one evaluation per device pass instead of waiting
      for the slowest lane of a vmapped while loop.  It
      adapts per-(chain, coordinate) slice widths during burn-in
      (burn-in draws are discarded, so adaptation there is semantically
      free) and samples with the frozen widths using the m=1 shrink-only
      slice kernel (~1.4 target evaluations per coordinate).  "auto"
      resolves to freerun for ALL six kernels (stepping_out, doubling,
      latent, elliptical, genelliptical, quantile) with
      linear_predictor_calc='update' — the pure-shrinkage kernels ride
      the speculative battery automaton; doubling runs the classic
      one-evaluation pass with its Fig. 6 back-test unrolled to extra
      automaton phases (ops/freerun_doubling.py).  The "naive" mode
      runs on the general "xla" scan/while engine.
    - ``engine_opts`` — extra constructor options for the freerun engines
      (e.g. ``{"shrink_only": False}`` to sample with the full stepping-out
      schedule for heavy-tailed conditionals, ``{"adapt_c": 60.0}``,
      ``{"eval_cache": "per_obs"}``, ``{"spec_k": 1}`` to disable the
      K-speculative proposal batteries that the freerun path enables by
      default on accelerators — spec_k=4, identical in law).  Ignored by
      other engines.
    - ``mesh`` — a ``jax.sharding.Mesh`` (see ``parallel.make_mesh``) to
      run multi-chip: the freerun engine shards chains (one independent
      automaton per device, zero collectives; chain-axis-only meshes);
      the xla engine shards chains x observations with psum'd likelihood
      reductions (tall-data path).

    Returns an :class:`MCMCGLM` with ``(n_chains, n_samples + 1, d)`` draws.
    """
    call = (
        f"mcmcglm(formula={formula!r}, family=..., n_samples={n_samples}, "
        f"burnin={burnin}, n_chains={n_chains}, sample_method={sample_method!r})"
    )
    if burnin >= n_samples:
        # parity: R/mcmcglm.R:165
        raise ValueError("Need more iterations than burnin")

    fam = check_family(family)

    # -- data ingestion ----------------------------------------------------
    if formula is not None:
        if data is None:
            raise ValueError("`data` is required when a formula is given")
        design: Design = build_design(formula, data)
    elif X is not None and y is not None:
        design = design_from_arrays(X, y, columns=columns, add_intercept=add_intercept)
    else:
        raise ValueError("provide either (formula, data) or (X=, y=)")

    d = design.X.shape[1]
    if beta_prior is None:
        beta_prior = Normal(0.0, 1.0)
    prior = make_beta_prior(beta_prior, d)

    extra = dict(log_likelihood_extra_args or {})
    if fam.name == "gaussian" and "sd" not in extra:
        # reference default: log_likelihood_extra_args = list(sd = 1)
        extra["sd"] = 1.0

    slice_spec = qslice_fun if qslice_fun is not None else slice_fn
    kernel = get_slice_kernel(slice_spec) if sample_method == "slice_sampling" else None

    use_freerun = False
    if sample_method == "slice_sampling" and kernel is not None:
        # latent / elliptical / genelliptical run at full freerun speed
        # too: all are pure shrinkage (latent on a carried bracket, the
        # elliptical pair on the angle bracket), so the automaton reuses
        # the whole battery/commit machinery — see
        # freerun._begin_coord_latent / _begin_coord_elliptical.
        # doubling completes the set (all six qslice kernels on the fast
        # automaton): its Fig. 6 back-test unrolls to extra automaton
        # phases at one evaluation per pass (ops/freerun_doubling.py)
        freerun_eligible = (
            kernel.name in (
                "stepping_out", "latent", "elliptical", "genelliptical",
                "quantile", "doubling",
            )
            and linear_predictor_calc == "update"
        )
        if engine == "freerun":
            if not freerun_eligible:
                raise ValueError(
                    "engine='freerun' requires a registered qslice-style "
                    "kernel (stepping_out, doubling, latent, elliptical, "
                    "genelliptical or quantile) + "
                    "linear_predictor_calc='update'"
                )
            use_freerun = True
        elif engine == "auto":
            use_freerun = freerun_eligible
        elif engine != "xla":
            raise ValueError("engine must be 'auto', 'freerun' or 'xla'")
    elif sample_method == "normal-normal" and engine == "freerun":
        # exact conjugate coordinate draws inside the freerun pass loop
        # (gaussian/identity + diagonal normal prior; the reference's
        # normal-normal coordinate sampler, R/sampling.R:19-35, at one
        # device pass per coordinate — ops/freerun_conjugate.py).
        # engine='auto' keeps the factored CGGibbs conjugate path (the
        # validation oracle, engine.py), matching the reference's framing
        # of normal-normal as the testing method (R/mcmcglm.R:32-34).
        use_freerun = True

    if use_freerun:
        engine_opts = dict(engine_opts or {})
        if kernel is not None and kernel.name in (
            "latent", "elliptical", "genelliptical", "quantile", "doubling"
        ):
            engine_opts.setdefault("slice_kernel", kernel.name)
        if sample_method == "normal-normal":
            engine_opts["coord_sampler"] = "conjugate"
        elif engine_opts.get("slice_kernel") == "doubling":
            # doubling runs the classic one-evaluation pass only (the
            # speculative battery does not compose with its back-test)
            engine_opts.pop("spec_k", None)
        elif "spec_k" not in engine_opts and jax.default_backend() != "cpu":
            # accelerator default: K-speculative batteries, identical in
            # law (tests/test_freerun_spec.py).  CPU keeps spec_k=1: the
            # battery is compute-bound there, so K-fold extra evaluations
            # cost wall-clock instead of riding free.
            engine_opts["spec_k"] = 4
        if mesh is not None:
            from .parallel.mesh import OBS_AXIS

            if mesh.shape.get(OBS_AXIS, 1) > 1:
                # (chain x obs) mesh: the tall-data fast path — per-shard
                # partial log-lik sums psum'd over the obs axis each pass
                from .parallel.freerun_obs_sharded import (
                    ObsShardedFreeRunCGGibbs,
                )

                sampler = ObsShardedFreeRunCGGibbs(
                    design.X, design.y, fam, prior, mesh=mesh, extra=extra,
                    tuning=tuning, obs_weights=weights, dtype=dtype,
                    offset=design.offset, **dict(engine_opts or {}),
                )
            else:
                # chain-sharded free-running over the mesh (one independent
                # automaton per device, zero collectives)
                from .parallel.freerun_sharded import ShardedFreeRunCGGibbs

                sampler = ShardedFreeRunCGGibbs(
                    design.X, design.y, fam, prior, mesh=mesh, extra=extra,
                    tuning=tuning, obs_weights=weights, dtype=dtype,
                    offset=design.offset, **dict(engine_opts or {}),
                )
        else:
            from .freerun import FreeRunCGGibbs

            sampler = FreeRunCGGibbs(
                design.X, design.y, fam, prior, extra=extra, tuning=tuning,
                obs_weights=weights, dtype=dtype, offset=design.offset,
                **dict(engine_opts or {}),
            )
    else:
        config = EngineConfig(
            sample_method=sample_method,
            linear_predictor_calc=linear_predictor_calc,
            slice_kernel=kernel if kernel is not None else "stepping_out",
            dtype=dtype,
        )
        if mesh is not None:
            if weights is not None:
                raise ValueError(
                    "observation weights with a mesh are only supported by "
                    "the freerun engine"
                )
            from .parallel.sharded_engine import ShardedCGGibbs

            sampler = ShardedCGGibbs(
                design.X, design.y, fam, prior, extra=extra, config=config,
                tuning=tuning, mesh=mesh, offset=design.offset,
            )
        else:
            sampler = CGGibbs(
                design.X,
                design.y,
                fam,
                prior,
                extra=extra,
                config=config,
                tuning=tuning,
                obs_weights=weights,
                offset=design.offset,
            )

    progress_cb = None
    if progress and chunk_size <= 0:
        chunk_size = max(1, n_samples // 10)
    if progress:

        def progress_cb(done, total):  # noqa: ANN001
            pct = 100.0 * done / total
            print(f"\rSampling from posterior: {done}/{total} ({pct:.0f}%)",
                  end="" if done < total else "\n", flush=True)

    t0 = time.perf_counter()
    burnin_out = burnin
    if use_freerun:
        # adaptive burn-in (burn-in draws are discarded anyway), then
        # frozen-width shrink-only sampling
        state = sampler.init(jax.random.key(seed), n_chains)
        init_beta = np.asarray(state.beta)[:, None, :]
        if burnin > 0:
            state, warm_betas, _ = sampler.warmup(state, burnin)
            parts = [init_beta, np.asarray(warm_betas)]
        else:
            parts = [init_beta]
        if progress_cb is not None:
            progress_cb(burnin, n_samples)
        # n_evals bookkeeping: state.nev is cumulative, so warmup
        # evaluations are excluded from the reported per-sweep counts
        nev_warm = np.asarray(state.nev).copy()
        n_keep = n_samples - burnin
        if thin > 1:
            # thinned collection + streaming Welford moments on device;
            # per-sweep eval granularity is not collected here (draws are
            # thinned too), so report the flat per-sweep average
            n_outer = n_keep // thin
            state, _, kept, _ = sampler.run_thinned(state, n_outer, thin)
            betas = np.concatenate([init_beta, np.asarray(kept)], axis=1)
            n_sweeps_run = n_outer * thin
            burnin_out = 0  # collected draws are already post-burn-in
            if progress_cb is not None:
                progress_cb(n_samples, n_samples)
            nev_sampling = np.asarray(state.nev) - nev_warm
            n_evals = np.broadcast_to(
                (nev_sampling / max(n_sweeps_run, 1))[:, None],
                (n_chains, max(n_sweeps_run, 1)),
            )
        else:
            # run() returns per-chain cumulative eval counts at each sweep's
            # completion; their first difference is the honest per-sweep data
            nev_parts = []
            if chunk_size > 0:
                done = 0
                while done < n_keep:
                    step = min(chunk_size, n_keep - done)
                    state, sb, nb = sampler.run(state, step)
                    parts.append(np.asarray(sb))
                    nev_parts.append(np.asarray(nb))
                    done += step
                    if progress_cb is not None:
                        progress_cb(burnin + done, n_samples)
            else:
                state, samp_betas, nb = sampler.run(state, n_keep)
                parts.append(np.asarray(samp_betas))
                nev_parts.append(np.asarray(nb))
            betas = np.concatenate(parts, axis=1)
            cum = np.concatenate(nev_parts, axis=1) if nev_parts else \
                np.zeros((n_chains, 0), np.int32)
            n_evals = np.diff(
                np.concatenate([nev_warm[:, None], cum], axis=1), axis=1
            )
    elif thin > 1 and sample_method == "slice_sampling":
        # memory-bounded collection: burn in, then keep every thin-th draw
        # while streaming Welford moments on device (engine.run_thinned)
        state = sampler.init(jax.random.key(seed), n_chains)
        init_beta = np.asarray(state.beta)[:, None, :]
        if adapt_w:
            state, _, _ = sampler.warmup(state, burnin)
        else:
            state, _, _ = sampler.run(state, burnin)
        if progress_cb is not None:
            progress_cb(burnin, n_samples)
        n_outer = (n_samples - burnin) // thin
        state, _, draws, nev = sampler.run_thinned(state, n_outer, thin)
        betas = np.concatenate([init_beta, np.asarray(draws)], axis=1)
        n_evals = np.asarray(nev)
        burnin_out = 0  # collected draws are already post-burn-in
        if progress_cb is not None:
            progress_cb(n_samples, n_samples)
    elif adapt_w and sample_method == "slice_sampling":
        # adaptive burn-in, then frozen-width sampling
        state = sampler.init(jax.random.key(seed), n_chains)
        init_beta = np.asarray(state.beta)[:, None, :]
        state, warm_betas, warm_nev = sampler.warmup(state, burnin)
        if progress_cb is not None:
            progress_cb(burnin, n_samples)
        parts = [init_beta, np.asarray(warm_betas)]
        nev_parts = [np.asarray(warm_nev)]
        n_keep = n_samples - burnin
        done = 0
        step_size = chunk_size if chunk_size > 0 else n_keep
        while done < n_keep:
            step = min(step_size, n_keep - done)
            state, sb, sn = sampler.run(state, step)
            parts.append(np.asarray(sb))
            nev_parts.append(np.asarray(sn))
            done += step
            if progress_cb is not None:
                progress_cb(burnin + done, n_samples)
        betas = np.concatenate(parts, axis=1)
        n_evals = np.concatenate(nev_parts, axis=1)
    else:
        betas, n_evals, _ = sampler.sample(
            jax.random.key(seed),
            n_samples,
            n_chains=n_chains,
            chunk_size=chunk_size,
            progress=progress_cb,
        )
    elapsed = time.perf_counter() - t0

    return MCMCGLM(
        beta=np.asarray(betas),
        columns=list(design.columns),
        family_name=fam.name,
        burnin=burnin_out,
        sample_method=sample_method,
        slice_kernel=kernel.name if kernel is not None else None,
        tuning=dict(tuning),
        n_evals=np.asarray(n_evals),
        model_matrix=design.X,
        response=design.y,
        formula=design.formula,
        call=call,
        elapsed_seconds=elapsed,
        family=fam,
        extra=extra,
        offset=design.offset,
    )
