"""Run the BASELINE.json config matrix and emit one JSON line per config.

Configs (BASELINE.md):
  1. gaussian n=1000 p=3 (README example) — correctness anchor
  2. logistic n=10k p=100, normal prior  (+ NUTS cross-check)
  3. poisson/log n=10k p=100, Laplace (sparse) prior  (+ NUTS cross-check)
  4. gaussian p=10k linear-runtime stress (prior-mean init, real warmup)
  5. 4096 parallel chains of p=1000 logistic, ShardedFreeRunCGGibbs with
     thinned collection + streaming pooled moments (pooled R-hat/ESS)

Error reporting (all configs): ``max_err_sd`` / ``med_err_sd`` are
|posterior mean − true β| in units of the estimated posterior sd of that
coordinate — a z-score, so ≲3 means the truth sits inside the posterior
bulk, independent of scale/dimension.  Configs #2/#3 additionally
cross-check the CGGibbs posterior mean against NUTS run on the same
log-density (``nuts_max_diff_sd``), the calibration oracle the reference
package was written to be benchmarked against (R/mcmcglm.R:5-8).

Run on a GPU:  python scripts/baseline_configs.py
CPU (small):   env JAX_PLATFORMS=cpu python scripts/baseline_configs.py --small
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import mcmcglm_tpu as mg
from mcmcglm_tpu.datagen import generate_glm_data
from mcmcglm_tpu.freerun import FreeRunCGGibbs
from mcmcglm_tpu.parallel.pooled import pooled_summary


def _log(msg):
    """Timestamped progress on stderr (long configs compile and run for
    minutes; this distinguishes slow from stuck)."""
    print(time.strftime("%H:%M:%S"), msg, file=sys.stderr, flush=True)


def _err_in_sd_units(draws, beta_true):
    """z-scores of the posterior-mean error: (C, K, d) draws -> (d,)."""
    flat = draws.reshape(-1, draws.shape[-1])
    post_mean = flat.mean(0)
    post_sd = np.maximum(flat.std(0), 1e-12)
    return np.abs(post_mean - beta_true) / post_sd, post_mean, post_sd


def _nuts_crosscheck(X, y, family, prior, extra, post_mean, post_sd, seed=7,
                     n_chains=8, n_warmup=300, n_samples=300):
    """Posterior-mean agreement with NUTS on the identical log-density,
    reported in posterior-sd units (BASELINE 'NUTS cross-check')."""
    from mcmcglm_tpu.baselines.logdensity import make_log_posterior
    from mcmcglm_tpu.baselines.nuts import nuts_sample

    d = X.shape[1]
    logpost = make_log_posterior(X, y, family, prior, extra=extra)
    init = 0.1 * jax.random.normal(jax.random.key(seed + 1), (n_chains, d))
    res = nuts_sample(jax.random.key(seed), logpost, init,
                      n_warmup=n_warmup, n_samples=n_samples)
    nuts_draws = np.asarray(res.samples)  # (C, K, d)
    nuts_mean = nuts_draws.reshape(-1, d).mean(0)
    diff_sd = np.abs(post_mean - nuts_mean) / post_sd
    return {
        "nuts_max_diff_sd": round(float(diff_sd.max()), 3),
        "nuts_med_diff_sd": round(float(np.median(diff_sd)), 3),
        "nuts_accept": round(float(np.mean(np.asarray(res.accept_rate))), 3),
    }


def _engine_opts():
    """Flagship engine options: the K-speculative proposal battery (the
    configuration bench.py and the api default run) on accelerators;
    spec_k=1 on CPU where the battery is compute-bound."""
    if jax.default_backend() == "cpu":
        return {}
    return {"spec_k": 4}


def run_config(name, family, n, d, prior, w, n_chains, burnin, timed,
               extra=None, nuts_check=False, init_at_prior_mean=False,
               engine_opts=None, coord_sampler="slice",
               slice_crosscheck=False):
    """Freerun engine (the production configuration): adaptive-width warmup
    over the burn-in, then frozen-width shrink-only sampling.

    ``coord_sampler="conjugate"``: exact normal coordinate conditionals
    (gaussian/identity + normal prior; ops/freerun_conjugate.py) — the
    config #4 mode, where the slice kernel's per-coordinate rejection
    dynamics are pure overhead.  ``slice_crosscheck=True`` additionally
    runs the retained slice path on the same problem and reports the
    posterior-mean agreement in posterior-sd units."""
    X, y, beta_true = generate_glm_data(family, n=n, d=d, seed=0)

    conj = coord_sampler == "conjugate"
    eng = FreeRunCGGibbs(X, y, family, mg.make_beta_prior(prior, d),
                         extra=extra or {}, tuning={"w": w},
                         coord_sampler=coord_sampler,
                         **({} if conj else dict(engine_opts or {})))
    beta0 = np.asarray(eng.prior.mean_beta()) if init_at_prior_mean else None
    state = eng.init(jax.random.key(0), n_chains, beta0=beta0)
    t0 = time.perf_counter()
    # adapt + burn in; chunked so long adaptive runs at d=10k report
    # progress
    wu_chunk = 20 if d >= 5000 else burnin
    done = 0
    stepout_total = eng._auto_stepout(burnin)
    while done < burnin:
        step = min(wu_chunk, burnin - done)
        # two-phase warmup across chunks: each chunk restarts its local
        # sweep counter, so thread the REMAINING stepping-out quota
        state, _, _ = eng.warmup(
            state, step, stepout_sweeps=max(0, stepout_total - done)
        )
        jax.block_until_ready(state.beta)
        done += step
        _log(f"{name}: warmup {done}/{burnin}")
    compile_s = time.perf_counter() - t0

    # chunked dispatches, each reporting progress
    chunk = max(1, min(30, 7680 // n_chains))
    if d >= 5000:
        chunk = min(chunk, 5)
    state, b, _ = eng.run(state, chunk)  # compile the sampling executable
    jax.block_until_ready(b)
    _log(f"{name}: sampling executable compiled")
    t0 = time.perf_counter()
    parts = []
    done = 0
    while done < timed:
        step = min(chunk, timed - done)
        state, betas, _ = eng.run(state, step)
        parts.append(betas)  # stays on device during the timed section
        done += step
    jax.block_until_ready(parts)
    dt = time.perf_counter() - t0
    draws = np.concatenate([np.asarray(p) for p in parts], axis=1)
    ess = mg.ess(draws)
    rhat = mg.split_rhat(draws)
    err_sd, post_mean, post_sd = _err_in_sd_units(draws, beta_true)
    out = {
        "config": name,
        "family": family,
        "n": n,
        "d": d,
        "coord_sampler": coord_sampler,
        "spec_k": eng.spec_k,
        "chains": n_chains,
        "warmup_sweeps": burnin,
        "timed_sweeps": timed,
        "seconds": round(dt, 2),
        "warmup_s": round(compile_s, 1),
        "min_ess_per_s": round(float(np.min(ess)) / dt, 2),
        "median_ess_per_s": round(float(np.median(ess)) / dt, 2),
        "max_rhat": round(float(np.max(rhat)), 4),
        "max_err_sd": round(float(err_sd.max()), 3),
        "med_err_sd": round(float(np.median(err_sd)), 3),
    }
    if nuts_check:
        out.update(
            _nuts_crosscheck(X, y, family, eng.prior, extra or {},
                             post_mean, post_sd)
        )
    if slice_crosscheck:
        # the retained slice path on the identical problem: posterior-mean
        # agreement with the conjugate draws (VERDICT r4 #2 "slice path
        # retained and cross-checked against the conjugate draws")
        _log(f"{name}: slice cross-check run")
        eng2 = FreeRunCGGibbs(X, y, family, mg.make_beta_prior(prior, d),
                              extra=extra or {}, tuning={"w": w},
                              **dict(engine_opts or {}))
        st2 = eng2.init(jax.random.key(5), n_chains, beta0=beta0)
        done = 0
        stepout_total = eng2._auto_stepout(burnin)
        while done < burnin:
            step = min(wu_chunk, burnin - done)
            st2, _, _ = eng2.warmup(
                st2, step, stepout_sweeps=max(0, stepout_total - done)
            )
            jax.block_until_ready(st2.beta)
            done += step
            _log(f"{name}: slice warmup {done}/{burnin}")
        parts2 = []
        done = 0
        while done < timed:
            step = min(chunk, timed - done)
            st2, b2, _ = eng2.run(st2, step)
            parts2.append(b2)
            done += step
            _log(f"{name}: slice sweeps {done}/{timed}")
        sl = np.concatenate([np.asarray(p) for p in parts2], axis=1)
        sl_mean = sl.reshape(-1, d).mean(0)
        diff = np.abs(sl_mean - post_mean) / post_sd
        out["slice_max_diff_sd"] = round(float(diff.max()), 3)
        out["slice_med_diff_sd"] = round(float(np.median(diff)), 3)
        out["slice_min_ess"] = round(float(np.min(mg.ess(sl))), 1)
    print(json.dumps(out), flush=True)
    return out


def run_pooled_4096(n, d, n_chains, burnin, n_outer, thin, engine_opts=None,
                    wu_passes=1500):
    """Config #5: massive chain count on the flagship free-running engine,
    chain-sharded over the device mesh (zero collectives), with pooled
    R-hat computed on device (parallel/pooled.py).  Runs the FULL
    flagship optimization: K-speculative batteries (engine_opts),
    pass-bounded warmup dispatches (warmup_passes), and — for thin=1 —
    the barrier-free run_passes collection, where chains run freely
    across sweep boundaries for the whole timed section and the
    cross-chain sweep tail is paid ONCE (chunked run_thinned pays it per
    dispatch; it remains the thin>1 memory-bounded mode)."""
    from mcmcglm_tpu.parallel.freerun_sharded import ShardedFreeRunCGGibbs

    X, y, beta_true = generate_glm_data("binomial", n=n, d=d, seed=0)
    eng = ShardedFreeRunCGGibbs(
        X, y, "binomial", mg.make_beta_prior(mg.Normal(0, 1), d),
        tuning={"w": 0.5}, **dict(engine_opts or {}),
    )
    state = eng.init(jax.random.key(0), n_chains)
    t0 = time.perf_counter()
    if n_chains >= 1024:
        # pass-bounded warmup: fixed device-pass blocks per dispatch
        sc = None
        blk = 0
        while True:
            state, sc = eng.warmup_passes(state, sc, burnin, wu_passes)
            jax.block_until_ready(state.beta)
            scn = np.asarray(sc)
            blk += 1
            _log(f"pod: warmup block {blk} "
                 f"(sweeps min {scn.min()} / median {int(np.median(scn))} "
                 f"/ quota {burnin})")
            if (scn >= burnin).all():
                break
    else:
        wu_chunk = 5 if n_chains >= 256 else burnin
        done_w = 0
        stepout_total = eng.inner._auto_stepout(burnin)
        while done_w < burnin:
            step = min(wu_chunk, burnin - done_w)
            state, _, _ = eng.warmup(
                state, step, stepout_sweeps=max(0, stepout_total - done_w)
            )
            jax.block_until_ready(state.beta)
            done_w += step
            _log(f"pod: warmup {done_w}/{burnin}")
    warm_s = time.perf_counter() - t0
    from mcmcglm_tpu.parallel.pooled import ChainMoments

    # POD_MODE=chunked forces the chunked run_thinned collection even at
    # thin=1.  The barrier-free run_passes mode pays a host-synced
    # dispatch round-trip per 1500-pass block.
    passes_mode = thin == 1 and _os.environ.get("POD_MODE") != "chunked"
    if passes_mode:
        # barrier-free pass-bounded collection (run_passes): chains run
        # freely across sweep boundaries for the WHOLE timed section —
        # the per-chunk cross-chain sweep tail (~10-15% of wall-clock at
        # C=4096) is paid once at the end instead of per dispatch.
        # 1500 passes/dispatch (the warmup block size).
        # Compile OUTSIDE the timed section from abstract shapes (no
        # allocation, no execution): warms the persistent compile cache;
        # the timed loop's first call then loads from disk in seconds.
        # ONE constant for warm + dispatch: n_passes is baked into the
        # jitted executable (and its cache key), so warming a different
        # pass count would compile the wrong program and the first timed
        # dispatch would pay a full compile inside the timed section.
        run_block_passes = 1500
        eng.run_passes(state, None, None, None, n_outer, run_block_passes,
                       compile_only=True)
        sc, drbuf, nb = None, None, None
        _log("pod: run_passes executable compiled (abstract warm)")
        nev0 = np.asarray(state.nev).copy()
        t0 = time.perf_counter()
        blk = 0
        while True:
            state, sc, drbuf, nb = eng.run_passes(state, sc, drbuf, nb,
                                                  n_outer, run_block_passes)
            jax.block_until_ready(state.beta)
            scn = np.asarray(sc)
            blk += 1
            _log(f"pod: timed block {blk} (sweeps min {scn.min()} / "
                 f"median {int(np.median(scn))} / quota {n_outer})")
            if (scn >= n_outer).all():
                break
        jax.block_until_ready(drbuf)
        dt = time.perf_counter() - t0
        done = n_outer
        sweeps = n_outer

        def mom_from_draws(dr):
            mean = jnp.mean(dr, axis=1)
            m2 = jnp.sum((dr - mean[:, None, :]) ** 2, axis=1)
            cnt = jnp.full((dr.shape[0],), float(n_outer), dr.dtype)
            return ChainMoments(cnt, mean, m2)

        mom = jax.jit(mom_from_draws)(drbuf)
        # on-device min-ESS straight from the chain-sharded buffer
        # (SURVEY §8.3): only the (d,) vector crosses to the host, vs the
        # full (C, n_outer, d) gather below (kept as the cross-check and
        # for err_sd); both timings recorded so the saving is explicit
        from mcmcglm_tpu.parallel.pooled import ess_device

        t_e = time.perf_counter()
        ess_dev = np.asarray(jax.jit(ess_device)(drbuf))
        dev_ess_s = time.perf_counter() - t_e
        t_g = time.perf_counter()
        draws = np.asarray(drbuf)
        gather_s = time.perf_counter() - t_g
    else:
        # compile the thinned sampling executable (one outer block)
        state, mom, dr, _ = eng.run_thinned(state, n_outer=1, thin=thin)
        jax.block_until_ready(dr)
        _log("pod: thinned executable compiled")
        nev0 = np.asarray(state.nev).copy()

        t0 = time.perf_counter()
        mom = None  # restart moments for the timed section
        dparts = []
        # bounded dispatches, each reporting progress
        chunk = max(1, min(16, 32_768 // (n_chains * thin)))
        done = 1
        state, mom, dr, _ = eng.run_thinned(state, n_outer=1, thin=thin,
                                            moments=mom)
        dparts.append(dr)
        while done < n_outer:
            step = min(chunk, n_outer - done)
            state, mom, dr, _ = eng.run_thinned(state, n_outer=step,
                                                thin=thin, moments=mom)
            dparts.append(dr)
            done += step
            _log(f"pod: timed outer {done}/{n_outer}")
        jax.block_until_ready(dparts)
        dt = time.perf_counter() - t0
        sweeps = done * thin
        draws = np.concatenate([np.asarray(p) for p in dparts], axis=1)
    summ = jax.jit(pooled_summary)(mom)  # sharded reductions -> psums
    pooled_rhat = float(np.max(np.asarray(summ["rhat"])))
    ess = mg.ess(draws)
    err_sd, _, _ = _err_in_sd_units(draws, beta_true)
    evals_per_sweep = float(np.mean(np.asarray(state.nev) - nev0)) / sweeps
    out = {
        "config": "pod_%d_chains_p%d_logistic" % (n_chains, d),
        "engine": ("ShardedFreeRunCGGibbs+run_passes" if passes_mode
                   else "ShardedFreeRunCGGibbs+run_thinned"),
        "spec_k": eng.inner.spec_k,
        "chains": n_chains,
        "n": n,
        "d": d,
        "warmup_sweeps": burnin,
        "sweeps": sweeps,
        "thin": thin,
        "seconds": round(dt, 2),
        "warmup_s": round(warm_s, 1),
        "chain_sweeps_per_s": round(n_chains * sweeps / dt, 1),
        "evals_per_sweep": round(evals_per_sweep, 1),
        "pooled_max_rhat": round(pooled_rhat, 4),
        "min_ess_per_s_thinned": round(float(np.min(ess)) / dt, 2),
        "median_ess_per_s_thinned": round(float(np.median(ess)) / dt, 2),
        "max_err_sd": round(float(err_sd.max()), 3),
    }
    if passes_mode:
        out["min_ess_per_s_device"] = round(float(ess_dev.min()) / dt, 2)
        out["device_ess_seconds"] = round(dev_ess_s, 2)
        out["host_gather_seconds"] = round(gather_s, 2)
        out["device_vs_host_min_ess_ratio"] = round(
            float(ess_dev.min()) / float(np.min(ess)), 4
        )
    print(json.dumps(out), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--skip-pod", action="store_true",
                    help="skip the long 4096-chain pooled config")
    ap.add_argument("--only", type=int, default=0,
                    help="run a single config (1-5)")
    args = ap.parse_args()
    s = args.small
    only = args.only
    opts = _engine_opts()

    if only in (0, 1):
        run_config("readme_gaussian_n1000_p3", "gaussian", 1000, 3,
                   mg.Normal(0, 1), 0.5, 8 if s else 64, 100, 400,
                   extra={"sd": 1.0}, engine_opts=opts)
    if only in (0, 2):
        run_config("logistic_n10k_p100_normal", "binomial",
                   2000 if s else 10_000, 100, mg.Normal(0, 1), 0.5,
                   8 if s else 64, 60, 100, nuts_check=True,
                   engine_opts=opts)
    if only in (0, 3):
        run_config("poisson_n10k_p100_laplace", "poisson",
                   2000 if s else 10_000, 100, mg.Laplace(0, 1), 0.3,
                   8 if s else 64, 60, 100, nuts_check=True,
                   engine_opts=opts)
    if only in (0, 4):
        # conjugate coordinate draws (r5): the gaussian-identity conditional
        # is closed-form normal, so the slice machinery was pure overhead
        # here; the slice path is retained as the cross-check
        # 200/200 sweeps: with EXACT coordinate draws the residual
        # autocorrelation is the Gibbs scan itself (d=10k, n=2k — the
        # underdetermined regime has strong cross-coordinate coupling);
        # the longer window is what reaches the 1.01 convergence bar
        # C=256: at d=10k/n=2k the (C, n) eta streams are tiny and the
        # pass is fixed-overhead-bound, so chains are cheap
        run_config("gaussian_p10k_stress", "gaussian",
                   1000 if s else 2000, 1000 if s else 10_000,
                   mg.Normal(0, 1), 0.5, 8 if s else 256,
                   10 if s else 200, 10 if s else 200,
                   extra={"sd": 1.0}, init_at_prior_mean=True,
                   coord_sampler="conjugate", slice_crosscheck=not s,
                   engine_opts=opts)
    if only in (0, 5) and not args.skip_pod:
        # r4 protocol (VERDICT r3 #1): retain >=150 draws per chain at
        # thin=1 so the pooled min-ESS sits well below the retained-draw
        # ceiling — the r3 run (30 draws/chain) measured its own
        # collection window, not the sampler (min-ESS at 87% of the
        # ceiling, median clipped).
        run_pooled_4096(2000 if s else 10_000, 100 if s else 1000,
                        64 if s else 4096, 10 if s else 30,
                        n_outer=20 if s else 150, thin=1, engine_opts=opts)


if __name__ == "__main__":
    main()
