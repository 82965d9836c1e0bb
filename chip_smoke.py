"""Smoke test of the CGGibbs main path on one GPU (``--four``: on four).

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py          # phases 1-2 on one card
    python chip_smoke.py --four   # phase 3 only, on four cards

Phases (each prints its numbers; any failure exits non-zero):

1. The README example through ``mcmcglm(formula=..., data=<dict>)``
   (gaussian, n=1,000, d=3, 256 chains): posterior means within 4 Monte
   Carlo standard errors of the closed-form conjugate posterior.
2. Full width through ``mcmcglm(X=, y=)``: logistic, n=10,000, d=1,000,
   256 chains, default engine (the freerun engine with the K=4
   speculative pass).  Pooled split-R-hat <= 1.05; agreement in law with
   the classic one-evaluation pass (``spec_k=1``): every coordinate's
   mean within 5 combined MCSE; and the throughput metrics of the
   default engine.
3. (``--four``) the chain-sharded engine over a 4x1 mesh (1,024 chains)
   and the observation-sharded engine over a 1x4 mesh (256 chains), each
   compared in law with a single-card run of the same problem.

The lines before the last are ``nvidia-smi``'s name and power limit of
each card; the last line is one JSON object with ``ok`` and the device as
JAX reports it.  Exits non-zero, printing no result, when JAX finds no
accelerator.  Every phase runs in this one process: a JAX process
reserves most of a card's memory, so a second one would fail.
"""

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

N_CHAINS = 256
BURNIN, N_SAMPLES = 50, 250  # phase 2: 200 kept sweeps


def log(msg):
    print(msg, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


def mcse(draws):
    """Per-coordinate Monte Carlo standard error of the pooled mean of
    (chains, draws, params) samples, and the bulk ESS it uses."""
    from mcmcglm_tpu.diagnostics import ess

    e = np.asarray(ess(draws))
    sd = draws.reshape(-1, draws.shape[-1]).std(axis=0, ddof=1)
    return sd / np.sqrt(e), e


def kept(fit):
    """The post-burn-in draws of an ``mcmcglm`` result, (C, S, d)."""
    return np.asarray(fit.beta)[:, fit.burnin + 1:, :]


def agree_in_law(a, b, label, n_se=5.0):
    """Every coordinate's pooled mean of draws ``a`` and ``b`` within
    ``n_se`` combined Monte Carlo standard errors."""
    se_a, _ = mcse(a)
    se_b, _ = mcse(b)
    z = np.abs(a.mean(axis=(0, 1)) - b.mean(axis=(0, 1))) / np.hypot(se_a,
                                                                    se_b)
    log(f"  {label}: max |mean difference| / combined MCSE = "
        f"{float(z.max())}")
    check(bool(np.all(z <= n_se)), f"{label} agree within {n_se} MCSE")


def phase_readme():
    import mcmcglm_tpu as mg

    log("phase 1: README example, gaussian, formula + dict data")
    rng = np.random.default_rng(42)
    n = 1000
    x1 = rng.normal(size=n)
    x2 = rng.binomial(1, 0.5, size=n).astype(np.float64)
    y = rng.normal(1.0 + 1.5 * x1 + 2.0 * x2, 1.0)
    t0 = time.perf_counter()
    fit = mg.mcmcglm(formula="Y ~ .", data={"Y": y, "x1": x1, "x2": x2},
                     family="gaussian", n_chains=N_CHAINS, w=0.5)
    log(f"  mcmcglm seconds (compilation included): "
        f"{time.perf_counter() - t0}")
    X = np.column_stack([np.ones(n), x1, x2])
    P = X.T @ X + np.eye(3)  # N(0, 1) prior, sd = 1
    mu = np.linalg.solve(P, X.T @ y)
    draws = kept(fit)
    se, e = mcse(draws)
    z = np.abs(draws.mean(axis=(0, 1)) - mu) / se
    log(f"  posterior mean {draws.mean(axis=(0, 1)).tolist()} vs closed "
        f"form {mu.tolist()}; ESS {e.tolist()}; |z| {z.tolist()}")
    check(bool(np.all(z <= 4.0)), "README posterior within 4 MCSE")


def full_width_data():
    from mcmcglm_tpu.datagen import generate_glm_data

    X, y, _ = generate_glm_data("binomial", n=10_000, d=1000, seed=0)
    return X, y


def fit_full(X, y, burnin=BURNIN, n_samples=N_SAMPLES, **engine_opts):
    """``mcmcglm`` at full width; returns the post-burn-in draws."""
    import mcmcglm_tpu as mg

    t0 = time.perf_counter()
    fit = mg.mcmcglm(X=X, y=y, family="binomial", n_chains=N_CHAINS,
                     n_samples=n_samples, burnin=burnin, w=0.5,
                     engine_opts=engine_opts or None)
    log(f"  mcmcglm{engine_opts or ''}, {n_samples - burnin} kept sweeps: "
        f"seconds (compilation included) {time.perf_counter() - t0}")
    return kept(fit)


def phase_full_width():
    import jax

    import bench
    from mcmcglm_tpu.diagnostics import split_rhat

    log("phase 2: full width, logistic n=10000 d=1000, 256 chains")
    X, y = full_width_data()
    draws = fit_full(X, y)
    rhat = float(np.max(split_rhat(draws)))
    log(f"  max split-R-hat over coordinates: {rhat}")
    check(rhat <= 1.05, "pooled split-R-hat <= 1.05")
    # the classic pass is ~2.5x slower per sweep: fewer kept sweeps
    agree_in_law(draws, fit_full(X, y, n_samples=BURNIN + 100, spec_k=1),
                 "default (spec_k=4) vs spec_k=1")

    log("  throughput of the default engine (spec_k=4, XLA battery):")
    timed = 100
    eng, state, setup_s = bench.build(X, y, 4, N_CHAINS, BURNIN)
    t0 = time.perf_counter()
    state, _, _ = eng.run(state, timed)
    jax.block_until_ready(state.beta)
    first_s = time.perf_counter() - t0
    state, m = bench.timed_run(eng, state, timed)
    m["pass_microseconds"] = 1e6 * bench.pass_seconds(eng, state, 1000)
    m["compile_and_warmup_seconds"] = setup_s
    m["first_run_seconds_compilation_included"] = first_s
    m["compile_seconds_run"] = first_s - m["timed_seconds"]
    log(f"  metrics: {json.dumps(m)}")
    check(all(math.isfinite(v) for v in m.values()), "metrics finite")
    return draws


def phase_four(n_devices=4):
    import jax

    import mcmcglm_tpu as mg
    from mcmcglm_tpu.parallel import (
        ObsShardedFreeRunCGGibbs, ShardedFreeRunCGGibbs, make_mesh,
    )

    check(len(jax.devices()) >= n_devices, f"{n_devices} devices visible")
    log("phase 3: chain-sharded 4x1 and obs-sharded 1x4 vs one card")
    X, y = full_width_data()
    burnin, keep = 25, 40
    ref = fit_full(X, y, burnin=burnin, n_samples=burnin + keep)

    prior = mg.IIDPrior(mg.Normal(0.0, 1.0), X.shape[1])
    devs = jax.devices()[:n_devices]
    for label, mesh, C in (
        ("chain-sharded 4x1", make_mesh(n_devices, 1, devices=devs),
         n_devices * N_CHAINS),
        ("obs-sharded 1x4", make_mesh(1, n_devices, devices=devs), N_CHAINS),
    ):
        cls = (ShardedFreeRunCGGibbs if mesh.shape["obs"] == 1
               else ObsShardedFreeRunCGGibbs)
        eng = cls(X, y, "binomial", prior, mesh=mesh, tuning={"w": 0.5},
                  spec_k=4)
        t0 = time.perf_counter()
        st = eng.init(jax.random.key(1), C)
        nev_init = np.asarray(st.nev)
        st, _, _ = eng.warmup(st, burnin)
        st, draws, _ = eng.run(st, keep)
        draws = np.asarray(draws)
        log(f"  {label}: {C} chains, seconds (compilation included) "
            f"{time.perf_counter() - t0}")
        shards = {d.id: np.asarray(s.data).sum() for d, s in (
            (s.device, s) for s in st.nev.addressable_shards)}
        log(f"  evaluations per device: {shards}")
        check(len(shards) == n_devices and all(v > 0 for v in
                                                shards.values()),
              f"{label}: every device advanced")
        check(bool(np.all(np.asarray(st.nev) > nev_init)),
              f"{label}: every chain advanced")
        agree_in_law(draws, ref, f"{label} vs one card")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("chip_smoke: JAX found no accelerator", file=sys.stderr)
        return 1
    from mcmcglm_tpu.utils.device import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    if args.four:
        phase_four()
    else:
        phase_readme()
        phase_full_width()
    log(f"total seconds: {time.perf_counter() - t0}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
