"""North-star benchmark on one GPU: min-ESS/s of the p=1000 logistic GLM
(BASELINE.md) for the K-speculative pass and the classic pass.

Configuration: logistic regression, n=10,000 observations, d=1,000
coefficients, N(0,1) prior, 256 chains on one card, the ``mcmcglm``
default freerun path (stepping-out warmup with width adaptation, then the
shrink-only slice kernel).  Two engine variants run in one process:

* ``xla-k4``: spec_k=4, the accelerator default of ``mcmcglm``;
* ``xla-k1``: the classic one-evaluation pass.

Each variant is warmed up (compile + burn-in), then timed over the same
number of sweeps in two rounds, in the order A B then B A, so drift on the
card touches both alike.  Per variant and round the bench reports
sweeps/s, min-ESS/s (pooled bulk ESS of the timed draws, minimum over
coordinates, over the timed wall time) and target evaluations per
coordinate; per variant, microseconds per device pass (a fixed number of
passes with every lane active) and that pass's share of the device-memory
roofline for the bytes the algorithm must move per pass (read eta, read
the chains' X^T rows, write eta).

``vs_baseline``: the reference is single-chain R with no published
numbers (BASELINE.md); the stand-in is the same CGGibbs algorithm in
vectorised NumPy on this host, credited with 1.0 ESS per sweep (ESS
cannot exceed the draw count), which understates the speedup over R.

Output: one JSON line per (variant, round), then one summary line.
Exits non-zero when JAX finds no accelerator.
"""

import json
import sys
import time

import numpy as np

N, D, CHAINS, BURNIN, TIMED_SWEEPS = 10_000, 1000, 256, 50, 100
PROBE_PASSES = 1000
VARIANTS = (("xla-k4", 4), ("xla-k1", 1))


def _numpy_baseline_sweep_rate(X, y, w=0.5, n_sweeps=2, seed=0, prior_sd=1.0):
    """Single-chain CGGibbs in NumPy (reference-algorithm proxy): stepping-out
    slice per coordinate with the O(n) incremental eta update."""
    rng = np.random.default_rng(seed)
    n, d = X.shape
    beta = rng.normal(size=d) * prior_sd
    eta = X @ beta

    def loglik(e):
        # Bernoulli/logit: sum(y*eta - log1p(exp(eta)))
        return float(np.sum(y * e - np.logaddexp(0.0, e)))

    def logpost_from(bj, j, eta):
        e = eta + X[:, j] * (bj - beta[j])
        return loglik(e) - 0.5 * (bj / prior_sd) ** 2

    t0 = time.perf_counter()
    for _ in range(n_sweeps):
        for j in range(d):
            f0 = logpost_from(beta[j], j, eta)
            level = f0 + np.log(rng.uniform())
            u = rng.uniform()
            L, R = beta[j] - w * u, beta[j] - w * u + w
            m = 128
            jj = int(m * rng.uniform())
            kk = m - 1 - jj
            while jj > 0 and logpost_from(L, j, eta) > level:
                L -= w
                jj -= 1
            while kk > 0 and logpost_from(R, j, eta) > level:
                R += w
                kk -= 1
            for _ in range(64):
                b1 = rng.uniform(L, R)
                if logpost_from(b1, j, eta) >= level:
                    break
                if b1 < beta[j]:
                    L = b1
                else:
                    R = b1
            eta = eta + X[:, j] * (b1 - beta[j])
            beta[j] = b1
    dt = time.perf_counter() - t0
    return n_sweeps / dt


def build(X, y, spec_k, n_chains, burnin):
    """Engine of the ``mcmcglm`` default freerun path, initialised and
    warmed up.  Returns (engine, state, seconds of construct + init +
    warmup, compilation included)."""
    import jax

    import mcmcglm_tpu as mg
    from mcmcglm_tpu.freerun import FreeRunCGGibbs

    t0 = time.perf_counter()
    eng = FreeRunCGGibbs(
        X, y, "binomial", mg.IIDPrior(mg.Normal(0.0, 1.0), X.shape[1]),
        tuning={"w": 0.5}, spec_k=spec_k,
    )
    state = eng.init(jax.random.key(0), n_chains)
    state, _, _ = eng.warmup(state, burnin)
    jax.block_until_ready(state.beta)
    return eng, state, time.perf_counter() - t0


def pass_seconds(eng, state, n_passes):
    """Seconds per device pass: ``n_passes`` passes with every lane active
    (the sweep quota is unreachable), timed after one compiling call."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    probe = jax.jit(partial(eng._run_pass_block, n_sweeps=1 << 30,
                            n_passes=n_passes, adapt=False, shrink_only=True))
    sc = jnp.zeros((state.beta.shape[0],), jnp.int32)
    st, _ = probe(state, sc)
    jax.block_until_ready(st.beta)
    t0 = time.perf_counter()
    st, _ = probe(st, sc)
    jax.block_until_ready(st.beta)
    return (time.perf_counter() - t0) / n_passes


def timed_run(eng, state, n_sweeps):
    """One timed ``run`` of ``n_sweeps`` sweeps (already compiled for this
    sweep count).  Returns (state, metrics)."""
    import jax

    from mcmcglm_tpu.diagnostics import ess

    nev0 = np.asarray(state.nev).copy()
    t0 = time.perf_counter()
    state, draws, _ = eng.run(state, n_sweeps)
    jax.block_until_ready(draws)
    dt = time.perf_counter() - t0
    ess_all = ess(np.asarray(draws))
    evals = (np.asarray(state.nev) - nev0).mean() / (n_sweeps * eng.d)
    return state, {
        "timed_seconds": dt,
        "sweeps_per_sec": n_sweeps / dt,
        "min_ess_per_sec": float(np.min(ess_all)) / dt,
        "median_ess_per_sec": float(np.median(ess_all)) / dt,
        "evals_per_coord": float(evals),
    }


def pass_bytes(n_chains, n):
    """Bytes one pass must move at least: read eta, read each chain's
    X^T row, write eta — three (C, n) float32 streams."""
    return 3 * n_chains * n * 4


def main():
    import jax

    from mcmcglm_tpu.datagen import generate_glm_data
    from mcmcglm_tpu.utils.device import (
        enable_compile_cache, hbm_peak_bytes_per_s, require_accelerator,
    )

    dev = require_accelerator()
    enable_compile_cache()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    X, y, _ = generate_glm_data("binomial", n=N, d=D, seed=0)

    engines = {}
    for name, k in VARIANTS:
        eng, state, setup_s = build(X, y, k, CHAINS, BURNIN)
        t0 = time.perf_counter()
        state, _, _ = eng.run(state, TIMED_SWEEPS)  # compiles this length
        jax.block_until_ready(state.beta)
        engines[name] = [eng, state, {
            "setup_seconds": setup_s,
            "first_run_seconds": time.perf_counter() - t0,
            "spec_k": eng.spec_k,
        }]
        print(f"# built {name}: {engines[name][2]}", file=sys.stderr,
              flush=True)

    order = [v[0] for v in VARIANTS]
    rows = []
    for rnd, names in enumerate((order, order[::-1])):
        for name in names:
            eng, state, info = engines[name]
            state, m = timed_run(eng, state, TIMED_SWEEPS)
            engines[name][1] = state
            row = {"variant": name, "round": rnd, **info, **m,
                   "timed_sweeps": TIMED_SWEEPS, "n": N, "d": D,
                   "n_chains": CHAINS, "device": device}
            rows.append(row)
            print(json.dumps(row), flush=True)

    peak = hbm_peak_bytes_per_s(dev.device_kind)
    summary = {}
    for name in order:
        eng, state, _ = engines[name]
        pass_s = pass_seconds(eng, state, PROBE_PASSES)
        summary[name] = {
            "pass_microseconds": 1e6 * pass_s,
            "pass_hbm_roofline_share": pass_bytes(CHAINS, N) / peak / pass_s,
            "min_ess_per_sec": [r["min_ess_per_sec"] for r in rows
                                if r["variant"] == name],
            "sweeps_per_sec": [r["sweeps_per_sec"] for r in rows
                               if r["variant"] == name],
        }
    best = max(order, key=lambda v: np.median(summary[v]["min_ess_per_sec"]))
    np_rate = _numpy_baseline_sweep_rate(X, y)
    value = float(np.median(summary[best]["min_ess_per_sec"]))
    print(json.dumps({
        "metric": f"min_ess_per_sec_p{D}_logistic_1chip",
        "value": value,
        "unit": "ESS/s",
        "best_variant": best,
        "vs_baseline": value / np_rate,
        "baseline_proxy_sweeps_per_sec": np_rate,
        "hbm_peak_bytes_per_s": peak,
        "variants": summary,
        "device": device,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
