"""Same-process A/B: adapted quantile pseudo-targets (pseudo_adapt=True,
Heiner et al. 2024 freeze-after-warmup) vs the fixed global Cauchy(0, 2)
pseudo-target and warmup-adapted stepping-out.

Protocol: one process, interleaved construction, same battery (K=4), same
chain count, so drift on the device touches every variant alike.  Prints
one JSON row per variant.

  QA_PROBLEM  logistic_p1000 (default; the north star) |
              logistic_p100 | poisson_laplace_p100
  QA_CLADDER  comma list of pseudo_c values (default "2,5,10,20")
  QA_ANCHORS  comma list of anchors to run (default
              "quantile_s2,stepping_out"; "" for none)
"""

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402


def main():
    import jax

    import mcmcglm_tpu as mg
    from mcmcglm_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    from mcmcglm_tpu.datagen import generate_glm_data
    from mcmcglm_tpu.diagnostics import ess
    from mcmcglm_tpu.freerun import FreeRunCGGibbs

    on_accel = jax.default_backend() != "cpu"
    problem = os.environ.get("QA_PROBLEM", "logistic_p1000")
    if problem == "logistic_p1000":
        fam, n, d, C = "binomial", (10_000 if on_accel else 2000), \
            (1000 if on_accel else 100), (256 if on_accel else 8)
        prior = mg.IIDPrior(mg.Normal(0.0, 1.0), d)
        sweeps, burn = (120, 30) if on_accel else (40, 20)
    elif problem == "logistic_p100":
        fam, n, d, C = "binomial", 10_000, 100, 64
        prior = mg.IIDPrior(mg.Normal(0.0, 1.0), d)
        sweeps, burn = 100, 30
    elif problem == "poisson_laplace_p100":
        fam, n, d, C = "poisson", 10_000, 100, 64
        prior = mg.IIDPrior(mg.Laplace(0.0, 1.0), d)
        sweeps, burn = 100, 30
    else:
        raise SystemExit(f"unknown QA_PROBLEM {problem}")

    X, y, _ = generate_glm_data(fam, n=n, d=d, seed=0)

    variants = []
    anchors = os.environ.get("QA_ANCHORS", "quantile_s2,stepping_out")
    for a in [s for s in anchors.split(",") if s]:
        if a == "quantile_s2":
            variants.append(("quantile_s2", {
                "slice_kernel": "quantile",
                "tuning": {"pseudo_loc": 0.0, "pseudo_scale": 2.0}}))
        elif a == "stepping_out":
            variants.append(("stepping_out", {
                "slice_kernel": "stepping_out", "tuning": {"w": 0.5}}))
    for c in os.environ.get("QA_CLADDER", "2,5,10,20").split(","):
        if not c:
            continue
        variants.append((f"quantile_adapt_c{c}", {
            "slice_kernel": "quantile",
            "tuning": {"pseudo_scale": 2.0, "pseudo_adapt": True,
                       "pseudo_c": float(c)}}))

    for name, kw in variants:
        t0 = time.perf_counter()
        kwargs = dict(
            spec_k=4 if on_accel else 1,
        )
        kwargs.update(kw)
        eng = FreeRunCGGibbs(X, y, fam, prior, **kwargs)
        state = eng.init(jax.random.key(0), C)
        state, _, _ = eng.warmup(state, burn)
        jax.block_until_ready(state.beta)
        print(f"# {name} setup {time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)
        chunk = 25
        state, _, _ = eng.run(state, chunk)
        jax.block_until_ready(state.beta)
        nev0 = np.asarray(state.nev).copy()
        tA = time.perf_counter()
        parts = []
        done = 0
        while done < sweeps:
            state, b, _ = eng.run(state, chunk)
            parts.append(b)
            done += chunk
        jax.block_until_ready(parts)
        tsec = time.perf_counter() - tA
        draws = np.concatenate([np.asarray(p) for p in parts], axis=1)
        e = ess(draws)
        evals = float((np.asarray(state.nev) - nev0).mean()) / done
        row = {
            "problem": problem, "kernel": name,
            "spec_k": eng.spec_k, "C": C,
            "sweeps": done, "seconds": round(tsec, 3),
            "sweeps_per_sec": round(done / tsec, 3),
            "evals_per_coord": round(evals / d, 3),
            "min_ess": round(float(np.min(e)), 1),
            "median_ess": round(float(np.median(e)), 1),
            "min_ess_per_sec": round(float(np.min(e)) / tsec, 1),
            "min_ess_per_draw": round(float(np.min(e)) / (C * done), 4),
        }
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
