"""Same-process A/B: stepping_out vs latent slice kernel on the freerun
engine at the north-star config (VERDICT r4 #6 done-criterion: an A/B
bench entry for the second fast kernel).

Both kernels run in ONE process, interleaved construction order fixed,
same spec_k, same chain count, so drift on the device
touches every kernel alike.  Prints one JSON row per kernel.
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
    n, d, C = (10_000, 1000, 256) if on_accel else (2000, 100, 8)
    sweeps, burn = (120, 30) if on_accel else (40, 20)
    rate = float(os.environ.get("AB_RATE", "0.3"))

    X, y, _ = generate_glm_data("binomial", n=n, d=d, seed=0)

    variants = [
        ("stepping_out", {"slice_kernel": "stepping_out",
                          "tuning": {"w": 0.5}}),
        ("latent", {"slice_kernel": "latent", "tuning": {"rate": rate}}),
        # sigma = prior sd: the standard ESS choice (prior as auxiliary);
        # unlike stepping_out/latent the bracket is not per-coordinate
        # adapted, so ESS/draw is expected lower — recorded honestly
        ("elliptical", {"slice_kernel": "elliptical",
                        "tuning": {"mu": 0.0, "sigma": 1.0}}),
        ("genelliptical", {"slice_kernel": "genelliptical",
                           "tuning": {"mu": 0.0, "sigma": 1.0,
                                      "df": 5.0}}),
        ("quantile", {"slice_kernel": "quantile",
                      "tuning": {"pseudo_loc": 0.0, "pseudo_scale": 1.0}}),
        # doubling: classic one-evaluation pass only (the Fig. 6
        # back-test does not compose with the speculative battery), so
        # its pass rate is bounded by the spec_k=1 automaton; recorded
        # as the completeness entry for the sixth kernel
        ("doubling", {"slice_kernel": "doubling",
                      "tuning": {"w": float(os.environ.get(
                          "AB_DOUBLING_W", "0.5"))},
                      "spec_k": 1}),
    ]
    only = os.environ.get("AB_KERNELS")
    if only:
        sel = set(only.split(","))
        variants = [v for v in variants if v[0] in sel]
    for name, kw in variants:
        t0 = time.perf_counter()
        kwargs = dict(
            spec_k=4 if on_accel else 1,
        )
        kwargs.update(kw)
        eng = FreeRunCGGibbs(
            X, y, "binomial", mg.IIDPrior(mg.Normal(0.0, 1.0), d),
            **kwargs,
        )
        state = eng.init(jax.random.key(0), C)
        state, _, _ = eng.warmup(state, burn)
        jax.block_until_ready(state.beta)
        print(f"# {name} setup {time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)
        chunk = 30
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
        evals = float((np.asarray(state.nev) - nev0).mean()) / sweeps
        row = {
            "kernel": name, "spec_k": eng.spec_k, "C": C,
            "rate": rate if name == "latent" else None,
            "sweeps": sweeps, "seconds": round(tsec, 3),
            "sweeps_per_sec": round(sweeps / tsec, 3),
            "evals_per_coord": round(evals / d, 3),
            "min_ess": round(float(np.min(e)), 1),
            "median_ess": round(float(np.median(e)), 1),
            "min_ess_per_sec": round(float(np.min(e)) / tsec, 1),
            "min_ess_per_draw": round(float(np.min(e)) / (C * sweeps), 4),
        }
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
