"""Chain-scaling study: warm throughput vs chain count on one chip.

BASELINE.md's scaling target is chain-scaling efficiency as chains grow;
on a single chip the measurable analogue is chains-per-chip scaling.
Protocol: for each C, compile, burn in (so step-out loops reflect warm
chains, not prior-cold ones — cold chains inflate the lockstep max-eval
count), then time warm sweeps.

Run (GPU):  python scripts/chain_scaling.py
Run (CPU):  env JAX_PLATFORMS=cpu python scripts/chain_scaling.py --small
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import time

import jax
import numpy as np

import mcmcglm_tpu as mg
from mcmcglm_tpu.datagen import generate_glm_data


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="CPU-sized problem")
    ap.add_argument("--engine", default="xla", choices=["xla", "fused"])
    ap.add_argument("--chains", default="")
    args = ap.parse_args()

    if args.small:
        n, d, burnin, timed = 2000, 100, 30, 30
        chain_counts = [8, 32, 128]
    else:
        n, d, burnin, timed = 10_000, 1000, 60, 30
        chain_counts = [64, 256, 1024]
    if args.chains:
        chain_counts = [int(c) for c in args.chains.split(",")]

    X, y, _ = generate_glm_data("binomial", n=n, d=d, seed=0)
    prior = mg.IIDPrior(mg.Normal(0.0, 1.0), d)
    results = []
    base_rate = None
    for C in chain_counts:
        if args.engine == "fused":
            from mcmcglm_tpu.fused import FusedCGGibbs

            eng = FusedCGGibbs(X, y, "binomial", prior, tuning={"w": 0.5})
        else:
            eng = mg.CGGibbs(X, y, "binomial", prior, tuning={"w": 0.5})
        state = eng.init(jax.random.key(0), C)
        t0 = time.perf_counter()
        state, b, _ = eng.run(state, 1)
        jax.block_until_ready(b)
        compile_s = time.perf_counter() - t0
        state, b, _ = eng.run(state, burnin)
        jax.block_until_ready(b)
        t0 = time.perf_counter()
        state, b, nev = eng.run(state, timed)
        jax.block_until_ready(b)
        dt = time.perf_counter() - t0
        rate = C * timed / dt
        if base_rate is None:
            base_rate = rate / C  # per-chain rate at the smallest C
        eff = rate / (base_rate * C)
        row = {
            "engine": args.engine,
            "chains": C,
            "ms_per_sweep": round(dt / timed * 1000, 1),
            "chain_sweeps_per_s": round(rate, 1),
            "scaling_efficiency": round(eff, 3),
            "compile_s": round(compile_s, 1),
            "mean_evals_per_sweep": round(float(np.mean(np.asarray(nev))), 1),
        }
        results.append(row)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
