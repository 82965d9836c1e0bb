"""Pod-scale same-session A/B: classic pass vs speculative battery at
C=4096 on the flagship sharded free-running engine.

Device throughput drifts between runs and cards, so the only
trustworthy many-chain comparison is adjacent runs in ONE process: this
probe warms and times spec_k=1, then spec_k=4, then
spec_k=1 again as a drift bracket, reporting chain-sweeps/s each time.

Run: python scripts/pod_ab_probe.py [chains] [timed_sweeps]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

import mcmcglm_tpu as mg
from mcmcglm_tpu.datagen import generate_glm_data
from mcmcglm_tpu.parallel.freerun_sharded import ShardedFreeRunCGGibbs


def log(m):
    print(time.strftime("%H:%M:%S"), m, flush=True)


def measure(X, y, d, C, timed, spec_k, warm_sweeps=10, wu_passes=2000):
    opts = {} if spec_k == 1 else {"spec_k": spec_k}
    eng = ShardedFreeRunCGGibbs(
        X, y, "binomial", mg.make_beta_prior(mg.Normal(0, 1), d),
        tuning={"w": 0.5}, **opts,
    )
    state = eng.init(jax.random.key(0), C)
    sc = None
    while True:
        state, sc = eng.warmup_passes(state, sc, warm_sweeps, wu_passes)
        jax.block_until_ready(state.beta)
        if (np.asarray(sc) >= warm_sweeps).all():
            break
    state, b, _ = eng.run(state, 2)  # compile sampling executable
    jax.block_until_ready(b)
    t0 = time.perf_counter()
    done = 0
    parts = []
    while done < timed:
        state, b, _ = eng.run(state, 2)
        parts.append(b)
        done += 2
    jax.block_until_ready(parts)
    dt = time.perf_counter() - t0
    rate = C * timed / dt
    log(f"spec_k={spec_k}: "
        f"{timed} sweeps in {dt:.1f} s -> {rate:.1f} chain-sweeps/s")
    return rate


def main():
    C = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    timed = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    n, d = 10_000, 1000
    X, y, _ = generate_glm_data("binomial", n=n, d=d, seed=0)
    log(f"pod A/B at C={C}, timed={timed}")
    r1a = measure(X, y, d, C, timed, 1)
    r4 = measure(X, y, d, C, timed, 4)
    r1b = measure(X, y, d, C, timed, 1)
    log(f"ratios: spec4/spec1(before)={r4 / r1a:.2f}, "
        f"spec4/spec1(after)={r4 / r1b:.2f}")


if __name__ == "__main__":
    main()
