"""Quick probe: warm freerun sweeps/s vs chain count on the north-star
config.  min-ESS/s scales ~ C * sweeps/s (per-draw mixing is C-independent),
so the best C maximises C * sweeps/s per chip.

Run: python scripts/c_scaling_probe.py [C ...]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

import mcmcglm_tpu as mg
from mcmcglm_tpu.datagen import generate_glm_data
from mcmcglm_tpu.freerun import FreeRunCGGibbs


def main():
    cs = [int(a) for a in sys.argv[1:]] or [128, 256, 512, 1024]
    n, d = 10_000, 1000
    spec = {} if jax.default_backend() == "cpu" else \
        {"spec_k": 4}
    X, y, _ = generate_glm_data("binomial", n=n, d=d, seed=0)
    for C in cs:
        eng = FreeRunCGGibbs(
            X, y, "binomial", mg.IIDPrior(mg.Normal(0.0, 1.0), d),
            tuning={"w": 0.5}, **spec,
        )
        state = eng.init(jax.random.key(0), C)
        state, _, _ = eng.warmup(state, 15)
        jax.block_until_ready(state.beta)
        state, _, _ = eng.run(state, 10)  # compile sampling executable
        jax.block_until_ready(state.beta)
        nev0 = np.asarray(state.nev).copy()
        sweeps, chunk = 30, 10
        t0 = time.perf_counter()
        done = 0
        while done < sweeps:
            state, draws, nev = eng.run(state, chunk)
            done += chunk
        jax.block_until_ready(draws)
        dt = time.perf_counter() - t0
        evals = float(np.max(np.asarray(state.nev) - nev0))
        print(
            f"C={C:5d}: {sweeps/dt:7.3f} sweeps/s, "
            f"C*sweeps/s={C*sweeps/dt:9.1f}, "
            f"{dt/evals*1e6:6.1f} us/pass, {evals/sweeps/d:.2f} evals/coord",
            flush=True,
        )


if __name__ == "__main__":
    main()
