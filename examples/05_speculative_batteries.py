"""Speculative proposal batteries: the freerun throughput lever.

The free-running CGGibbs automaton (mcmcglm_tpu/freerun.py) advances every
chain by one slice-kernel target evaluation per device pass.  In Neal's
shrinkage procedure the ALL-REJECTIONS proposal path is deterministic given
the uniforms, so K proposals can be generated up front, evaluated in one
pass, and the first acceptor selected — identical in law to the
one-at-a-time kernel (the reference's qslice::slice_stepping_out schedule,
R/mcmcglm.R:258-261) but with passes-per-coordinate dropping from the mean
evaluation count toward ~1.

The battery is one XLA (C, K, n) broadcast + reduce over the gathered X^T
rows (ops/freerun_passes.py).  On an H100 the K=4 pass gives a higher
min-ESS/s than the classic pass at the p=1000 logistic north star, which
is why ``mcmcglm`` enables spec_k=4 on accelerators (PERF.md has the
measured rates).

Run from the repo root:

  env JAX_PLATFORMS=cpu python examples/05_speculative_batteries.py
"""

import time

import numpy as np

import mcmcglm_tpu as mg

rng = np.random.default_rng(0)
n, d = 2_000, 50
X = rng.normal(size=(n, d)) / np.sqrt(d)
beta_true = rng.normal(size=d)
y = rng.binomial(1, 1.0 / (1.0 + np.exp(-X @ beta_true))).astype(float)

for engine_opts in (
    {},  # classic: one evaluation per pass
    {"spec_k": 4},  # K-speculative battery
):
    t0 = time.perf_counter()
    fit = mg.mcmcglm(
        family="binomial", X=X, y=y, beta_prior=mg.Normal(0.0, 1.0),
        n_samples=400, burnin=100, n_chains=8, seed=1, w=0.5,
        engine_opts=engine_opts,
    )
    dt = time.perf_counter() - t0
    err = float(np.abs(fit.coef().values - beta_true).max())
    print(
        f"engine_opts={engine_opts!r:18s}: {dt:5.1f}s, "
        f"max |coef - truth| = {err:.3f}, "
        f"mean evals/sweep = {float(fit.n_evals.mean()):.0f}"
    )

# The two fits target the same posterior (same kernel in law); on the GPU
# the speculative one completes the same sweeps in fewer, costlier passes
# (PERF.md has the measured rates).
