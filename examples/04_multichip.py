"""Multi-chip sharded sampling + pooled diagnostics.

Runs 64 chains of a logistic GLM over a (chain x obs) device mesh — on a
multi-GPU host this is real multi-device execution; on CPU run it with 8
virtual devices:

  env JAX_PLATFORMS=cpu \
      XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/04_multichip.py
"""

import jax
import numpy as np

import mcmcglm_tpu as mg
from mcmcglm_tpu.parallel import ShardedCGGibbs, make_mesh
from mcmcglm_tpu.parallel.pooled import ChainMoments, pooled_summary

n_dev = len(jax.devices())
mesh = make_mesh(n_dev // 2, 2) if n_dev % 2 == 0 and n_dev > 1 else make_mesh(n_dev, 1)
print(f"devices: {n_dev}, mesh: {dict(mesh.shape)}")

rng = np.random.default_rng(0)
n, d = 4000, 20
X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1)) / np.sqrt(d - 1)])
beta_true = rng.normal(size=d)
y = rng.binomial(1, 1 / (1 + np.exp(-X @ beta_true))).astype(float)

eng = ShardedCGGibbs(
    X, y, "binomial", mg.IIDPrior(mg.Normal(0, 1), d), tuning={"w": 0.5}, mesh=mesh
)
n_chains = 8 * mesh.shape["chain"]
state = eng.init(jax.random.key(0), n_chains)
state, _, _ = eng.run(state, 100)  # burn-in
state, mom, draws, n_evals = eng.run_thinned(state, n_outer=100, thin=2)

summary = pooled_summary(ChainMoments(mom.count[0], mom.mean, mom.m2))
err = np.abs(np.asarray(summary["mean"]) - beta_true)
print(f"chains: {n_chains}, draws/chain: {int(mom.count[0])}")
print("max |posterior mean - truth|:", float(err.max()))
print("max pooled rhat:", float(np.asarray(summary['rhat']).max()))
print("split-rhat from thinned draws:", float(mg.split_rhat(np.asarray(draws)).max()))
print("min ESS (thinned draws):", float(np.min(mg.ess(np.asarray(draws)))))
