"""Tall-data sharding, on-device diagnostics, and alternative kernels.

Round-5 surface tour: (1) the obs-sharded freerun engine — the fast
automaton over a (chain x obs) mesh, for datasets whose design matrix or
linear-predictor slab exceeds one card's memory; (2) streaming min-ESS on
device — the split-chain autocovariance accumulator that replaces the
(C, K, d) host gather with a (d,) vector; (3) the latent (Li & Walker
2020) and doubling (Neal 2003, Figs. 4-6) slice kernels running at full
freerun speed — with doubling, all six qslice kernels are on the fast
automaton.

On CPU run with 8 virtual devices:

  env JAX_PLATFORMS=cpu \
      XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/06_tall_data_and_recovery.py
"""

import jax
import numpy as np

import mcmcglm_tpu as mg
from mcmcglm_tpu.parallel import ObsShardedFreeRunCGGibbs, make_mesh
from mcmcglm_tpu.parallel.pooled import ess_from_state, pooled_summary

n_dev = len(jax.devices())
obs_shards = 4 if n_dev >= 8 else max(1, n_dev // 2)
mesh = make_mesh(n_dev // obs_shards, obs_shards)
print(f"devices: {n_dev}, mesh: {dict(mesh.shape)}")

# -- 1. obs-sharded freerun: X^T column slabs + eta sharded over `obs`,
#       one psum of the per-shard log-lik partial sums per pass ---------
rng = np.random.default_rng(0)
n, d = 20_000, 12  # "tall": many observations, few parameters
X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1)) / np.sqrt(d - 1)])
beta_true = rng.normal(size=d)
y = rng.binomial(1, 1 / (1 + np.exp(-X @ beta_true))).astype(float)

eng = ObsShardedFreeRunCGGibbs(
    X, y, "binomial", mg.IIDPrior(mg.Normal(0, 1), d),
    tuning={"w": 0.5}, mesh=mesh,
)
n_chains = 8 * mesh.shape["chain"]
state = eng.init(jax.random.key(0), n_chains)
state, _, _ = eng.warmup(state, 60)

# -- 2. thinned collection with BOTH streaming accumulators: Welford
#       moments (mean/R-hat) and the split-chain autocovariance (ESS).
#       Nothing bigger than (d,) needs to leave the device. -------------
state, mom, kept, nev, es = eng.run_thinned(state, n_outer=150, thin=2,
                                            ess=True)
summary = pooled_summary(mom._replace(count=mom.count))
dev_ess = np.asarray(jax.jit(ess_from_state)(es))
err = np.abs(np.asarray(summary["mean"]) - beta_true)
print(f"chains: {n_chains}, kept draws/chain: {kept.shape[1]}")
print("max |posterior mean - truth|:", round(float(err.max()), 3))
print("max pooled rhat:", round(float(np.asarray(summary['rhat']).max()), 4))
print("min ESS (on-device streaming):", round(float(dev_ess.min()), 1))
print("min ESS (host FFT, same draws):",
      round(float(np.min(mg.ess(np.asarray(kept)))), 1))

# -- 3. alternative slice kernels at freerun speed ----------------------
fit = mg.mcmcglm(
    X=X[:2000], y=y[:2000], family="binomial",
    beta_prior=mg.IIDPrior(mg.Normal(0, 1), d),
    slice_fn="latent", rate=0.5, engine="freerun",
    n_samples=300, burnin=80, n_chains=8, seed=0,
)
print("latent-kernel coef head:  ", np.asarray(fit.coef())[:4].round(3))

# doubling expands the interval geometrically (robust to a badly sized
# w) and replays Neal's Fig. 6 back-test as extra automaton phases
fit = mg.mcmcglm(
    X=X[:2000], y=y[:2000], family="binomial",
    beta_prior=mg.IIDPrior(mg.Normal(0, 1), d),
    slice_fn="doubling", w=0.1, engine="freerun",
    n_samples=300, burnin=80, n_chains=8, seed=0,
)
print("doubling-kernel coef head:", np.asarray(fit.coef())[:4].round(3))

# quantile with ADAPTED pseudo-targets (Heiner et al. 2024): each
# (chain, coordinate) learns its own pseudo-target loc/scale during
# warmup (Robbins-Monro, like the stepping-out widths), frozen for
# sampling — fixes the fixed global pseudo-target's two failure modes
# (coordinates away from loc; narrow/skewed conditionals)
fit = mg.mcmcglm(
    X=X[:2000], y=y[:2000], family="binomial",
    beta_prior=mg.IIDPrior(mg.Normal(0, 1), d),
    slice_fn="quantile", pseudo_adapt=True, pseudo_c=5.0,
    engine="freerun",
    n_samples=300, burnin=80, n_chains=8, seed=0,
)
print("adapted-quantile coef head:", np.asarray(fit.coef())[:4].round(3))
print("truth head:               ", beta_true[:4].round(3))
