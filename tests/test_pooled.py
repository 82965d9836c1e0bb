"""Tests for the pod-scale streaming collection mode (run_thinned +
pooled Welford moments; parallel/pooled.py)."""

import jax
import numpy as np
import pytest

import mcmcglm_tpu as mg
from mcmcglm_tpu.parallel import ShardedCGGibbs, make_mesh
from mcmcglm_tpu.parallel.pooled import (
    ChainMoments,
    init_moments,
    pooled_summary,
    update_moments,
)


class TestMomentsPrimitive:
    def test_welford_matches_numpy(self):
        rng = np.random.default_rng(0)
        draws = rng.normal(size=(100, 6, 3))  # (K, C, d)
        m = init_moments(6, 3, np.float64)
        for k in range(100):
            m = update_moments(m, draws[k])
        np.testing.assert_allclose(np.asarray(m.mean), draws.mean(0), rtol=1e-9)
        var = np.asarray(m.m2) / 99.0
        np.testing.assert_allclose(var, draws.var(0, ddof=1), rtol=1e-9)

    def test_rhat_flags_divergence(self):
        rng = np.random.default_rng(1)
        draws = rng.normal(size=(200, 4, 2))
        draws[:, 0, :] += 8.0  # one far-away chain
        m = init_moments(4, 2, np.float64)
        for k in range(200):
            m = update_moments(m, draws[k])
        s = pooled_summary(m)
        assert (np.asarray(s["rhat"]) > 1.5).all()


class TestRunThinned:
    def test_matches_full_run_moments(self, readme_gaussian_data):
        X, y, _ = readme_gaussian_data
        eng = mg.CGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), 3),
            extra={"sd": 1.0}, tuning={"w": 0.5},
        )
        st = eng.init(jax.random.key(0), 4)
        st, _, _ = eng.run(st, 50)
        _, mom, draws, _ = eng.run_thinned(st, n_outer=30, thin=5)
        _, betas, _ = eng.run(st, 150)
        full = np.asarray(betas)  # (C, 150, d)
        # identical RNG path: streaming mean == full-collection mean exactly
        np.testing.assert_allclose(
            np.asarray(mom.mean), full.mean(axis=1), rtol=1e-5
        )
        assert np.asarray(draws).shape == (4, 30, 3)
        # thinned draws are every 5th sweep of the full run
        np.testing.assert_allclose(
            np.asarray(draws), full[:, 4::5, :], rtol=1e-6
        )

    def test_sharded_thinned(self, readme_gaussian_data):
        X, y, _ = readme_gaussian_data
        eng = ShardedCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), 3),
            extra={"sd": 1.0}, tuning={"w": 0.5}, mesh=make_mesh(4, 2),
        )
        st = eng.init(jax.random.key(0), 8)
        st, mom, draws, _ = eng.run_thinned(st, n_outer=10, thin=3)
        s = pooled_summary(ChainMoments(mom.count[0], mom.mean, mom.m2))
        assert np.isfinite(np.asarray(s["mean"])).all()
        assert np.asarray(draws).shape == (8, 10, 3)


def test_sharded_thin1_boundaries_intercept_mixes():
    """Pod-collection regression (round-4 boundary-idle bug): the sharded
    engine driven exactly like the pod config — run_thinned(thin=1),
    one-sweep dispatches, streaming moments — must keep the intercept
    mixing in every chain (pre-fix: pooled R-hat 14, a large share of
    chains frozen at thousands of chains)."""
    import mcmcglm_tpu as mg
    from mcmcglm_tpu.datagen import generate_glm_data
    from mcmcglm_tpu.parallel.freerun_sharded import ShardedFreeRunCGGibbs
    from mcmcglm_tpu.parallel.pooled import pooled_summary

    X, y, _ = generate_glm_data("binomial", n=500, d=5, seed=0)
    eng = ShardedFreeRunCGGibbs(
        X, y, "binomial", mg.make_beta_prior(mg.Normal(0, 1), 5),
        tuning={"w": 0.5}, spec_k=4,
    )
    st = eng.init(jax.random.key(0), 32)
    st, _, _ = eng.warmup(st, 20)
    mom, parts = None, []
    for _ in range(25):
        st, mom, dr, _ = eng.run_thinned(st, n_outer=1, thin=1, moments=mom)
        parts.append(np.asarray(dr))
    draws = np.concatenate(parts, axis=1)
    rhat = np.asarray(jax.jit(pooled_summary)(mom)["rhat"])
    frozen = int((draws[:, :, 0].std(axis=1) < 1e-7).sum())
    assert frozen == 0
    assert float(rhat.max()) < 1.3
