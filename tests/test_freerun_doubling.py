"""Doubling slice kernel (Neal 2003, Figs. 4-6) at freerun speed — the
LAST of the six univariate kernels on the fast automaton, closing the
reference's "all functions from qslice are available" claim
(R/mcmcglm.R:35-39) at full engine speed for the whole surface.

The hard part is the Fig. 6 back-test (a nested evaluation loop in the
lockstep ops/slice_kernels.py::slice_doubling); the automaton unrolls it
to extra phases at one evaluation per pass (ops/freerun_doubling.py).
Equivalence with the lockstep kernel is distributional (same kernel law,
different PRNG consumption order), mirroring tests/test_freerun.py; the
bimodal test is the sharp one — with a too-small w the doubled interval
spans the inter-mode dip, so mode masses are only correct if the
back-test actually rejects (log-concave targets never exercise it)."""

import jax
import numpy as np
import pytest

import mcmcglm_tpu as mg
from mcmcglm_tpu.engine import CGGibbs, EngineConfig
from mcmcglm_tpu.freerun import FreeRunCGGibbs
from mcmcglm_tpu.ops.freerun_doubling import DoublingState


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    n, d = 300, 4
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    beta = np.array([1.0, 1.5, -0.5, 0.3])
    y = rng.normal(X @ beta, 1.0)
    prec = X.T @ X + np.eye(d)
    cov = np.linalg.inv(prec)
    mean = cov @ (X.T @ y)
    return X, y, mean, cov


def _fit_freerun(X, y, seed=0, warm=30, sweeps=300, w=0.5, **kw):
    d = X.shape[1]
    eng = FreeRunCGGibbs(
        X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
        extra={"sd": 1.0}, slice_kernel="doubling",
        tuning={"w": w}, **kw,
    )
    st = eng.init(jax.random.key(seed), 8)
    st, _, _ = eng.warmup(st, warm)
    nev0 = np.asarray(st.nev).copy()
    st, draws, _ = eng.run(st, sweeps)
    nev = (np.asarray(st.nev) - nev0).mean() / sweeps
    return np.asarray(draws), nev, eng, st


class TestDoublingFreeRun:
    def test_matches_conjugate_oracle(self, problem):
        X, y, mean, cov = problem
        draws, _, _, _ = _fit_freerun(X, y)
        post = draws[:, 100:, :].reshape(-1, X.shape[1])
        np.testing.assert_allclose(post.mean(0), mean, atol=0.05)
        np.testing.assert_allclose(
            post.std(0), np.sqrt(np.diag(cov)), rtol=0.15
        )

    def test_small_w_heavy_doubling(self, problem):
        """w far below the conditional scale: every coordinate doubles
        several times, so the expansion AND (hatL, hatR) halving walks
        both run — the posterior must be unchanged."""
        X, y, mean, cov = problem
        draws, nev, _, _ = _fit_freerun(X, y, seed=1, w=0.02, sweeps=400)
        post = draws[:, 100:, :].reshape(-1, X.shape[1])
        np.testing.assert_allclose(post.mean(0), mean, atol=0.05)
        np.testing.assert_allclose(
            post.std(0), np.sqrt(np.diag(cov)), rtol=0.15
        )
        assert nev / X.shape[1] > 6.0  # the schedule really ran

    def test_matches_lockstep_doubling_in_law(self, problem):
        X, y, mean, cov = problem
        d = X.shape[1]
        draws_fr, _, _, _ = _fit_freerun(X, y, seed=2, sweeps=300)

        eng = CGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0},
            config=EngineConfig(slice_kernel="doubling"),
            tuning={"w": 0.5},
        )
        betas, _, _ = eng.sample(jax.random.key(2), 330, n_chains=8)
        post_ls = betas[:, 101:, :].reshape(-1, d)
        post_fr = draws_fr[:, 100:, :].reshape(-1, d)
        np.testing.assert_allclose(
            post_fr.mean(0), post_ls.mean(0), atol=0.06
        )
        np.testing.assert_allclose(
            post_fr.std(0), post_ls.std(0), rtol=0.2
        )

    def test_bimodal_backtest_mode_masses(self):
        """The sharp back-test check.  Cauchy(0, 0.15) prior vs a
        single N(2.2, 1) observation: a bimodal 1-D posterior with a
        deep dip.  At w=0.05 the doubled interval spans the dip, so
        Fig. 6 rejections are frequent; a missing/always-passing
        back-test would mis-weight the modes (doubling without the
        back-test does not leave the target invariant).  Mode masses
        must match 1-D grid quadrature."""
        n = 1
        X = np.ones((n, 1))
        y = np.full(n, 2.2)
        prior = mg.IIDPrior(mg.StudentT(df=1.0, loc=0.0, scale=0.15), 1)

        g = np.linspace(-6.0, 9.0, 300001)
        lp = -0.5 * n * (g - 2.2) ** 2 - np.log(1 + (g / 0.15) ** 2)
        lp -= lp.max()
        p = np.exp(lp)
        p /= np.trapezoid(p, g)
        mass_exact = np.cumsum(p)[np.searchsorted(g, 1.0)] * (g[1] - g[0])

        eng = FreeRunCGGibbs(
            X, y, "gaussian", prior, extra={"sd": 1.0},
            slice_kernel="doubling", tuning={"w": 0.05},
        )
        st = eng.init(jax.random.key(5), 64)
        st, draws, _ = eng.run(st, 2000)
        d_ = np.asarray(draws)[:, 400:, 0].ravel()
        assert abs((d_ < 1.0).mean() - mass_exact) < 0.01
        assert abs(d_.mean() - np.trapezoid(g * p, g)) < 0.03

    def test_binomial_logit(self):
        rng = np.random.default_rng(5)
        n, d = 400, 3
        X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
        beta = np.array([0.5, 1.0, -1.0])
        y = rng.binomial(1, 1 / (1 + np.exp(-X @ beta)))
        eng = FreeRunCGGibbs(
            X, y, "binomial", mg.IIDPrior(mg.Normal(0, 2), d),
            slice_kernel="doubling", tuning={"w": 0.3},
        )
        st = eng.init(jax.random.key(6), 8)
        st, _, _ = eng.warmup(st, 40)
        st, draws, _ = eng.run(st, 400)
        post = np.asarray(draws)[:, 100:, :].reshape(-1, d)
        np.testing.assert_allclose(post.mean(0), beta, atol=0.4)

    def test_run_passes_bitwise_matches_run(self, problem):
        X, y, _, _ = problem
        d = X.shape[1]

        def make():
            return FreeRunCGGibbs(
                X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
                extra={"sd": 1.0}, slice_kernel="doubling",
                tuning={"w": 0.5},
            )

        e1 = make()
        s1 = e1.init(jax.random.key(7), 8)
        s1, d1, n1 = e1.run(s1, 25)

        e2 = make()
        s2 = e2.init(jax.random.key(7), 8)
        sc = dr = nb = None
        while True:
            s2, sc, dr, nb = e2.run_passes(s2, sc, dr, nb, 25, 33)
            if (np.asarray(sc) >= 25).all():
                break
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(dr))
        np.testing.assert_array_equal(np.asarray(n1), np.asarray(nb))
        np.testing.assert_array_equal(np.asarray(s1.beta), np.asarray(s2.beta))

    def test_state_class_and_validation(self, problem):
        X, y, _, _ = problem
        d = X.shape[1]
        prior = mg.IIDPrior(mg.Normal(0, 1), d)
        eng = FreeRunCGGibbs(
            X, y, "gaussian", prior, slice_kernel="doubling",
            tuning={"w": 0.5},
        )
        st = eng.init(jax.random.key(8), 4)
        assert isinstance(st, DoublingState)
        # doubling needs w
        with pytest.raises(ValueError, match="missing"):
            FreeRunCGGibbs(X, y, "gaussian", prior, slice_kernel="doubling")
        # no speculative batteries under the back-test
        with pytest.raises(ValueError, match="spec_k=1"):
            FreeRunCGGibbs(
                X, y, "gaussian", prior, slice_kernel="doubling",
                tuning={"w": 0.5}, spec_k=4,
            )
        with pytest.raises(ValueError, match="battery_impl"):
            FreeRunCGGibbs(
                X, y, "gaussian", prior, slice_kernel="doubling",
                tuning={"w": 0.5}, battery_impl="triton",
            )


class TestDoublingSharded:
    def test_chain_sharded_doubling(self, problem):
        from mcmcglm_tpu.parallel import ShardedFreeRunCGGibbs, make_mesh

        X, y, mean, _ = problem
        d = X.shape[1]
        eng = ShardedFreeRunCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0}, mesh=make_mesh(8, 1),
            slice_kernel="doubling", tuning={"w": 0.5},
        )
        st = eng.init(jax.random.key(9), 8)
        st, draws, _ = eng.run(st, 300)
        post = np.asarray(draws)[:, 100:, :].reshape(-1, d)
        np.testing.assert_allclose(post.mean(0), mean, atol=0.06)

    def test_obs_sharded_doubling(self, problem):
        from mcmcglm_tpu.parallel import (
            ObsShardedFreeRunCGGibbs,
            make_mesh,
        )

        X, y, mean, _ = problem
        d = X.shape[1]
        eng = ObsShardedFreeRunCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0}, mesh=make_mesh(2, 4),
            slice_kernel="doubling", tuning={"w": 0.5},
        )
        st = eng.init(jax.random.key(10), 8)
        st, draws, _ = eng.run(st, 300)
        post = np.asarray(draws)[:, 100:, :].reshape(-1, d)
        np.testing.assert_allclose(post.mean(0), mean, atol=0.06)


def test_api_doubling_routes_to_freerun():
    rng = np.random.default_rng(11)
    n, d = 300, 3
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    beta = np.array([1.0, 1.5, -0.5])
    y = rng.normal(X @ beta, 1.0)
    fit = mg.mcmcglm(
        X=X, y=y, family="gaussian",
        beta_prior=mg.IIDPrior(mg.Normal(0, 1), d),
        log_likelihood_extra_args={"sd": 1.0},
        slice_fn="doubling", w=0.5, engine="freerun",
        n_samples=300, burnin=80, n_chains=8, seed=0,
    )
    prec = X.T @ X + np.eye(d)
    mo = np.linalg.solve(prec, X.T @ y)
    np.testing.assert_allclose(np.asarray(fit.coef()), mo, atol=0.06)
