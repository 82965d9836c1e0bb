"""Latent slice kernel (Li & Walker 2020) at freerun speed: the automaton
reuses the whole battery/commit machinery — only the coordinate-begin
register construction differs (freerun._begin_coord_latent) and logw
carries the kernel's own refreshed bracket width.

Closes the reference's "all functions from qslice are available" claim
(R/mcmcglm.R:35-39) for a second kernel at full engine speed; equivalence
with the lockstep slice_latent kernel is distributional (same kernel law,
different PRNG consumption order), mirroring tests/test_freerun.py."""

import jax
import numpy as np
import pytest

import mcmcglm_tpu as mg
from mcmcglm_tpu.engine import CGGibbs, EngineConfig
from mcmcglm_tpu.freerun import FreeRunCGGibbs


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


def _fit_freerun(X, y, seed=0, warm=50, sweeps=300, **kw):
    d = X.shape[1]
    eng = FreeRunCGGibbs(
        X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
        extra={"sd": 1.0}, slice_kernel="latent",
        tuning={"rate": 0.5}, **kw,
    )
    st = eng.init(jax.random.key(seed), 8)
    st, _, _ = eng.warmup(st, warm)
    nev0 = np.asarray(st.nev).copy()
    st, draws, _ = eng.run(st, sweeps)
    nev = (np.asarray(st.nev) - nev0).mean() / sweeps
    return np.asarray(draws), nev, eng, st


class TestLatentFreeRun:
    def test_matches_conjugate_oracle(self, problem):
        X, y, mean, cov = problem
        draws, _, _, _ = _fit_freerun(X, y)
        post = draws[:, 100:, :].reshape(-1, X.shape[1])
        np.testing.assert_allclose(post.mean(0), mean, atol=0.05)
        np.testing.assert_allclose(
            post.std(0), np.sqrt(np.diag(cov)), rtol=0.15
        )

    def test_matches_lockstep_latent_in_law(self, problem):
        """Same kernel on the lockstep engine: posterior AND per-sweep
        evaluation counts must agree (the automaton replays the identical
        algorithm, free-running)."""
        X, y, mean, cov = problem
        d = X.shape[1]
        draws_fr, nev_fr, _, _ = _fit_freerun(X, y, seed=1)

        eng = CGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0},
            config=EngineConfig(slice_kernel="latent"),
            tuning={"rate": 0.5},
        )
        betas, nev_ls, _ = eng.sample(jax.random.key(1), 350, n_chains=8)
        post_ls = betas[:, 101:, :].reshape(-1, d)
        post_fr = draws_fr[:, 100:, :].reshape(-1, d)
        np.testing.assert_allclose(
            post_fr.mean(0), post_ls.mean(0), atol=0.06
        )
        np.testing.assert_allclose(
            post_fr.std(0), post_ls.std(0), rtol=0.2
        )
        nev_ls_rate = np.asarray(nev_ls).mean() / d  # per coordinate
        assert abs(nev_fr / d - nev_ls_rate) / nev_ls_rate < 0.15, (
            nev_fr / d, nev_ls_rate,
        )

    def test_spec_k_battery_matches(self, problem):
        X, y, mean, cov = problem
        draws, _, _, _ = _fit_freerun(X, y, seed=2, spec_k=4)
        post = draws[:, 100:, :].reshape(-1, X.shape[1])
        np.testing.assert_allclose(post.mean(0), mean, atol=0.05)

    def test_per_obs_cache_battery_matches(self, problem):
        """The battery with the per-observation cache under latent — the
        battery machinery is kernel-agnostic by design."""
        X, y, mean, cov = problem
        draws, _, _, _ = _fit_freerun(
            X, y, seed=3, spec_k=4, eval_cache="per_obs",
        )
        post = draws[:, 100:, :].reshape(-1, X.shape[1])
        np.testing.assert_allclose(post.mean(0), mean, atol=0.05)

    def test_binomial_logit(self):
        rng = np.random.default_rng(5)
        n, d = 400, 3
        X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
        beta = np.array([0.5, 1.0, -1.0])
        y = rng.binomial(1, 1 / (1 + np.exp(-X @ beta)))
        eng = FreeRunCGGibbs(
            X, y, "binomial", mg.IIDPrior(mg.Normal(0, 2), d),
            slice_kernel="latent", tuning={"rate": 0.5},
        )
        st = eng.init(jax.random.key(6), 8)
        st, _, _ = eng.warmup(st, 60)
        st, draws, _ = eng.run(st, 400)
        post = np.asarray(draws)[:, 100:, :].reshape(-1, d)
        np.testing.assert_allclose(post.mean(0), beta, atol=0.4)

    def test_run_passes_bitwise_matches_run(self, problem):
        X, y, _, _ = problem
        d = X.shape[1]

        def make():
            return FreeRunCGGibbs(
                X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
                extra={"sd": 1.0}, slice_kernel="latent",
                tuning={"rate": 0.5},
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

    def test_width_register_is_refreshed(self, problem):
        """logw must carry log s' per (chain, coordinate) — it changes
        every coordinate visit (unlike frozen stepping-out widths)."""
        X, y, _, _ = problem
        _, _, eng, st = _fit_freerun(X, y, seed=8, warm=5, sweeps=5)
        logw = np.asarray(st.logw)
        init = np.log(1.0 / eng.rate)
        assert (np.abs(logw - init) > 1e-6).mean() > 0.95

    def test_validation(self, problem):
        X, y, _, _ = problem
        d = X.shape[1]
        prior = mg.IIDPrior(mg.Normal(0, 1), d)
        with pytest.raises(ValueError, match="must be one of"):
            FreeRunCGGibbs(
                X, y, "gaussian", prior, slice_kernel="no_such_kernel",
                tuning={"w": 0.5},
            )
        with pytest.raises(ValueError, match="conjugate"):
            FreeRunCGGibbs(
                X, y, "gaussian", prior, slice_kernel="latent",
                coord_sampler="conjugate",
            )
        # latent needs no 'w'
        FreeRunCGGibbs(X, y, "gaussian", prior, slice_kernel="latent")


class TestLatentSharded:
    def test_chain_sharded_latent(self, problem):
        from mcmcglm_tpu.parallel import ShardedFreeRunCGGibbs, make_mesh

        X, y, mean, _ = problem
        d = X.shape[1]
        eng = ShardedFreeRunCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0}, mesh=make_mesh(8, 1),
            slice_kernel="latent", tuning={"rate": 0.5},
        )
        st = eng.init(jax.random.key(9), 8)
        st, _, _ = eng.warmup(st, 50)
        st, draws, _ = eng.run(st, 300)
        post = np.asarray(draws)[:, 100:, :].reshape(-1, d)
        np.testing.assert_allclose(post.mean(0), mean, atol=0.06)

    def test_obs_sharded_latent(self, problem):
        from mcmcglm_tpu.parallel import (
            ObsShardedFreeRunCGGibbs,
            make_mesh,
        )

        X, y, mean, _ = problem
        d = X.shape[1]
        eng = ObsShardedFreeRunCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0}, mesh=make_mesh(2, 4),
            slice_kernel="latent", tuning={"rate": 0.5},
        )
        st = eng.init(jax.random.key(10), 8)
        st, _, _ = eng.warmup(st, 50)
        st, draws, _ = eng.run(st, 300)
        post = np.asarray(draws)[:, 100:, :].reshape(-1, d)
        np.testing.assert_allclose(post.mean(0), mean, atol=0.06)


def test_api_latent_routes_to_freerun(problem=None):
    rng = np.random.default_rng(11)
    n, d = 300, 3
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    beta = np.array([1.0, 1.5, -0.5])
    y = rng.normal(X @ beta, 1.0)
    fit = mg.mcmcglm(
        X=X, y=y, family="gaussian",
        beta_prior=mg.IIDPrior(mg.Normal(0, 1), d),
        log_likelihood_extra_args={"sd": 1.0},
        slice_fn="latent", rate=0.5, engine="freerun",
        n_samples=300, burnin=80, n_chains=8, seed=0,
    )
    prec = X.T @ X + np.eye(d)
    mo = np.linalg.solve(prec, X.T @ y)
    np.testing.assert_allclose(np.asarray(fit.coef()), mo, atol=0.06)
