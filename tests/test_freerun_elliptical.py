"""Elliptical + generalized-elliptical slice kernels at freerun speed:
the automaton carries the angle in the xprop register, the auxiliary
point nu in w, pivots the shrink at theta = 0 and maps proposals through
the ellipse before the kernel-agnostic fused evaluation
(freerun._begin_coord_elliptical; reference behavioral spec:
qslice::slice_elliptical as used at R/mcmcglm.R:142-144 and
qslice::slice_genelliptical at vignettes/pospkd.Rmd:325-335).
Equivalence with the lockstep kernels is distributional (same law,
different PRNG consumption), mirroring tests/test_freerun_latent.py."""

import jax
import numpy as np
import pytest

import mcmcglm_tpu as mg
from mcmcglm_tpu.engine import CGGibbs, EngineConfig
from mcmcglm_tpu.freerun import FreeRunCGGibbs

ELL_TUNING = {"mu": 0.0, "sigma": 2.0}
GEN_TUNING = {"mu": 0.0, "sigma": 2.0, "df": 5.0}


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


def _fit(X, y, kernel, tuning, seed=0, warm=50, sweeps=300, **kw):
    d = X.shape[1]
    eng = FreeRunCGGibbs(
        X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
        extra={"sd": 1.0}, slice_kernel=kernel, tuning=tuning, **kw,
    )
    st = eng.init(jax.random.key(seed), 8)
    st, _, _ = eng.warmup(st, warm)
    nev0 = np.asarray(st.nev).copy()
    st, draws, _ = eng.run(st, sweeps)
    nev = (np.asarray(st.nev) - nev0).mean() / sweeps
    return np.asarray(draws), nev, eng, st


class TestEllipticalFreeRun:
    @pytest.mark.parametrize("kernel,tuning", [
        ("elliptical", ELL_TUNING), ("genelliptical", GEN_TUNING),
    ])
    def test_matches_conjugate_oracle(self, problem, kernel, tuning):
        X, y, mean, cov = problem
        draws, _, _, _ = _fit(X, y, kernel, tuning)
        post = draws[:, 100:, :].reshape(-1, X.shape[1])
        np.testing.assert_allclose(post.mean(0), mean, atol=0.05)
        np.testing.assert_allclose(
            post.std(0), np.sqrt(np.diag(cov)), rtol=0.15
        )

    def test_matches_lockstep_elliptical_in_law(self, problem):
        """Same kernel on the lockstep engine: posterior AND per-sweep
        evaluation counts agree."""
        X, y, _, _ = problem
        d = X.shape[1]
        draws_fr, nev_fr, _, _ = _fit(X, y, "elliptical", ELL_TUNING,
                                      seed=1)
        eng = CGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0},
            config=EngineConfig(slice_kernel="elliptical"),
            tuning=ELL_TUNING,
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
        nev_ls_rate = np.asarray(nev_ls).mean() / d
        assert abs(nev_fr / d - nev_ls_rate) / nev_ls_rate < 0.15, (
            nev_fr / d, nev_ls_rate,
        )

    def test_spec_k_and_scalar_cache_battery(self, problem):
        X, y, mean, _ = problem
        for kw in (dict(spec_k=4),
                   dict(spec_k=4,
                        eval_cache="scalar")):
            draws, _, _, _ = _fit(X, y, "elliptical", ELL_TUNING, seed=2,
                                  **kw)
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
            slice_kernel="elliptical", tuning=ELL_TUNING,
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
                extra={"sd": 1.0}, slice_kernel="genelliptical",
                tuning=GEN_TUNING,
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

    def test_sharded_and_obs_sharded(self, problem):
        from mcmcglm_tpu.parallel import (
            ObsShardedFreeRunCGGibbs,
            ShardedFreeRunCGGibbs,
            make_mesh,
        )

        X, y, mean, _ = problem
        d = X.shape[1]
        for cls, mesh in ((ShardedFreeRunCGGibbs, make_mesh(8, 1)),
                          (ObsShardedFreeRunCGGibbs, make_mesh(2, 4))):
            eng = cls(
                X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
                extra={"sd": 1.0}, mesh=mesh,
                slice_kernel="elliptical", tuning=ELL_TUNING,
            )
            st = eng.init(jax.random.key(9), 8)
            st, _, _ = eng.warmup(st, 50)
            st, draws, _ = eng.run(st, 300)
            post = np.asarray(draws)[:, 100:, :].reshape(-1, d)
            np.testing.assert_allclose(post.mean(0), mean, atol=0.06)

    def test_validation(self, problem):
        X, y, _, _ = problem
        d = X.shape[1]
        prior = mg.IIDPrior(mg.Normal(0, 1), d)
        with pytest.raises(ValueError, match="sigma"):
            FreeRunCGGibbs(X, y, "gaussian", prior,
                           slice_kernel="elliptical")
        with pytest.raises(ValueError, match="df"):
            FreeRunCGGibbs(X, y, "gaussian", prior,
                           slice_kernel="genelliptical",
                           tuning={"sigma": 1.0})
        with pytest.raises(ValueError, match="conjugate"):
            FreeRunCGGibbs(X, y, "gaussian", prior,
                           slice_kernel="elliptical",
                           tuning=ELL_TUNING,
                           coord_sampler="conjugate")


def test_api_elliptical_routes_to_freerun():
    rng = np.random.default_rng(11)
    n, d = 300, 3
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    beta = np.array([1.0, 1.5, -0.5])
    y = rng.normal(X @ beta, 1.0)
    fit = mg.mcmcglm(
        X=X, y=y, family="gaussian",
        beta_prior=mg.IIDPrior(mg.Normal(0, 1), d),
        log_likelihood_extra_args={"sd": 1.0},
        slice_fn="elliptical", mu=0.0, sigma=2.0, engine="freerun",
        n_samples=300, burnin=80, n_chains=8, seed=0,
    )
    prec = X.T @ X + np.eye(d)
    mo = np.linalg.solve(prec, X.T @ y)
    np.testing.assert_allclose(np.asarray(fit.coef()), mo, atol=0.06)


class TestQuantileFreeRun:
    """Quantile slice kernel (Heiner/Johnson/Waller 2024 — qslice's own
    method) at freerun speed: unit-interval shrinkage with pivot u0 in
    the w register, ppf transform, pseudo-density correction in f."""

    @pytest.mark.parametrize("tuning", [
        {"pseudo_family": "cauchy", "pseudo_scale": 1.0},
        {"pseudo_family": "normal", "pseudo_scale": 2.0},
    ])
    def test_matches_conjugate_oracle(self, problem, tuning):
        X, y, mean, cov = problem
        draws, _, _, _ = _fit(X, y, "quantile", tuning)
        post = draws[:, 100:, :].reshape(-1, X.shape[1])
        np.testing.assert_allclose(post.mean(0), mean, atol=0.05)
        np.testing.assert_allclose(
            post.std(0), np.sqrt(np.diag(cov)), rtol=0.15
        )

    def test_matches_lockstep_quantile_in_law(self, problem):
        X, y, _, _ = problem
        d = X.shape[1]
        tun = {"pseudo_family": "cauchy", "pseudo_scale": 1.0}
        draws_fr, nev_fr, _, _ = _fit(X, y, "quantile", tun, seed=1)
        eng = CGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0},
            config=EngineConfig(slice_kernel="quantile"), tuning=tun,
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
        nev_ls_rate = np.asarray(nev_ls).mean() / d
        assert abs(nev_fr / d - nev_ls_rate) / nev_ls_rate < 0.15, (
            nev_fr / d, nev_ls_rate,
        )

    def test_spec_k_and_scalar_cache_battery(self, problem):
        X, y, mean, _ = problem
        tun = {"pseudo_family": "cauchy", "pseudo_scale": 1.0}
        for kw in (dict(spec_k=4),
                   dict(spec_k=4,
                        eval_cache="scalar")):
            draws, _, _, _ = _fit(X, y, "quantile", tun, seed=2, **kw)
            post = draws[:, 100:, :].reshape(-1, X.shape[1])
            np.testing.assert_allclose(post.mean(0), mean, atol=0.05)

    def test_run_passes_bitwise_and_validation(self, problem):
        X, y, _, _ = problem
        d = X.shape[1]
        tun = {"pseudo_family": "normal", "pseudo_scale": 1.5}

        def make():
            return FreeRunCGGibbs(
                X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
                extra={"sd": 1.0}, slice_kernel="quantile", tuning=tun,
            )

        e1 = make()
        s1 = e1.init(jax.random.key(7), 8)
        s1, d1, _ = e1.run(s1, 25)
        e2 = make()
        s2 = e2.init(jax.random.key(7), 8)
        sc = dr = nb = None
        while True:
            s2, sc, dr, nb = e2.run_passes(s2, sc, dr, nb, 25, 33)
            if (np.asarray(sc) >= 25).all():
                break
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(dr))
        with pytest.raises(ValueError, match="pseudo_family"):
            FreeRunCGGibbs(
                X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
                slice_kernel="quantile",
                tuning={"pseudo_family": "laplace"},
            )

    def test_sharded_quantile(self, problem):
        from mcmcglm_tpu.parallel import (
            ObsShardedFreeRunCGGibbs,
            make_mesh,
        )

        X, y, mean, _ = problem
        d = X.shape[1]
        eng = ObsShardedFreeRunCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0}, mesh=make_mesh(2, 4),
            slice_kernel="quantile",
            tuning={"pseudo_family": "cauchy"},
        )
        st = eng.init(jax.random.key(9), 8)
        st, _, _ = eng.warmup(st, 50)
        st, draws, _ = eng.run(st, 300)
        post = np.asarray(draws)[:, 100:, :].reshape(-1, d)
        np.testing.assert_allclose(post.mean(0), mean, atol=0.06)


class TestAdaptedQuantile:
    """pseudo_adapt=True: per-(chain, coordinate) pseudo-target loc/scale
    tuned during warmup (Robbins-Monro, like the stepping-out widths) and
    FROZEN for sampling — the sound adaptation of Heiner et al. 2024.
    Any fixed pseudo-target is an exact kernel, so the collected law must
    match the oracle; the adaptation's whole point is fewer evaluations
    per coordinate when conditionals are narrow or sit away from the
    global pseudo-target's center."""

    TUN = {"pseudo_scale": 2.0, "pseudo_adapt": True, "pseudo_c": 5.0}

    def test_matches_oracle_freezes_and_beats_global_evals(self, problem):
        X, y, mean, cov = problem
        d = X.shape[1]
        draws, nev_a, eng, st = _fit(X, y, "quantile", self.TUN, spec_k=4)
        post = draws[:, 100:, :].reshape(-1, d)
        np.testing.assert_allclose(post.mean(0), mean, atol=0.05)
        np.testing.assert_allclose(
            post.std(0), np.sqrt(np.diag(cov)), rtol=0.15
        )
        # frozen: a sampling run must not move the pseudo-target buffers
        st2, _, _ = eng.run(st, 5)
        np.testing.assert_array_equal(np.asarray(st2.qloc),
                                      np.asarray(st.qloc))
        np.testing.assert_array_equal(np.asarray(st2.logw),
                                      np.asarray(st.logw))
        # the adapted locs track the conditional centers
        np.testing.assert_allclose(
            np.asarray(st.qloc).mean(0), mean, atol=0.15
        )
        # mechanism: fewer evaluations than the fixed global pseudo-target
        # on this problem (narrow conditionals away from loc 0)
        _, nev_g, _, _ = _fit(X, y, "quantile", {"pseudo_scale": 2.0},
                              spec_k=4)
        assert nev_a < 0.8 * nev_g, (nev_a, nev_g)

    def test_run_passes_bitwise(self, problem):
        """QuantileState rides through the pass-bounded driver bitwise."""
        X, y, _, _ = problem
        d = X.shape[1]

        def make():
            return FreeRunCGGibbs(
                X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
                extra={"sd": 1.0}, slice_kernel="quantile",
                tuning=self.TUN,
            )

        e1 = make()
        s1 = e1.init(jax.random.key(7), 8)
        s1, d1, _ = e1.run(s1, 25)
        e2 = make()
        s2 = e2.init(jax.random.key(7), 8)
        sc = dr = nb = None
        while True:
            s2, sc, dr, nb = e2.run_passes(s2, sc, dr, nb, 25, 33)
            if (np.asarray(sc) >= 25).all():
                break
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(dr))

    def test_sharded_adapted(self, problem):
        from mcmcglm_tpu.parallel import (
            ObsShardedFreeRunCGGibbs,
            ShardedFreeRunCGGibbs,
            make_mesh,
        )

        X, y, mean, _ = problem
        d = X.shape[1]
        for cls, mesh in ((ShardedFreeRunCGGibbs, make_mesh(8, 1)),
                          (ObsShardedFreeRunCGGibbs, make_mesh(2, 4))):
            eng = cls(
                X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
                extra={"sd": 1.0}, mesh=mesh,
                slice_kernel="quantile", tuning=self.TUN,
            )
            st = eng.init(jax.random.key(9), 8)
            st, _, _ = eng.warmup(st, 50)
            st, draws, _ = eng.run(st, 300)
            post = np.asarray(draws)[:, 100:, :].reshape(-1, d)
            np.testing.assert_allclose(post.mean(0), mean, atol=0.06)

    def test_validation(self, problem):
        X, y, _, _ = problem
        d = X.shape[1]
        with pytest.raises(ValueError, match="pseudo_adapt"):
            FreeRunCGGibbs(
                X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
                slice_kernel="stepping_out",
                tuning={"w": 0.5, "pseudo_adapt": True},
            )


def test_api_quantile_routes_to_freerun():
    rng = np.random.default_rng(12)
    n, d = 300, 3
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    beta = np.array([1.0, 1.5, -0.5])
    y = rng.normal(X @ beta, 1.0)
    fit = mg.mcmcglm(
        X=X, y=y, family="gaussian",
        beta_prior=mg.IIDPrior(mg.Normal(0, 1), d),
        log_likelihood_extra_args={"sd": 1.0},
        slice_fn="quantile", pseudo_family="cauchy", engine="freerun",
        n_samples=300, burnin=80, n_chains=8, seed=0,
    )
    prec = X.T @ X + np.eye(d)
    mo = np.linalg.solve(prec, X.T @ y)
    np.testing.assert_allclose(np.asarray(fit.coef()), mo, atol=0.06)
