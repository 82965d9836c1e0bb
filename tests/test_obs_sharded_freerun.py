"""Obs-sharded free-running CGGibbs (the tall-data fast path) on the
8-virtual-device mesh: law-level equivalence with the single-device
freerun engine, conjugate-oracle recovery, bitwise determinism across
collection modes, and the collective/communication contract.

The reference's whole point is O(n) per-evaluation work on the long
observation axis (R/glm_utils.R:126-132); obs-sharding is SURVEY §2.3's
data-parallel dimension for huge n."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mcmcglm_tpu as mg
from mcmcglm_tpu.freerun import FreeRunCGGibbs
from mcmcglm_tpu.parallel import (
    ObsShardedFreeRunCGGibbs,
    ShardedFreeRunCGGibbs,
    make_mesh,
)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    n, d = 203, 5  # not divisible by any obs axis -> padding exercised
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    beta = np.array([1.0, 1.5, 2.0, -0.5, 0.3])
    y = rng.normal(X @ beta, 1.0)
    return X, y, beta


def _conjugate_posterior(X, y, sd=1.0, prior_sd=1.0):
    """Closed-form gaussian-identity posterior (the reference's
    normal-normal oracle, R/sampling.R:4-14, with the correct sqrt)."""
    d = X.shape[1]
    prec = X.T @ X / sd**2 + np.eye(d) / prior_sd**2
    cov = np.linalg.inv(prec)
    mean = cov @ (X.T @ y / sd**2)
    return mean, cov


class TestObsShardedFreeRun:
    @pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 8)])
    def test_mesh_shapes_run_and_recover(self, problem, shape):
        X, y, beta = problem
        d = X.shape[1]
        mesh = make_mesh(*shape)
        eng = ObsShardedFreeRunCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0}, tuning={"w": 0.5}, mesh=mesh,
        )
        state = eng.init(jax.random.key(0), 8)
        state, _, _ = eng.warmup(state, 60)
        state, draws, nev = eng.run(state, 300)
        draws = np.asarray(draws)
        assert draws.shape == (8, 300, d)
        assert np.isfinite(draws).all()
        mean_oracle, cov_oracle = _conjugate_posterior(X, y)
        post = draws[:, 100:, :].reshape(-1, d)
        np.testing.assert_allclose(post.mean(0), mean_oracle, atol=0.06)
        np.testing.assert_allclose(
            post.std(0), np.sqrt(np.diag(cov_oracle)), rtol=0.25
        )

    def test_obs1_mesh_bitwise_matches_chain_sharded(self, problem):
        """With a singleton obs axis the psum is an identity and the
        masked reduction multiplies by exact 1.0 — the obs-sharded class
        must reproduce the chain-sharded engine BITWISE."""
        X, y, _ = problem
        d = X.shape[1]
        prior = mg.IIDPrior(mg.Normal(0, 1), d)
        kw = dict(extra={"sd": 1.0}, tuning={"w": 0.5})

        e1 = ShardedFreeRunCGGibbs(
            X, y, "gaussian", prior, mesh=make_mesh(8, 1), **kw
        )
        s1 = e1.init(jax.random.key(7), 8)
        s1, d1, n1 = e1.run(s1, 40)

        e2 = ObsShardedFreeRunCGGibbs(
            X, y, "gaussian", prior, mesh=make_mesh(8, 1), **kw
        )
        s2 = e2.init(jax.random.key(7), 8)
        s2, d2, n2 = e2.run(s2, 40)

        np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
        np.testing.assert_array_equal(np.asarray(n1), np.asarray(n2))
        np.testing.assert_array_equal(np.asarray(s1.beta), np.asarray(s2.beta))

    def test_matches_single_device_in_law(self, problem):
        """Posterior law matches the single-device freerun engine within
        MC error (bitwise equality is impossible: the psum'd partial sums
        reduce in a different order)."""
        X, y, _ = problem
        d = X.shape[1]
        prior = mg.IIDPrior(mg.Normal(0, 1), d)
        kw = dict(extra={"sd": 1.0}, tuning={"w": 0.5})

        e1 = FreeRunCGGibbs(X, y, "gaussian", prior, **kw)
        s1 = e1.init(jax.random.key(1), 8)
        s1, _, _ = e1.warmup(s1, 60)
        s1, d1, _ = e1.run(s1, 300)

        e2 = ObsShardedFreeRunCGGibbs(
            X, y, "gaussian", prior, mesh=make_mesh(2, 4), **kw
        )
        s2 = e2.init(jax.random.key(1), 8)
        s2, _, _ = e2.warmup(s2, 60)
        s2, d2, _ = e2.run(s2, 300)

        p1 = np.asarray(d1)[:, 100:, :].reshape(-1, d)
        p2 = np.asarray(d2)[:, 100:, :].reshape(-1, d)
        np.testing.assert_allclose(p1.mean(0), p2.mean(0), atol=0.08)
        np.testing.assert_allclose(p1.std(0), p2.std(0), rtol=0.25)

    def test_eval_counts_match_single_device_in_law(self, problem):
        """The automaton schedule (evaluations per sweep) must be the
        single-device engine's — obs-sharding changes the reduction
        order, not the algorithm."""
        X, y, _ = problem
        d = X.shape[1]
        prior = mg.IIDPrior(mg.Normal(0, 1), d)
        kw = dict(extra={"sd": 1.0}, tuning={"w": 0.5})

        e1 = FreeRunCGGibbs(X, y, "gaussian", prior, **kw)
        s1 = e1.init(jax.random.key(3), 16)
        s1, _, _ = e1.warmup(s1, 50)
        nev0 = np.asarray(s1.nev).copy()
        s1, _, _ = e1.run(s1, 200)
        r1 = (np.asarray(s1.nev) - nev0).mean() / 200

        e2 = ObsShardedFreeRunCGGibbs(
            X, y, "gaussian", prior, mesh=make_mesh(2, 4), **kw
        )
        s2 = e2.init(jax.random.key(3), 16)
        s2, _, _ = e2.warmup(s2, 50)
        nev0 = np.asarray(s2.nev).copy()
        s2, _, _ = e2.run(s2, 200)
        r2 = (np.asarray(s2.nev) - nev0).mean() / 200

        assert abs(r1 - r2) / r1 < 0.1, (r1, r2)

    def test_spec_k_battery(self, problem):
        """The K-speculative XLA battery under obs sharding: same law."""
        X, y, _ = problem
        d = X.shape[1]
        eng = ObsShardedFreeRunCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0}, tuning={"w": 0.5}, mesh=make_mesh(2, 4),
            spec_k=4,
        )
        state = eng.init(jax.random.key(2), 8)
        state, _, _ = eng.warmup(state, 60)
        state, draws, _ = eng.run(state, 300)
        mean_oracle, _ = _conjugate_posterior(X, y)
        post = np.asarray(draws)[:, 100:, :].reshape(-1, d)
        np.testing.assert_allclose(post.mean(0), mean_oracle, atol=0.06)

    def test_per_obs_eval_cache(self, problem):
        X, y, _ = problem
        d = X.shape[1]
        eng = ObsShardedFreeRunCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0}, tuning={"w": 0.5}, mesh=make_mesh(2, 4),
            eval_cache="per_obs",
        )
        state = eng.init(jax.random.key(4), 8)
        state, _, _ = eng.warmup(state, 60)
        state, draws, _ = eng.run(state, 300)
        mean_oracle, _ = _conjugate_posterior(X, y)
        post = np.asarray(draws)[:, 100:, :].reshape(-1, d)
        np.testing.assert_allclose(post.mean(0), mean_oracle, atol=0.06)

    def test_conjugate_coord_sampler(self, problem):
        """Exact gaussian-identity coordinate draws through the psum'd
        cross products (ops/freerun_conjugate.py under obs sharding)."""
        X, y, _ = problem
        d = X.shape[1]
        eng = ObsShardedFreeRunCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0}, mesh=make_mesh(2, 4),
            coord_sampler="conjugate", battery_impl="xla",
        )
        state = eng.init(jax.random.key(5), 8)
        state, draws, _ = eng.run(state, 400)
        mean_oracle, cov_oracle = _conjugate_posterior(X, y)
        post = np.asarray(draws)[:, 100:, :].reshape(-1, d)
        np.testing.assert_allclose(post.mean(0), mean_oracle, atol=0.05)
        np.testing.assert_allclose(
            post.std(0), np.sqrt(np.diag(cov_oracle)), rtol=0.2
        )

    def test_binomial_logit(self):
        rng = np.random.default_rng(5)
        n, d = 301, 4
        X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
        beta = np.array([0.5, 1.0, -1.0, 0.3])
        y = rng.binomial(1, 1 / (1 + np.exp(-X @ beta)))
        eng = ObsShardedFreeRunCGGibbs(
            X, y, "binomial", mg.IIDPrior(mg.Normal(0, 2), d),
            tuning={"w": 1.0}, mesh=make_mesh(2, 4),
        )
        state = eng.init(jax.random.key(6), 8)
        state, _, _ = eng.warmup(state, 80)
        state, draws, _ = eng.run(state, 400)
        post = np.asarray(draws)[:, 100:, :].reshape(-1, d)
        assert np.isfinite(post).all()
        np.testing.assert_allclose(post.mean(0), beta, atol=0.45)

    def test_obs_weights(self, problem):
        """Doubling every observation's weight equals doubling the data:
        check against the weighted conjugate oracle."""
        X, y, _ = problem
        d = X.shape[1]
        w = np.full(X.shape[0], 2.0)
        eng = ObsShardedFreeRunCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0}, tuning={"w": 0.5}, mesh=make_mesh(2, 4),
            obs_weights=w,
        )
        state = eng.init(jax.random.key(8), 8)
        state, _, _ = eng.warmup(state, 60)
        state, draws, _ = eng.run(state, 300)
        X2 = np.concatenate([X, X])
        y2 = np.concatenate([y, y])
        mean_oracle, _ = _conjugate_posterior(X2, y2)
        post = np.asarray(draws)[:, 100:, :].reshape(-1, d)
        np.testing.assert_allclose(post.mean(0), mean_oracle, atol=0.06)


class TestObsShardedCollectionModes:
    def test_run_passes_bitwise_matches_run(self, problem):
        """run_passes chunked dispatch is the same program: bitwise."""
        X, y, _ = problem
        d = X.shape[1]
        prior = mg.IIDPrior(mg.Normal(0, 1), d)
        kw = dict(extra={"sd": 1.0}, tuning={"w": 0.5})
        mesh = make_mesh(2, 4)

        def make():
            return ObsShardedFreeRunCGGibbs(
                X, y, "gaussian", prior, mesh=mesh, **kw
            )

        e1 = make()
        s1 = e1.init(jax.random.key(9), 8)
        s1, d1, n1 = e1.run(s1, 30)

        e2 = make()
        s2 = e2.init(jax.random.key(9), 8)
        sc = dr = nb = None
        while True:
            s2, sc, dr, nb = e2.run_passes(s2, sc, dr, nb, 30, 37)
            if (np.asarray(sc) >= 30).all():
                break
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(dr))
        np.testing.assert_array_equal(np.asarray(n1), np.asarray(nb))
        np.testing.assert_array_equal(np.asarray(s1.beta), np.asarray(s2.beta))

    def test_warmup_passes_bitwise_matches_warmup(self, problem):
        X, y, _ = problem
        d = X.shape[1]
        prior = mg.IIDPrior(mg.Normal(0, 1), d)
        kw = dict(extra={"sd": 1.0}, tuning={"w": 0.5})
        mesh = make_mesh(2, 4)

        e1 = ObsShardedFreeRunCGGibbs(X, y, "gaussian", prior, mesh=mesh, **kw)
        s1 = e1.init(jax.random.key(10), 8)
        s1, _, _ = e1.warmup(s1, 20)

        e2 = ObsShardedFreeRunCGGibbs(X, y, "gaussian", prior, mesh=mesh, **kw)
        s2 = e2.init(jax.random.key(10), 8)
        sc = None
        while True:
            s2, sc = e2.warmup_passes(s2, sc, 20, 41)
            if (np.asarray(sc) >= 20).all():
                break
        np.testing.assert_array_equal(np.asarray(s1.beta), np.asarray(s2.beta))
        np.testing.assert_array_equal(np.asarray(s1.logw), np.asarray(s2.logw))

    def test_run_thinned_and_pooled_summary(self, problem):
        X, y, _ = problem
        d = X.shape[1]
        from mcmcglm_tpu.parallel.pooled import pooled_summary

        eng = ObsShardedFreeRunCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0}, tuning={"w": 0.5}, mesh=make_mesh(2, 4),
        )
        state = eng.init(jax.random.key(11), 8)
        state, _, _ = eng.warmup(state, 60)
        state, moments, kept, nev = eng.run_thinned(state, 60, 5)
        assert np.asarray(kept).shape == (8, 60, d)
        summ = pooled_summary(moments)
        mean_oracle, _ = _conjugate_posterior(X, y)
        np.testing.assert_allclose(
            np.asarray(summ["mean"]), mean_oracle, atol=0.08
        )
        assert float(np.asarray(summ["rhat"]).max()) < 1.25  # short run


class TestObsShardedContract:
    def test_psum_present_in_compiled_pass(self, problem):
        """The communication contract: the compiled run executable must
        contain all-reduces (the per-pass partial-log-lik psum) — unlike
        the chain-sharded engine, which asserts ZERO collectives."""
        X, y, _ = problem
        d = X.shape[1]
        eng = ObsShardedFreeRunCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0}, tuning={"w": 0.5}, mesh=make_mesh(2, 4),
        )
        state = eng.init(jax.random.key(12), 8)
        state, _, _ = eng.run(state, 2)
        fns = list(eng._fn_cache.values())
        assert fns, "run() must populate the executable cache"
        # robust across jax versions: grab compiled text via lower/compile
        texts = []
        for f in fns:
            try:
                texts.append(
                    f.lower(state, eng._Xt_g, eng._y_g, eng._mask_g)
                    .compile().as_text()
                )
            except Exception:
                pass
        text = "\n".join(texts)
        assert "all-reduce" in text or "collective" in text, (
            "expected an obs-axis all-reduce in the compiled pass"
        )

    def test_validation(self, problem):
        X, y, _ = problem
        d = X.shape[1]
        prior = mg.IIDPrior(mg.Normal(0, 1), d)
        mesh = make_mesh(2, 4)
        with pytest.raises(ValueError, match="Pallas"):
            ObsShardedFreeRunCGGibbs(
                X, y, "gaussian", prior, mesh=mesh, tuning={"w": 0.5},
                battery_impl="triton",
            )
        with pytest.raises(ValueError, match="reduce_fn"):
            ObsShardedFreeRunCGGibbs(
                X, y, "gaussian", prior, mesh=mesh, tuning={"w": 0.5},
                reduce_fn=lambda t: jnp.sum(t, -1),
            )
        with pytest.raises(ValueError, match="obs_weights length"):
            ObsShardedFreeRunCGGibbs(
                X, y, "gaussian", prior, mesh=mesh, tuning={"w": 0.5},
                obs_weights=np.ones(3),
            )
        with pytest.raises(ValueError, match="scalar extra"):
            ObsShardedFreeRunCGGibbs(
                X, y, "gaussian", prior, mesh=mesh, tuning={"w": 0.5},
                extra={"sd": np.ones(X.shape[0])},
            )
        with pytest.raises(ValueError, match="divisible"):
            eng = ObsShardedFreeRunCGGibbs(
                X, y, "gaussian", prior, mesh=mesh, tuning={"w": 0.5},
            )
            eng.init(jax.random.key(0), 7)

    def test_api_routes_obs_mesh_to_obs_sharded(self, problem):
        """mcmcglm(mesh=(chain x obs)) with the freerun engine must fit
        through the obs-sharded class and recover the posterior."""
        X, y, _ = problem
        mesh = make_mesh(2, 4)
        fit = mg.mcmcglm(
            X=X, y=y, family="gaussian",
            beta_prior=mg.IIDPrior(mg.Normal(0, 1), X.shape[1]),
            log_likelihood_extra_args={"sd": 1.0}, w=0.5,
            n_samples=250, burnin=60, n_chains=8, mesh=mesh,
            engine="freerun", seed=0,
        )
        mean_oracle, _ = _conjugate_posterior(X, y)
        np.testing.assert_allclose(
            np.asarray(fit.coef()), mean_oracle, atol=0.08
        )
