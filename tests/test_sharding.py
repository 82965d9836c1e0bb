"""Multi-device tests on the 8-virtual-CPU-device mesh (the multi-GPU
analogue of a fake cluster backend; SURVEY.md §4)."""

import jax
import numpy as np
import pytest

import mcmcglm_tpu as mg
from mcmcglm_tpu.parallel import ShardedCGGibbs, make_mesh


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    n, d = 203, 5  # deliberately not divisible by the obs axis -> padding
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    beta = rng.normal(size=d)
    y = rng.normal(X @ beta, 1.0)
    return X, y, beta


def test_devices_available():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"


class TestShardedEngine:
    @pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
    def test_mesh_shapes_run(self, problem, shape):
        X, y, _ = problem
        mesh = make_mesh(*shape)
        eng = ShardedCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), X.shape[1]),
            extra={"sd": 1.0}, tuning={"w": 0.5}, mesh=mesh,
        )
        state = eng.init(jax.random.key(0), 8)
        state, betas, nev = eng.run(state, 10)
        assert betas.shape == (8, 10, X.shape[1])
        assert np.isfinite(np.asarray(betas)).all()

    def test_sharded_matches_single_device(self, problem):
        """The sharded run must be statistically identical to single-chip:
        same posterior within MC error (bitwise equality is not expected —
        reduction orders differ across shardings)."""
        X, y, _ = problem
        d = X.shape[1]
        prior = mg.IIDPrior(mg.Normal(0, 1), d)

        eng1 = mg.CGGibbs(X, y, "gaussian", prior, extra={"sd": 1.0}, tuning={"w": 0.5})
        b1, _, _ = eng1.sample(jax.random.key(0), 300, n_chains=8)

        mesh = make_mesh(2, 4)
        eng2 = ShardedCGGibbs(
            X, y, "gaussian", prior, extra={"sd": 1.0}, tuning={"w": 0.5}, mesh=mesh
        )
        b2, _, _ = eng2.sample(jax.random.key(0), 300, n_chains=8)

        p1 = b1[:, 101:, :].reshape(-1, d)
        p2 = b2[:, 101:, :].reshape(-1, d)
        np.testing.assert_allclose(p1.mean(0), p2.mean(0), atol=0.08)
        np.testing.assert_allclose(p1.std(0), p2.std(0), rtol=0.25)

    def test_obs_padding_does_not_bias(self, problem):
        """Padding rows (obs axis not divisible) must not change the
        posterior: compare vs an exactly-divisible copy of the data."""
        X, y, _ = problem
        d = X.shape[1]
        prior = mg.IIDPrior(mg.Normal(0, 1), d)
        mesh = make_mesh(2, 4)
        # n=203 on 4 obs shards -> 1 pad row
        eng = ShardedCGGibbs(
            X, y, "gaussian", prior, extra={"sd": 1.0}, tuning={"w": 0.5}, mesh=mesh
        )
        assert eng.Xt.shape[1] == 204
        b, _, _ = eng.sample(jax.random.key(1), 300, n_chains=8)
        post = b[:, 101:, :].reshape(-1, d)

        prec = X.T @ X + np.eye(d)
        mu = np.linalg.solve(prec, X.T @ y)
        sd = np.sqrt(np.diag(np.linalg.inv(prec)))
        np.testing.assert_allclose(
            post.mean(0), mu, atol=float(5 * sd.max() / np.sqrt(100))
        )

    def test_chains_divisibility_error(self, problem):
        X, y, _ = problem
        eng = ShardedCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), X.shape[1]),
            extra={"sd": 1.0}, tuning={"w": 0.5}, mesh=make_mesh(4, 2),
        )
        with pytest.raises(ValueError, match="divisible"):
            eng.init(jax.random.key(0), 6)

    def test_binomial_sharded(self):
        rng = np.random.default_rng(3)
        n, d = 400, 4
        X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
        beta = np.array([0.3, 0.8, -0.5, 0.2])
        y = rng.binomial(1, 1 / (1 + np.exp(-X @ beta))).astype(float)
        eng = ShardedCGGibbs(
            X, y, "binomial", mg.IIDPrior(mg.Normal(0, 5), d),
            tuning={"w": 1.0}, mesh=make_mesh(2, 4),
        )
        b, _, _ = eng.sample(jax.random.key(0), 300, n_chains=8)
        post = b[:, 101:, :].reshape(-1, d)
        np.testing.assert_allclose(post.mean(0), beta, atol=0.45)


class TestShardedChainTuning:
    def test_per_chain_w_on_mesh(self, problem):
        """Per-chain tuning arrays (the batched-sweep mechanism) must work
        under the sharded engine: eval counts grow with the slice width."""
        X, y, _ = problem
        d = X.shape[1]
        eng = ShardedCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0}, mesh=make_mesh(4, 2),
            chain_tuning_names=("w",),
        )
        ws = np.repeat([0.25, 4.0], 4).astype(np.float32)
        b, nev, _ = eng.sample(
            jax.random.key(0), 100, n_chains=8, chain_tuning={"w": ws}
        )
        assert np.isfinite(b).all()
        # wider slices -> more evaluations per sweep
        assert nev[4:].mean() > nev[:4].mean()


class TestShardedFreeRun:
    """Chain-sharded free-running engine (parallel/freerun_sharded.py):
    one independent automaton per device, zero collectives."""

    def test_runs_and_recovers(self, problem):
        from mcmcglm_tpu.parallel import ShardedFreeRunCGGibbs

        X, y, _ = problem
        d = X.shape[1]
        P_ = X.T @ X + np.eye(d)
        mu = np.linalg.solve(P_, X.T @ y)
        mesh = make_mesh(8, 1)
        eng = ShardedFreeRunCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0}, tuning={"w": 0.7}, mesh=mesh,
        )
        st = eng.init(jax.random.key(0), 16)
        st, _, _ = eng.warmup(st, 60)
        st, draws, nev = eng.run(st, 300)
        draws = np.asarray(draws)
        assert draws.shape == (16, 300, d)
        post = draws[:, 60:, :].reshape(-1, d)
        assert np.abs(post.mean(0) - mu).max() < 0.05
        assert np.asarray(nev).shape == (16, 300)

    def test_shard_runs_match_standalone(self, problem):
        """Each shard's chains are bitwise what a standalone FreeRunCGGibbs
        produces from that shard's key — sharding adds nothing but
        placement."""
        from mcmcglm_tpu.freerun import FreeRunCGGibbs
        from mcmcglm_tpu.parallel import ShardedFreeRunCGGibbs

        X, y, _ = problem
        d = X.shape[1]
        pr = mg.IIDPrior(mg.Normal(0, 1), d)
        kw = dict(extra={"sd": 1.0}, tuning={"w": 0.7})
        mesh = make_mesh(8, 1)
        eng = ShardedFreeRunCGGibbs(X, y, "gaussian", pr, mesh=mesh, **kw)
        key = jax.random.key(3)
        st = eng.init(key, 16)  # 2 chains per shard
        st, draws, _ = eng.run(st, 25)
        draws = np.asarray(draws)

        single = FreeRunCGGibbs(X, y, "gaussian", pr, **kw)
        shard_keys = jax.random.split(key, 8)
        for s in [0, 3, 7]:
            st1 = single.init(shard_keys[s], 2)
            st1, d1, _ = single.run(st1, 25)
            np.testing.assert_array_equal(draws[2 * s : 2 * s + 2], np.asarray(d1))

    def test_validation(self, problem):
        from mcmcglm_tpu.parallel import ShardedFreeRunCGGibbs

        X, y, _ = problem
        pr = mg.IIDPrior(mg.Normal(0, 1), X.shape[1])
        with pytest.raises(ValueError, match="divisible"):
            eng = ShardedFreeRunCGGibbs(
                X, y, "gaussian", pr, extra={"sd": 1.0}, tuning={"w": 0.7},
                mesh=make_mesh(8, 1),
            )
            eng.init(jax.random.key(0), 12)
        with pytest.raises(ValueError, match="observation"):
            ShardedFreeRunCGGibbs(
                X, y, "gaussian", pr, extra={"sd": 1.0}, tuning={"w": 0.7},
                mesh=make_mesh(4, 2),
            )


def test_api_mesh_routing(problem):
    """mg.mcmcglm(mesh=...) routes to the sharded engines."""
    X, y, _ = problem
    d = X.shape[1]
    P_ = X.T @ X + np.eye(d)
    mu = np.linalg.solve(P_, X.T @ y)
    mesh = make_mesh(8, 1)
    fit = mg.mcmcglm(
        X=X, y=y, family="gaussian", n_samples=400, burnin=100,
        n_chains=8, seed=0, engine="auto", w=0.7, mesh=mesh,
        log_likelihood_extra_args={"sd": 1.0},
    )
    assert np.abs(np.asarray(fit.coef()) - mu).max() < 0.06
    fit2 = mg.mcmcglm(
        X=X, y=y, family="gaussian", n_samples=200, burnin=50,
        n_chains=8, seed=0, engine="xla", w=0.7, mesh=make_mesh(4, 2),
        log_likelihood_extra_args={"sd": 1.0},
    )
    assert np.abs(np.asarray(fit2.coef()) - mu).max() < 0.1
    with pytest.raises(ValueError, match="engine must be"):
        mg.mcmcglm(
            X=X, y=y, family="gaussian", n_samples=50, burnin=10,
            n_chains=8, engine="fused", w=0.7, mesh=mesh,
            log_likelihood_extra_args={"sd": 1.0},
        )


class TestShardedFreeRunThinned:
    def test_thinned_matches_standalone_bitwise(self, problem):
        """Sharded run_thinned is per-shard bitwise identical to standalone
        FreeRunCGGibbs.run_thinned with the shard's key (placement only)."""
        from mcmcglm_tpu.freerun import FreeRunCGGibbs
        from mcmcglm_tpu.parallel import ShardedFreeRunCGGibbs

        X, y, _ = problem
        d = X.shape[1]
        pr = mg.IIDPrior(mg.Normal(0, 1), d)
        kw = dict(extra={"sd": 1.0}, tuning={"w": 0.7})
        mesh = make_mesh(8, 1)
        eng = ShardedFreeRunCGGibbs(X, y, "gaussian", pr, mesh=mesh, **kw)
        key = jax.random.key(4)
        st = eng.init(key, 16)
        st, mom, kept, nev = eng.run_thinned(st, n_outer=5, thin=2)
        kept = np.asarray(kept)
        assert kept.shape == (16, 5, d)
        assert np.asarray(mom.mean).shape == (16, d)

        single = FreeRunCGGibbs(X, y, "gaussian", pr, **kw)
        shard_keys = jax.random.split(key, 8)
        for s in [0, 5]:
            st1 = single.init(shard_keys[s], 2)
            st1, mom1, kept1, _ = single.run_thinned(st1, n_outer=5, thin=2)
            np.testing.assert_array_equal(kept[2 * s : 2 * s + 2], np.asarray(kept1))
            np.testing.assert_array_equal(
                np.asarray(mom.mean)[2 * s : 2 * s + 2], np.asarray(mom1.mean)
            )

    def test_thinned_pooled_summary(self, problem):
        """pooled_summary over the chain-sharded moments gives finite pooled
        diagnostics computable without gathering draws (psum-shaped)."""
        from mcmcglm_tpu.parallel import ShardedFreeRunCGGibbs
        from mcmcglm_tpu.parallel.pooled import ChainMoments, pooled_summary

        X, y, _ = problem
        d = X.shape[1]
        P_ = X.T @ X + np.eye(d)
        mu = np.linalg.solve(P_, X.T @ y)
        eng = ShardedFreeRunCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0}, tuning={"w": 0.7}, mesh=make_mesh(8, 1),
        )
        st = eng.init(jax.random.key(5), 16)
        st, _, _ = eng.warmup(st, 80)
        mom = None
        for _ in range(2):  # chunked accumulation across dispatches
            st, mom, kept, _ = eng.run_thinned(st, n_outer=50, thin=2, moments=mom)
        summ = jax.jit(lambda m: pooled_summary(m))(
            ChainMoments(mom.count[0], mom.mean, mom.m2)
        )
        assert np.abs(np.asarray(summ["mean"]) - mu).max() < 0.05
        assert float(np.max(np.asarray(summ["rhat"]))) < 1.1

    def test_sharded_spec_battery(self, problem):
        """The K-speculative pass composes with shard_map (one independent
        free-running automaton per device) — the many-chain configuration
        with speculative batching."""
        from mcmcglm_tpu.parallel import ShardedFreeRunCGGibbs

        X, y, _ = problem
        d = X.shape[1]
        P_ = X.T @ X + np.eye(d)
        mu = np.linalg.solve(P_, X.T @ y)
        eng = ShardedFreeRunCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0}, tuning={"w": 0.7}, mesh=make_mesh(8, 1),
            spec_k=4, eval_cache="scalar",
        )
        st = eng.init(jax.random.key(3), 64)  # 8 chains per device
        st, _, _ = eng.warmup(st, 80)
        st, draws, _ = eng.run(st, 250)
        post = np.asarray(draws)[:, 80:, :].reshape(-1, d)
        assert np.abs(post.mean(0) - mu).max() < 0.05


class TestZeroCollectives:
    """Mechanical proof of the chain-scaling design claim: the sharded
    freerun RUN path compiles to an SPMD program with NO cross-device
    collectives (chains are i.i.d.; each shard's automaton is fully
    independent), so scaling efficiency is limited only by per-shard
    tails, never by communication (BASELINE: >=80% efficiency to N hosts).
    """

    _COLLECTIVES = (
        "all-reduce", "all-gather", "reduce-scatter", "collective-permute",
        "all-to-all", "collective-broadcast",
    )

    def test_freerun_all_executables_collective_free(self, problem):
        """Lower run/warmup/thinned explicitly and scan each compiled
        module: zero collective ops anywhere in the freerun path."""
        from mcmcglm_tpu.parallel import ShardedFreeRunCGGibbs

        X, y, _ = problem
        d = X.shape[1]
        mesh = make_mesh(8, 1)
        eng = ShardedFreeRunCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0}, tuning={"w": 0.5}, mesh=mesh,
        )
        st = eng.init(jax.random.key(0), 16)
        st, _, _ = eng.warmup(st, 2)  # populate caches
        st, _, _ = eng.run(st, 3)
        mom = None
        st2, mom, _, _ = eng.run_thinned(st, n_outer=2, thin=2)
        texts = {}
        for key, fn in eng._fn_cache.items():
            if key[0] == "thinned":
                texts[key] = (
                    fn.lower(st, mom, None).compile().as_text().lower()
                )
            elif key[0] == "passes":
                continue
            else:
                texts[key] = fn.lower(st).compile().as_text().lower()
        assert len(texts) >= 3
        for key, txt in texts.items():
            for op in self._COLLECTIVES:
                assert op not in txt, f"{op} found in freerun {key} HLO"

    def test_obs_sharded_engine_does_have_collectives(self, problem):
        """Positive control: the observation-sharded engine's likelihood
        reduction MUST lower to a cross-device all-reduce — proving the
        scan above would catch collectives if the freerun path had any."""
        X, y, _ = problem
        d = X.shape[1]
        mesh = make_mesh(1, 8)
        eng = ShardedCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0}, tuning={"w": 0.5}, mesh=mesh,
        )
        state = eng.init(jax.random.key(0), 4)
        eng.run(state, 2)  # populate the jit cache
        fn = eng._run_cache[(2, eng._w_adapted)]
        txt = fn.lower(state).compile().as_text().lower()
        assert any(op in txt for op in self._COLLECTIVES), (
            "expected a collective in the obs-sharded engine's HLO; "
            "the zero-collective scan may be reading the wrong artifact"
        )


def test_sharded_warmup_passes_completes(problem):
    """Pass-bounded warmup over the mesh: fixed pass blocks per dispatch,
    sweep_count carried across dispatches until every chain hits quota
    (the pod-scale warmup mode wired into scripts/baseline_configs.py)."""
    from mcmcglm_tpu.parallel import ShardedFreeRunCGGibbs

    X, y, _ = problem
    d = X.shape[1]
    eng = ShardedFreeRunCGGibbs(
        X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
        extra={"sd": 1.0}, tuning={"w": 0.5}, mesh=make_mesh(8, 1),
    )
    st = eng.init(jax.random.key(0), 16)
    sc = None
    for _ in range(1000):
        st, sc = eng.warmup_passes(st, sc, 10, 40)
        if (np.asarray(sc) >= 10).all():
            break
    else:
        raise AssertionError("sharded warmup_passes never completed")
    st, draws, _ = eng.run(st, 15)
    assert np.isfinite(np.asarray(draws)).all()
