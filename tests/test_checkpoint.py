"""Checkpoint/resume round-trip tests (SURVEY.md §5)."""

import jax
import numpy as np
import pytest

import mcmcglm_tpu as mg
from mcmcglm_tpu.checkpoint import CheckpointManager


@pytest.fixture
def engine(readme_gaussian_data):
    X, y, _ = readme_gaussian_data
    return mg.CGGibbs(
        X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), 3),
        extra={"sd": 1.0}, tuning={"w": 0.5},
    )


def test_roundtrip_resume(engine, tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    state = engine.init(jax.random.key(0), 4)
    state, betas1, _ = engine.run(state, 20)
    mgr.save(20, state, np.asarray(betas1))

    # fresh process simulation: rebuild template, restore, continue
    template = engine.init(jax.random.key(0), 4)
    step, restored, samples = mgr.restore(template)
    assert step == 20
    assert samples.shape == (4, 20, 3)
    np.testing.assert_array_equal(samples, np.asarray(betas1))

    # the restored state must continue EXACTLY like the original
    cont_a, ba, _ = engine.run(state, 5)
    cont_b, bb, _ = engine.run(restored, 5)
    np.testing.assert_allclose(np.asarray(ba), np.asarray(bb), rtol=1e-6)
    mgr.close()


def test_latest_and_retention(engine, tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    state = engine.init(jax.random.key(1), 2)
    for step in (5, 10, 15):
        mgr.save(step, state)
    assert mgr.latest_step() == 15
    template = engine.init(jax.random.key(1), 2)
    step, _, samples = mgr.restore(template)
    assert step == 15 and samples is None
    mgr.close()


def test_empty_dir(engine, tmp_path):
    mgr = CheckpointManager(str(tmp_path / "none"))
    assert mgr.restore(engine.init(jax.random.key(0), 2)) is None
    mgr.close()


class TestFailureRecoveryShardedFreerun:
    """The failure-recovery harness (SURVEY.md §5: 'checkpointed chain
    state is the recovery unit'): a run interrupted mid-way and resumed
    from the checkpoint in a FRESH engine must produce exactly the draws
    of the uninterrupted run."""

    def _problem(self):
        rng = np.random.default_rng(3)
        n, d = 160, 4
        X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
        y = rng.normal(X @ np.array([1.0, 0.5, -0.5, 0.2]), 1.0)
        return X, y, d

    def _make_engine(self):
        from mcmcglm_tpu.parallel import ShardedFreeRunCGGibbs, make_mesh

        X, y, d = self._problem()
        return ShardedFreeRunCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
            extra={"sd": 1.0}, tuning={"w": 0.7}, mesh=make_mesh(8, 1),
        )

    def test_resume_mid_run_equals_uninterrupted(self, tmp_path):
        eng = self._make_engine()
        st0 = eng.init(jax.random.key(7), 16)
        st0, _, _ = eng.warmup(st0, 10)

        # uninterrupted: 6 + 6 sweeps in two dispatches (the chunked
        # schedule the interrupted run will replicate)
        st_a = st0
        st_a, d1a, _ = eng.run(st_a, 6)
        st_a, d2a, _ = eng.run(st_a, 6)

        # interrupted: run 6, checkpoint, CRASH (drop engine + state),
        # rebuild everything fresh, restore, run the remaining 6
        st_b, d1b, _ = eng.run(st0, 6)
        mgr = CheckpointManager(str(tmp_path / "ck"))
        mgr.save(6, st_b, np.asarray(d1b))
        del eng, st_b, d1b
        mgr.close()

        eng2 = self._make_engine()  # fresh process simulation
        mgr2 = CheckpointManager(str(tmp_path / "ck"))
        template = eng2.init(jax.random.key(7), 16)
        step, st_r, drawn = mgr2.restore(template)
        assert step == 6
        np.testing.assert_array_equal(drawn, np.asarray(d1a))
        st_r2, d2b, _ = eng2.run(st_r, 6)
        np.testing.assert_array_equal(np.asarray(d2b), np.asarray(d2a))
        np.testing.assert_array_equal(
            np.asarray(st_r2.beta), np.asarray(st_a.beta)
        )
        mgr2.close()

    def test_thinned_moments_resume(self, tmp_path):
        """run_thinned resumes: moments + state checkpointed together give
        identical continued moments."""
        eng = self._make_engine()
        st = eng.init(jax.random.key(8), 8)
        st, mom, _, _ = eng.run_thinned(st, n_outer=3, thin=2)
        mgr = CheckpointManager(str(tmp_path / "ck2"))
        mgr.save(3, {"state": st, "mom": mom})
        st_a, mom_a, k_a, _ = eng.run_thinned(st, n_outer=3, thin=2, moments=mom)

        eng2 = self._make_engine()
        st_t = eng2.init(jax.random.key(8), 8)
        from mcmcglm_tpu.parallel.pooled import ChainMoments
        import jax.numpy as jnp
        mom_t = ChainMoments(
            count=jnp.zeros_like(mom.count),
            mean=jnp.zeros_like(mom.mean),
            m2=jnp.zeros_like(mom.m2),
        )
        _, restored, _ = mgr.restore({"state": st_t, "mom": mom_t})
        st_r, mom_r = restored["state"], restored["mom"]
        st_b, mom_b, k_b, _ = eng2.run_thinned(st_r, n_outer=3, thin=2, moments=mom_r)
        np.testing.assert_array_equal(np.asarray(k_a), np.asarray(k_b))
        np.testing.assert_allclose(
            np.asarray(mom_a.mean), np.asarray(mom_b.mean), rtol=1e-6
        )
        mgr.close()


class TestFreeRunBatteryCheckpoint:
    """Checkpoint round-trip with the K-speculative battery engine."""

    def _make_engine(self):
        rng = np.random.default_rng(4)
        n, d = 300, 5
        X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
        y = rng.binomial(1, 0.5, size=n).astype(np.float64)
        from mcmcglm_tpu.freerun import FreeRunCGGibbs

        return FreeRunCGGibbs(
            X, y, "binomial", mg.IIDPrior(mg.Normal(0, 1), d),
            tuning={"w": 0.5}, spec_k=4, eval_cache="scalar",
        )

    def test_resume_bitwise(self, tmp_path):
        eng = self._make_engine()
        st0 = eng.init(jax.random.key(1), 8)
        assert st0.eta.shape == (8, 300)  # plain (C, n) layout
        st0, _, _ = eng.warmup(st0, 5)
        st_a, da, _ = eng.run(st0, 4)

        mgr = CheckpointManager(str(tmp_path / "ck"))
        mgr.save(0, st0, np.zeros((1,)))
        mgr.close()
        eng2 = self._make_engine()
        mgr2 = CheckpointManager(str(tmp_path / "ck"))
        template = eng2.init(jax.random.key(1), 8)
        _, st_r, _ = mgr2.restore(template)
        st_b, db, _ = eng2.run(st_r, 4)
        np.testing.assert_array_equal(np.asarray(da), np.asarray(db))
        np.testing.assert_array_equal(
            np.asarray(st_a.eta), np.asarray(st_b.eta)
        )
        mgr2.close()


class TestCheckpointFormatVersion:
    """The payload carries a format version (checkpoint.CHECKPOINT_FORMAT):
    state fields have changed MEANING across rounds (freerun ld0 went from
    absolute to relative log density in round 3), and a silently restored
    stale semantic would bias every post-restore slice test with no error
    (ADVICE r3).  Mismatches must refuse loudly."""

    def test_roundtrip_carries_format(self, engine, tmp_path):
        import mcmcglm_tpu.checkpoint as ck

        st = engine.init(jax.random.key(0), 2)
        mgr = CheckpointManager(str(tmp_path / "fmt"))
        mgr.save(1, st)
        out = mgr.restore(st)
        assert out is not None and out[0] == 1
        assert ck.CHECKPOINT_FORMAT == 2
        mgr.close()

    def test_format_mismatch_refuses(self, engine, tmp_path, monkeypatch):
        import mcmcglm_tpu.checkpoint as ck

        st = engine.init(jax.random.key(0), 2)
        mgr = CheckpointManager(str(tmp_path / "fmt2"))
        mgr.save(1, st)
        # simulate restoring this payload in a FUTURE engine whose state
        # semantics moved on
        monkeypatch.setattr(ck, "CHECKPOINT_FORMAT", 3)
        with pytest.raises(ValueError, match="format"):
            mgr.restore(st)
        mgr.close()
