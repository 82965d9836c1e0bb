"""Tests for the device helpers (utils/device.py): the compile-cache
location, the accelerator check and the peak-bandwidth table."""

import os

import jax
import pytest

from mcmcglm_tpu.utils import device


@pytest.fixture
def cache_config():
    """Restore JAX's compile-cache settings after a test changes them."""
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", old[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old[1])


def test_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(checkout, ".jax_cache")
    assert device.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_cache_env_var_wins_and_sets_nothing(monkeypatch, tmp_path,
                                             cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_path_is_stable(monkeypatch, cache_config):
    """The path is part of the cache key: two calls (and two processes)
    must agree — no temporary name, pid or time in it."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert device.enable_compile_cache() == device.enable_compile_cache()


def test_peak_table_known_device():
    assert device.hbm_peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12


@pytest.mark.parametrize("kind", ["Unknown Accelerator", "cpu", "NVIDIA A100"])
def test_peak_table_raises_on_unknown_device(kind):
    with pytest.raises(ValueError, match="HBM_PEAK_BYTES_PER_S"):
        device.hbm_peak_bytes_per_s(kind)


def test_require_accelerator_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no accelerator"):
        device.require_accelerator()


@pytest.mark.gpu
def test_freerun_fit_on_gpu_recovers_conjugate_posterior():
    """The default accelerator path (freerun, spec_k=4) on the card: the
    README gaussian posterior against its closed form."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py phase 1 runs this check")
    import numpy as np

    import mcmcglm_tpu as mg

    rng = np.random.default_rng(42)
    n = 1000
    X = np.column_stack([np.ones(n), rng.normal(size=n),
                         rng.binomial(1, 0.5, size=n)])
    y = rng.normal(X @ np.array([1.0, 1.5, 2.0]), 1.0)
    fit = mg.mcmcglm(X=X, y=y, family="gaussian", n_chains=64, w=0.5)
    mu = np.linalg.solve(X.T @ X + np.eye(3), X.T @ y)
    draws = np.asarray(fit.beta)[:, fit.burnin + 1:, :]
    assert np.abs(draws.mean(axis=(0, 1)) - mu).max() < 0.02
