"""Test configuration: force a CPU backend with 8 virtual devices.

The test/CI platform is a *virtual mesh*: an 8-device CPU mesh via
--xla_force_host_platform_device_count (the analogue of a fake cluster
backend; SURVEY.md §4).  The XLA flag must be set before the backend
initialises, and jax_platforms is pinned to cpu so a machine with a GPU
runs the same tests.  Tests that need a GPU carry the ``gpu`` marker and
skip here; chip_smoke.py runs what they check on the card.

float64 is enabled so oracle tests (conjugate posteriors, scipy closed
forms) can be checked at tight tolerances; library code is explicitly
float32-first and must not rely on x64 being on.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def readme_gaussian_data():
    """The README example data: n=1000, true beta=(1, 1.5, 2), gaussian
    response with sd=1 (reference: README.md:38-55)."""
    rng = np.random.default_rng(42)
    n = 1000
    x1 = rng.normal(size=n)
    x2 = rng.binomial(1, 0.5, size=n)
    X = np.column_stack([np.ones(n), x1, x2])
    beta_true = np.array([1.0, 1.5, 2.0])
    y = rng.normal(X @ beta_true, 1.0)
    return X, y, beta_true
