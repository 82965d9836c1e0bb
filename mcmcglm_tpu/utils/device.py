"""Device-facing helpers shared by the benchmark and the chip smoke test:
the persistent compile cache, the accelerator check, and the peak
memory-bandwidth table that roofline shares are stated against."""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = [
    "HBM_PEAK_BYTES_PER_S",
    "enable_compile_cache",
    "hbm_peak_bytes_per_s",
    "require_accelerator",
]

# Published device-memory bandwidth by ``jax.Device.device_kind``.
# Source: NVIDIA H100 Tensor Core GPU datasheet (SXM5: 3.35 TB/s;
# PCIe: 2.0 TB/s).
HBM_PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}

# the checkout this package was imported from: <checkout>/mcmcglm_tpu/utils
_CHECKOUT = Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Keep JAX's persistent compilation cache across processes.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache goes to
    ``<checkout>/.jax_cache``: a fixed path, because the path is part of
    the cache key.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(_CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def require_accelerator() -> jax.Device:
    """The first device, or RuntimeError when JAX found no accelerator:
    a measurement taken on the CPU backend is not a device number."""
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        raise RuntimeError(
            "no accelerator: JAX found only the CPU backend; this "
            "measurement runs on the GPU"
        )
    return dev


def hbm_peak_bytes_per_s(device_kind: str) -> float:
    """Published peak device-memory bandwidth of ``device_kind``;
    ValueError for a device not in :data:`HBM_PEAK_BYTES_PER_S`."""
    try:
        return HBM_PEAK_BYTES_PER_S[device_kind]
    except KeyError:
        raise ValueError(
            f"no published bandwidth for device_kind={device_kind!r}; add "
            "it to HBM_PEAK_BYTES_PER_S with its source"
        ) from None
