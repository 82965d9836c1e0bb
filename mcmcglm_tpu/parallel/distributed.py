"""Multi-host runtime helpers.

The reference's only "distribution" is socket-launched R worker processes on
one machine (R/slice_utilities.R:72-79 — no NCCL/MPI/anything).  The
equivalent here is the JAX distributed runtime: one process per host, a global
mesh spanning all hosts' devices, collectives over NVLink within a host
and the network across hosts (SURVEY.md §5 'distributed communication backend').

Usage on each host of a pod slice:

    from mcmcglm_tpu.parallel import distributed, make_mesh, ShardedCGGibbs
    distributed.initialize("host0:1234", num_processes=2, process_id=0)
    mesh = make_mesh(n_chain_shards=jax.device_count() // 2, n_obs_shards=2)
    eng = ShardedCGGibbs(..., mesh=mesh)   # same code as single-host

ShardedCGGibbs detects ``jax.process_count() > 1`` and builds its global
arrays with ``jax.make_array_from_callback`` so every host contributes only
its addressable shards.  Checkpointing via mcmcglm_tpu.checkpoint works
unchanged (orbax is multi-host aware); a restart re-runs initialize() and
restores the last step — the failure-recovery unit (SURVEY.md §5).
"""

from __future__ import annotations

from typing import Optional

import jax

__all__ = ["initialize", "is_distributed", "sync_global_devices"]

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
):
    """Initialise the JAX distributed runtime.  Pass the coordinator
    address, process count and this process's id: a plain GPU host has
    no cluster environment for JAX to detect them from.

    Must run before any JAX computation (backend initialisation pins the
    process-local runtime — which is also why this guard is a module flag
    and NOT a ``jax.process_count()`` probe: the probe itself would
    initialise the backend).  With no explicit arguments and no detectable
    cluster environment this degrades to a single-process no-op; with
    explicit arguments a failure is a real error and propagates."""
    global _initialized
    if _initialized:
        return
    explicit = coordinator_address is not None
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
        _initialized = True
    except (ValueError, RuntimeError):
        if explicit:
            raise
        # single-process environment (tests, one-chip dev) — fine.
        _initialized = True


def is_distributed() -> bool:
    return jax.process_count() > 1


def sync_global_devices(tag: str = "barrier"):
    """Cross-host barrier (e.g. before/after checkpoint writes)."""
    if is_distributed():  # pragma: no cover - multi-host only
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(tag)
