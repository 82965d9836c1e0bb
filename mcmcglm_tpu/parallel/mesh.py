"""Device-mesh utilities for the sharded CGGibbs engine.

The workload's two parallel axes (SURVEY.md §2.3):

  * ``chain`` — thousands of i.i.d. chains, the data-parallel axis
    (the reference has no chain parallelism; its only parallelism is
    process-level experiment fan-out, R/slice_utilities.R:72-79);
  * ``obs`` — the observation axis n of the design matrix, the
    long-axis/"sequence-parallel" analogue: per-shard log-density sums are
    combined with an all-reduce over this axis every slice evaluation.

``make_mesh(chain, obs)`` builds a 2-D ``jax.sharding.Mesh`` over the
available devices (GPUs on hardware; virtual CPU devices under
--xla_force_host_platform_device_count in tests/dryruns).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "CHAIN_AXIS", "OBS_AXIS", "state_shardings"]

CHAIN_AXIS = "chain"
OBS_AXIS = "obs"


def make_mesh(
    n_chain_shards: Optional[int] = None,
    n_obs_shards: int = 1,
    devices=None,
) -> Mesh:
    """Build a (chain, obs) mesh.  Defaults to all devices on the chain
    axis — the right layout when chains are plentiful and n fits per-device
    memory; raise ``n_obs_shards`` for tall datasets."""
    devices = list(devices if devices is not None else jax.devices())
    total = len(devices)
    if n_chain_shards is None:
        if total % n_obs_shards:
            raise ValueError(
                f"{total} devices not divisible by n_obs_shards={n_obs_shards}"
            )
        n_chain_shards = total // n_obs_shards
    if n_chain_shards * n_obs_shards != total:
        raise ValueError(
            f"mesh {n_chain_shards}x{n_obs_shards} != {total} devices"
        )
    arr = np.asarray(devices).reshape(n_chain_shards, n_obs_shards)
    return Mesh(arr, (CHAIN_AXIS, OBS_AXIS))


def state_shardings(mesh: Mesh):
    """NamedShardings for a vmapped ChainState pytree (see engine.ChainState):
    beta/kernel_state (C, d) on chain; eta/ld_cur (C, n) on chain x obs;
    keys (C,) on chain; chain_tuning dict values (C,) on chain."""
    from ..engine import ChainState

    def s(*spec):
        return NamedSharding(mesh, P(*spec))

    return ChainState(
        beta=s(CHAIN_AXIS, None),
        eta=s(CHAIN_AXIS, OBS_AXIS),
        ld_cur=s(CHAIN_AXIS, OBS_AXIS),
        kernel_state=s(CHAIN_AXIS, None),
        key=s(CHAIN_AXIS),
        chain_tuning=s(CHAIN_AXIS),  # broadcast over dict leaves by caller
    )
