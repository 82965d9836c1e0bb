"""Multi-chip CGGibbs: the engine over a (chain, obs) device mesh.

Design (the "pick a mesh, annotate shardings, let XLA insert collectives"
recipe): we reuse the single-chip engine's traced computation unchanged and
*place* its operands —

  * X^T (d, n)   -> P(None, obs)      every chip holds its observation slab
  * y (n,)       -> P(obs)
  * eta, ld_cur (C, n) -> P(chain, obs)
  * beta, kernel_state (C, d) -> P(chain, None)
  * PRNG keys, per-chain tuning (C,) -> P(chain)

GSPMD then partitions the whole scan/while program: each slice evaluation's
observation-axis reduction becomes a shard-local sum + all-reduce (psum)
over the ``obs`` mesh axis riding the interconnect, the incremental eta update stays
entirely shard-local (each chip updates its own eta slab with its own
X[:, j] slab — no communication), and the chain axis never communicates
until diagnostics pool moments.

This mirrors how the reference's parallelism COULD NOT scale: R futures
serialize the whole problem to worker processes (R/slice_utilities.R:72-79);
here the model state is partitioned once and only O(1) scalars cross chips
per slice evaluation.

Multi-host: under ``jax.distributed.initialize`` the same code runs with a
global mesh; construct the engine on every host with identical arguments
(device_put of host-replicated numpy arrays with a NamedSharding produces
the right global array in a single-controller-per-host setup via
``jax.make_array_from_callback`` — wrapped below).
"""

from __future__ import annotations

from typing import Mapping, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine import CGGibbs, ChainState, EngineConfig
from .mesh import CHAIN_AXIS, OBS_AXIS, make_mesh

__all__ = ["ShardedCGGibbs"]


def _put(arr, mesh, spec):
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() > 1:  # pragma: no cover - multi-host path
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: np.asarray(arr)[idx]
        )
    return jax.device_put(arr, sharding)


class ShardedCGGibbs(CGGibbs):
    """CGGibbs with state and data sharded over a (chain, obs) mesh.

    Drop-in extension of :class:`~mcmcglm_tpu.engine.CGGibbs`: same
    ``init`` / ``run`` / ``sample`` surface; ``n_chains`` must be divisible
    by the mesh's chain-axis size, and the observation count is padded up to
    a multiple of the obs-axis size (padding rows carry zero weight in X and
    a masked-out log density).
    """

    def __init__(
        self,
        X,
        y,
        family,
        prior,
        extra: Optional[Mapping] = None,
        config: EngineConfig = EngineConfig(),
        tuning: Optional[Mapping] = None,
        mesh: Optional[Mesh] = None,
        chain_tuning_names: tuple = (),
        offset=None,
    ):
        self.mesh = mesh if mesh is not None else make_mesh()
        n_obs_shards = self.mesh.shape[OBS_AXIS]
        X = np.asarray(X)
        y = np.asarray(y).reshape(-1)
        n = X.shape[0]
        pad = (-n) % n_obs_shards
        self._n_real = n
        if pad:
            # Zero rows of X contribute eta=0 -> constant log density; we
            # mask them out of the reduction with a per-row weight vector.
            X = np.concatenate([X, np.zeros((pad, X.shape[1]), X.dtype)], axis=0)
            y = np.concatenate([y, np.zeros(pad, y.dtype)])
        if offset is not None:
            offset = np.asarray(offset).reshape(-1)
            if offset.shape[0] != n:
                raise ValueError(
                    f"offset length {offset.shape[0]} != n observations {n}"
                )
            offset = np.concatenate([offset, np.zeros(pad, offset.dtype)])
        self._obs_weight_np = np.concatenate(
            [np.ones(n, np.float32), np.zeros(pad, np.float32)]
        )

        super().__init__(
            X,
            y,
            family,
            prior,
            extra=extra,
            config=config,
            tuning=tuning,
            reduce_fn=self._masked_reduce,
            chain_tuning_names=chain_tuning_names,
            offset=offset,
        )

        # Commit data to the mesh: X^T slabbed over obs, y over obs.
        self.Xt = _put(self.Xt, self.mesh, P(None, OBS_AXIS))
        self.y = _put(self.y, self.mesh, P(OBS_AXIS))
        if self.offset is not None:
            self.offset = _put(self.offset, self.mesh, P(OBS_AXIS))
        self._obs_weight = _put(
            jnp.asarray(self._obs_weight_np, config.dtype), self.mesh, P(OBS_AXIS)
        )

    def _masked_reduce(self, t):
        """Observation-axis reduction ignoring padding rows.  Under GSPMD
        the sum over the sharded axis lowers to a shard-local reduction +
        all-reduce over the obs mesh axis."""
        return jnp.sum(t * self._obs_weight, axis=-1)

    # -- sharded state -----------------------------------------------------

    def _state_sharding(self, chain_tuning_keys=()):
        def s(*spec):
            return NamedSharding(self.mesh, P(*spec))

        return ChainState(
            beta=s(CHAIN_AXIS, None),
            eta=s(CHAIN_AXIS, OBS_AXIS),
            ld_cur=s(CHAIN_AXIS, OBS_AXIS),
            kernel_state=s(CHAIN_AXIS, None),
            key=s(CHAIN_AXIS),
            chain_tuning={k: s(CHAIN_AXIS) for k in chain_tuning_keys},
        )

    def init(self, key, n_chains: int, chain_tuning: Optional[Mapping] = None) -> ChainState:
        n_chain_shards = self.mesh.shape[CHAIN_AXIS]
        if n_chains % n_chain_shards:
            raise ValueError(
                f"n_chains={n_chains} must be divisible by the mesh chain axis "
                f"({n_chain_shards})"
            )
        ct = {
            k: jnp.asarray(v, self.config.dtype)
            for k, v in dict(chain_tuning or {}).items()
        }
        for k, v in ct.items():
            if v.shape[:1] != (n_chains,):
                raise ValueError(
                    f"chain_tuning[{k!r}] must have leading dim n_chains={n_chains}"
                )
        shardings = self._state_sharding(tuple(ct.keys()))
        # Compute the init directly INTO the sharded layout (out_shardings)
        # rather than device_put after the fact: under a multi-host mesh a
        # post-hoc device_put would be a cross-process reshard of
        # process-local arrays, which is not expressible; PRNG keys enter
        # as replicated raw uint32 key data so every process passes an
        # identical host-local operand.
        key_data = np.asarray(
            jax.random.key_data(jax.random.split(key, n_chains))
        )

        def _init(kd, ct):
            return jax.vmap(self._init_one)(jax.random.wrap_key_data(kd), ct)

        fn = jax.jit(_init, out_shardings=shardings)
        return fn(key_data, ct)
