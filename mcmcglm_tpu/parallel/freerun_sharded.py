"""Multi-chip FreeRunCGGibbs: chain-sharded free-running via shard_map.

Why shard_map and not GSPMD placement (the ShardedCGGibbs approach): the
free-running engine's outer ``lax.while_loop`` condition is a reduction
over ALL chains (``any(sweep_count < n_sweeps)``).  Under GSPMD that
becomes a cross-chip all-reduce on every pass — a per-pass latency tax and
a global tail (every chip spins until the slowest chain anywhere on the
mesh finishes).  Chains are i.i.d., so nothing in the sampler ever needs
to cross chips: ``shard_map`` over the ``chain`` mesh axis runs one
completely independent free-running automaton per device — zero collectives
from init to final draw, per-device tails, and (given one PRNG key per
shard) bitwise-identical draws to running each shard's chains alone.

This is the production chain-scaling path for the BASELINE 4096-chain
configuration: X and y are replicated per chip (the design matrix is the
small object at GLM scale — p=1000, n=10k is 40 MB), chains are the
data-parallel axis (SURVEY.md §2.3), and scaling efficiency is limited
only by per-chip tail effects, not communication.  For tall datasets where
X does NOT fit per-chip, use :class:`ShardedCGGibbs`, which shards the
observation axis and psums the per-shard log-density sums.

Reference counterpart: none — the R package's only parallelism is
process-level experiment fan-out (R/slice_utilities.R:72-79).  Pooled
cross-shard diagnostics live in :mod:`mcmcglm_tpu.parallel.pooled`.
"""

from __future__ import annotations

from functools import partial
from typing import Mapping, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
try:
    from jax import shard_map as _shard_map_impl
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map as _shard_map_impl


def shard_map(f, **kw):
    """shard_map with varying-axis checking off: the automaton's while-loop
    carries are initialised inside the body (replicated zeros) and become
    chain-varying on the first pass, which the strict VMA checker rejects.
    Handles the check_vma (new) / check_rep (old) kwarg rename."""
    try:
        return _shard_map_impl(f, check_vma=False, **kw)
    except TypeError:
        return _shard_map_impl(f, check_rep=False, **kw)

from ..freerun import FreeRunCGGibbs, FreeRunState
from .mesh import CHAIN_AXIS, make_mesh

__all__ = ["ShardedFreeRunCGGibbs"]


class ShardedFreeRunCGGibbs:
    """FreeRunCGGibbs over the ``chain`` axis of a device mesh.

    Same ``init`` / ``warmup`` / ``run`` / ``sample`` surface as
    :class:`~mcmcglm_tpu.freerun.FreeRunCGGibbs`; ``n_chains`` must be
    divisible by the number of chain shards.  The returned state's arrays
    are global ``jax.Array``\\ s sharded on their leading (chain) axis —
    except ``key``, which holds one PRNG key per shard (shape (S,)).
    """

    def __init__(self, X, y, family, prior, mesh: Optional[Mesh] = None,
                 **kwargs):
        self.mesh = mesh if mesh is not None else make_mesh()
        if self.mesh.shape.get("obs", 1) != 1:
            raise ValueError(
                "ShardedFreeRunCGGibbs shards chains only (X is replicated "
                "per chip); use ShardedCGGibbs to shard the observation axis"
            )
        self.n_shards = self.mesh.shape[CHAIN_AXIS]
        self.inner = FreeRunCGGibbs(X, y, family, prior, **kwargs)
        self._fn_cache: dict = {}

    # local (per-shard) <-> global state plumbing: every FreeRunState field
    # is batched over chains on axis 0 except ``key``; the sharded state
    # carries one key per shard on axis 0 instead.
    def _specs(self):
        s = P(CHAIN_AXIS)
        base = dict(
            beta=P(CHAIN_AXIS, None), eta=P(CHAIN_AXIS, None),
            ld0=s if self.inner.eval_cache == "scalar" else P(CHAIN_AXIS, None),
            key=s, logw=P(CHAIN_AXIS, None),
            j=s, phase=s, stepdir=s, level=s, L=s, R=s, budL=s, budR=s,
            b0=s, lp0=s, w=s, xprop=s, n_shrink=s, nev=s,
        )
        # state-class extension registers: DoublingState's back-test
        # block is per-chain (C,); QuantileState's pseudo-target loc
        # buffer is (C, d) — both chain-sharded on axis 0
        base["qloc"] = P(CHAIN_AXIS, None)
        cls = self.inner.state_cls
        return cls(**{f: base.get(f, s) for f in cls._fields})

    def _check_chains(self, n_chains: int) -> int:
        if n_chains % self.n_shards:
            raise ValueError(
                f"n_chains={n_chains} not divisible by "
                f"{self.n_shards} chain shards"
            )
        return n_chains // self.n_shards

    def init(self, key, n_chains: int) -> FreeRunState:
        c_local = self._check_chains(n_chains)
        specs = self._specs()

        def init_shard(key_data):
            # keys arrive as replicated raw uint32 key data (multi-host
            # safe: every process passes an identical host-local numpy
            # operand; typed local key arrays could not be fed to a jit
            # over a mesh spanning other processes' devices)
            st = self.inner._init(
                jax.random.wrap_key_data(key_data[0]), n_chains=c_local
            )
            return st._replace(key=st.key[None])

        fn = jax.jit(
            shard_map(
                init_shard, mesh=self.mesh, in_specs=P(CHAIN_AXIS),
                out_specs=specs,
            )
        )
        kd = np.asarray(jax.random.key_data(jax.random.split(key, self.n_shards)))
        return fn(kd)

    def _run_sharded(self, state: FreeRunState, n_sweeps: int, adapt: bool,
                     shrink_only: bool, stepout_sweeps=None):
        specs = self._specs()
        key_ = (n_sweeps, adapt, shrink_only, stepout_sweeps,
                int(state.beta.shape[0]))
        fn = self._fn_cache.get(key_)
        if fn is None:

            def run_shard(st):
                st2, draws, nevbuf = self.inner._run(
                    st._replace(key=st.key[0]), n_sweeps, adapt, shrink_only,
                    stepout_sweeps
                )
                return st2._replace(key=st2.key[None]), draws, nevbuf

            fn = jax.jit(
                shard_map(
                    run_shard, mesh=self.mesh, in_specs=(specs,),
                    out_specs=(specs, P(CHAIN_AXIS, None, None),
                               P(CHAIN_AXIS, None)),
                )
            )
            self._fn_cache[key_] = fn
        state, draws, nevbuf = fn(state)
        return state, draws, nevbuf

    def run(self, state: FreeRunState, n_sweeps: int):
        """Advance every chain by ``n_sweeps`` sweeps; each device's
        automaton loops independently (no cross-chip sync at all)."""
        return self._run_sharded(state, n_sweeps, adapt=False,
                                 shrink_only=self.inner.shrink_only)

    def warmup(self, state: FreeRunState, n_sweeps: int,
               stepout_sweeps=None):
        """Adaptive-width warmup, per-shard (two-phase schedule as in
        FreeRunCGGibbs.warmup)."""
        if stepout_sweeps is None:
            stepout_sweeps = self.inner._auto_stepout(n_sweeps)
        return self._run_sharded(state, n_sweeps, adapt=True,
                                 shrink_only=False,
                                 stepout_sweeps=int(stepout_sweeps))

    def warmup_passes(self, state: FreeRunState, sweep_count, n_sweeps: int,
                      n_passes: int, stepout_sweeps=None):
        """Pass-bounded adaptive warmup, per shard — the pod-scale warmup
        mode (see FreeRunCGGibbs.warmup_passes).  ``sweep_count`` is a
        chain-sharded (C,) int32 counter; pass ``None`` to start from zero.
        Returns (state, sweep_count); loop until
        ``(np.asarray(sweep_count) >= n_sweeps).all()``."""
        specs = self._specs()
        C = int(state.beta.shape[0])
        if stepout_sweeps is None:
            stepout_sweeps = self.inner._auto_stepout(n_sweeps)
        if sweep_count is None:
            sweep_count = jax.device_put(
                jnp.zeros((C,), jnp.int32),
                NamedSharding(self.mesh, P(CHAIN_AXIS)),
            )
        key_ = ("passes", n_sweeps, n_passes, int(stepout_sweeps), C)
        fn = self._fn_cache.get(key_)
        if fn is None:

            def run_shard(st, sc):
                st2, sc2 = self.inner._run_pass_block(
                    st._replace(key=st.key[0]), sc,
                    n_sweeps=n_sweeps, n_passes=n_passes,
                    adapt=True, shrink_only=False,
                    stepout_sweeps=int(stepout_sweeps),
                )
                return st2._replace(key=st2.key[None]), sc2

            fn = jax.jit(
                shard_map(
                    run_shard, mesh=self.mesh,
                    in_specs=(specs, P(CHAIN_AXIS)),
                    out_specs=(specs, P(CHAIN_AXIS)),
                )
            )
            self._fn_cache[key_] = fn
        return fn(state, sweep_count)

    def run_passes(self, state: FreeRunState, sweep_count, draws, nevbuf,
                   n_sweeps: int, n_passes: int, compile_only: bool = False):
        """Pass-bounded, barrier-free sampling collection per shard (see
        FreeRunCGGibbs.run_passes): chains run freely across sweep
        boundaries for the whole collection, and the carried
        (C, n_sweeps, d) draws buffer stays chain-sharded on device
        across dispatches — the pod thin=1 collection mode that pays the
        cross-chain sweep tail ONCE instead of per dispatch.  Pass None
        for sweep_count/draws/nevbuf to allocate; loop until
        ``(np.asarray(sweep_count) >= n_sweeps).all()``.

        ``compile_only=True`` lowers + compiles the executable from
        ABSTRACT inputs (no buffer allocation, no execution) and returns
        None — warming the persistent compile cache without touching
        device memory (a throwaway warm-up EXECUTION doubles the peak
        draws-buffer footprint, which OOM'd a 4096-chain pod session on
        a device left fragmented by a prior crash)."""
        specs = self._specs()
        C = int(state.beta.shape[0])
        d = self.inner.d
        if compile_only:
            def sds(spec, shape, dtype):
                return jax.ShapeDtypeStruct(
                    shape, dtype, sharding=NamedSharding(self.mesh, spec)
                )

            st_sds = jax.tree.map(
                lambda x, sp: jax.ShapeDtypeStruct(
                    x.shape, x.dtype, sharding=NamedSharding(self.mesh, sp)
                ),
                state, specs,
            )
            fn = self._run_passes_fn(n_sweeps, n_passes, C)
            fn.lower(
                st_sds,
                sds(P(CHAIN_AXIS), (C,), jnp.int32),
                sds(P(CHAIN_AXIS, None, None), (C, n_sweeps, d),
                    self.inner.dtype),
                sds(P(CHAIN_AXIS, None), (C, n_sweeps), jnp.int32),
            ).compile()
            return None
        if sweep_count is None:
            sweep_count = jax.device_put(
                jnp.zeros((C,), jnp.int32),
                NamedSharding(self.mesh, P(CHAIN_AXIS)),
            )
        if draws is None:
            draws = jax.device_put(
                jnp.zeros((C, n_sweeps, d), self.inner.dtype),
                NamedSharding(self.mesh, P(CHAIN_AXIS, None, None)),
            )
        if nevbuf is None:
            nevbuf = jax.device_put(
                jnp.zeros((C, n_sweeps), jnp.int32),
                NamedSharding(self.mesh, P(CHAIN_AXIS, None)),
            )
        fn = self._run_passes_fn(n_sweeps, n_passes, C)
        return fn(state, sweep_count, draws, nevbuf)

    def _run_passes_fn(self, n_sweeps: int, n_passes: int, C: int):
        specs = self._specs()
        key_ = ("run_passes", n_sweeps, n_passes, C)
        fn = self._fn_cache.get(key_)
        if fn is None:

            def run_shard(st, sc, dr, nb):
                st2, sc2, dr2, nb2 = self.inner._run_pass_block(
                    st._replace(key=st.key[0]), sc,
                    n_sweeps=n_sweeps, n_passes=n_passes,
                    adapt=False, shrink_only=self.inner.shrink_only,
                    draws=dr, nevbuf=nb,
                )
                return st2._replace(key=st2.key[None]), sc2, dr2, nb2

            fn = jax.jit(
                shard_map(
                    run_shard, mesh=self.mesh,
                    in_specs=(specs, P(CHAIN_AXIS),
                              P(CHAIN_AXIS, None, None), P(CHAIN_AXIS, None)),
                    out_specs=(specs, P(CHAIN_AXIS),
                               P(CHAIN_AXIS, None, None), P(CHAIN_AXIS, None)),
                ),
                donate_argnums=(2,),
            )
            self._fn_cache[key_] = fn
        return fn

    def run_thinned(self, state: FreeRunState, n_outer: int, thin: int,
                    moments=None, ess: bool = False, ess_max_lag: int = 64):
        """Thinned collection + streaming per-chain Welford moments, per
        shard (FreeRunCGGibbs.run_thinned over the chain mesh axis — the
        BASELINE pod configuration's collection mode).  Returns
        (state, moments, draws (C, n_outer, d), n_evals (C,)); moments
        arrays are chain-sharded, so ``pooled_summary`` reductions over
        them lower to psums under jit.

        ``ess=True`` additionally streams the on-device split-chain
        autocovariance accumulator per shard and returns it FIFTH
        (chain-sharded; ``pooled.ess_from_state`` under jit then lowers
        its chain reductions to psums — min-ESS with only (d,)-sized
        host transfers, SURVEY §8.3)."""
        from .pooled import ChainMoments, init_ess

        specs = self._specs()
        mom_specs = ChainMoments(
            count=P(CHAIN_AXIS), mean=P(CHAIN_AXIS, None),
            m2=P(CHAIN_AXIS, None),
        )
        C = int(state.beta.shape[0])
        d = self.inner.d
        dt = self.inner.dtype
        if moments is None:
            zeros = jax.jit(
                lambda: ChainMoments(
                    count=jnp.zeros((C,), dt),
                    mean=jnp.zeros((C, d), dt),
                    m2=jnp.zeros((C, d), dt),
                ),
                out_shardings=jax.tree.map(
                    lambda s: NamedSharding(self.mesh, s), mom_specs
                ),
            )
            moments = zeros()
        ess_state = None
        ess_specs = None
        if ess:
            from .pooled import ESSState

            ess_specs = ESSState(
                s=P(CHAIN_AXIS, None, None, None),
                ring=P(CHAIN_AXIS, None, None, None),
                first=P(CHAIN_AXIS, None, None, None),
                total=P(CHAIN_AXIS, None, None),
                count=P(), planned=P(),
            )
            mk = jax.jit(
                partial(init_ess, C, d, planned=n_outer,
                        max_lag=ess_max_lag, dtype=dt),
                out_shardings=jax.tree.map(
                    lambda s: NamedSharding(self.mesh, s), ess_specs
                ),
            )
            ess_state = mk()
        key_ = ("thinned", n_outer, thin, C, bool(ess),
                ess_max_lag if ess else None)
        fn = self._fn_cache.get(key_)
        if fn is None:

            def run_shard(st, mom, es):
                st2, (cnt, mean, m2), draws, es = (
                    self.inner._run_thinned_impl(
                        st._replace(key=st.key[0]),
                        (mom.count, mom.mean, mom.m2),
                        n_outer, thin, self.inner.shrink_only, ess=es,
                    )
                )
                return (
                    st2._replace(key=st2.key[None]),
                    ChainMoments(cnt, mean, m2),
                    draws,
                    es,
                )

            fn = jax.jit(
                shard_map(
                    run_shard, mesh=self.mesh,
                    in_specs=(specs, mom_specs, ess_specs),
                    out_specs=(specs, mom_specs, P(CHAIN_AXIS, None, None),
                               ess_specs),
                )
            )
            self._fn_cache[key_] = fn
        state, moments, draws, ess_state = fn(state, moments, ess_state)
        if ess:
            return state, moments, draws, state.nev, ess_state
        return state, moments, draws, state.nev

    def sample(self, key, n_samples: int, n_chains: int, chunk_size: int = 0,
               progress=None):
        """Init from the prior, then collect ``n_samples`` sweeps per chain.
        Returns (betas (C, n_samples + 1, d) numpy, n_evals (C,), state)."""
        state = self.init(key, n_chains)
        parts = [np.asarray(state.beta)[:, None, :]]
        if chunk_size <= 0:
            chunk_size = n_samples
        done = 0
        while done < n_samples:
            step = min(chunk_size, n_samples - done)
            state, draws, _ = self.run(state, step)
            parts.append(np.asarray(draws))
            done += step
            if progress is not None:
                progress(done, n_samples)
        return np.concatenate(parts, axis=1), np.asarray(state.nev), state
