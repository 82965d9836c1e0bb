"""Obs-sharded FreeRunCGGibbs: the tall-data fast path.

The chain-sharded free-running engine (``freerun_sharded.py``) replicates
the design matrix X (d, n) per chip and carries a (C, n) linear-predictor
slab per chip — for n where either exceeds HBM, the flagship engine
simply cannot run.  This class extends the free-running automaton to a
(chain x obs) mesh so the fast engine covers the reference's whole point
— O(n) per-evaluation work on the long observation axis
(reference ``R/glm_utils.R:126-132``; SURVEY.md §2.3 maps
obs-sharding as *the* data-parallel dimension for huge n, §5 "shard the
n axis, psum per-shard sums"):

  * X^T (d, n)  -> ``P(None, obs)``     every chip holds its column slab
  * y, mask     -> ``P(obs)``
  * eta (C, n)  -> ``P(chain, obs)``    the eta update stays shard-local
  * beta, logw, draws, automaton registers -> replicated over ``obs``

Per pass, each obs shard evaluates its slice of the relative target —
``ld(eta_local + xg_local * delta)`` — and ONE ``lax.psum`` over the
``obs`` mesh axis turns the per-shard partial log-likelihood sums
((C,) or (C, K), a few KB) into the global sums.  Everything downstream
of the psum — slice level tests, interval updates, commits, PRNG draws —
is a deterministic function of (psum result, replicated registers, the
per-chain-shard key), so the obs shards of one chain row advance their
replicated automaton registers in bitwise lockstep without any further
communication: one tiny all-reduce per pass is the entire communication
cost, riding the device interconnect (NVLink).

Chain shards still never communicate (the while-loop condition is local
to the chain shard, as in ``freerun_sharded.py``), so per-chain-shard
tails are preserved: the ``psum`` groups are the obs rows of each chain
shard, and different chain shards run different pass counts freely.

Any ``spec_k``: the accept decision is made after the cross-shard psum
of the proposals' partial sums.  The
``coord_sampler="conjugate"`` exact gaussian-identity path works
unchanged (its cross products ride the same psum'd reduction).

Reference counterpart: none (single R process); this is the SURVEY §2.3
DP row ("observation-axis sharding of X across devices with psum of
per-shard log-density sums").
"""

from __future__ import annotations

import copy
from typing import Mapping, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..freerun import FreeRunCGGibbs, FreeRunState
from .freerun_sharded import shard_map
from .mesh import CHAIN_AXIS, OBS_AXIS, make_mesh
from .sharded_engine import _put

__all__ = ["ObsShardedFreeRunCGGibbs"]


class ObsShardedFreeRunCGGibbs:
    """FreeRunCGGibbs over a (chain, obs) device mesh.

    Same ``init`` / ``warmup`` / ``run`` / ``run_passes`` / ``run_thinned``
    / ``sample`` surface as :class:`~mcmcglm_tpu.freerun.FreeRunCGGibbs`.
    ``n_chains`` must be divisible by the chain-axis size; the observation
    count is padded up to a multiple of the obs-axis size (padding rows
    carry zero X, y = 1 and zero reduction weight — masked by *selection*,
    not multiplication, so families whose log density is NaN at the
    padding point cannot poison the sums).
    """

    def __init__(
        self,
        X,
        y,
        family,
        prior,
        mesh: Optional[Mesh] = None,
        extra: Optional[Mapping] = None,
        tuning: Optional[Mapping] = None,
        obs_weights=None,
        offset=None,
        reduce_fn=None,
        dtype=jnp.float32,
        **kwargs,
    ):
        if reduce_fn is not None:
            raise ValueError(
                "ObsShardedFreeRunCGGibbs owns the observation reduction "
                "(shard-local masked sum + psum over the obs mesh axis); a "
                "custom reduce_fn cannot be assumed psum-compatible — use "
                "obs_weights for weighted likelihoods"
            )
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_chain_shards = self.mesh.shape[CHAIN_AXIS]
        self.n_obs_shards = self.mesh.shape[OBS_AXIS]

        X = np.asarray(X)
        y = np.asarray(y).reshape(-1)
        n = X.shape[0]
        self._n_real = n
        pad = (-n) % self.n_obs_shards
        if pad:
            X = np.concatenate(
                [X, np.zeros((pad, X.shape[1]), X.dtype)], axis=0
            )
            # padded y = 1.0, NOT 0: log(y) terms (gamma, inverse-gaussian)
            # are -inf/NaN at y = 0 and the mask selects, so any finite
            # value works — 1.0 keeps every family's density finite there
            y = np.concatenate([y, np.ones(pad, y.dtype)])
        if obs_weights is not None:
            w_vec = np.asarray(obs_weights, np.float64).reshape(-1)
            if w_vec.shape[0] != n:
                raise ValueError(
                    f"obs_weights length {w_vec.shape[0]} != n observations {n}"
                )
        else:
            w_vec = np.ones(n)
        mask_np = np.concatenate([w_vec, np.zeros(pad)])
        if offset is not None:
            offset = np.asarray(offset).reshape(-1)
            if offset.shape[0] != n:
                raise ValueError(
                    f"offset length {offset.shape[0]} != n observations {n}"
                )
            offset = np.concatenate([offset, np.zeros(pad, offset.dtype)])
        for k, v in dict(extra or {}).items():
            if np.ndim(v) != 0:
                raise ValueError(
                    f"extra[{k!r}] is per-observation shaped; obs-sharded "
                    "freerun supports scalar extra args only"
                )

        # the GLOBAL masked reduction (used by the inner constructor's
        # setup-time paths, e.g. the conjugate sum_i w x^2); the per-pass
        # reduction is the shard-LOCAL version + psum, installed in _local
        mask_global = jnp.asarray(mask_np, dtype)

        def global_reduce(t):
            return jnp.sum(
                jnp.where(mask_global != 0, t * mask_global, 0.0), axis=-1
            )

        self.inner = FreeRunCGGibbs(
            X, y, family, prior, extra=extra, tuning=tuning,
            reduce_fn=global_reduce, offset=offset,
            dtype=dtype, **kwargs,
        )
        # commit the observation-axis data to the mesh and drop the
        # replicated default-device copies (steady-state per-device
        # footprint of X / y is 1/n_obs_shards of the global)
        self._Xt_g = _put(self.inner.Xt, self.mesh, P(None, OBS_AXIS))
        self._y_g = _put(self.inner.y, self.mesh, P(OBS_AXIS))
        self._mask_g = _put(mask_global, self.mesh, P(OBS_AXIS))
        self.inner.Xt = self._Xt_g
        self.inner.y = self._y_g
        if self.inner.offset is not None:
            self._off_g = _put(self.inner.offset, self.mesh, P(OBS_AXIS))
            self.inner.offset = self._off_g
        else:
            self._off_g = None
        self._fn_cache: dict = {}

    # -- per-shard engine surgery -----------------------------------------

    def _data_args(self):
        """The observation-axis operands threaded through every shard_map
        (closures would replicate them; operands shard)."""
        args = [self._Xt_g, self._y_g, self._mask_g]
        specs = [P(None, OBS_AXIS), P(OBS_AXIS), P(OBS_AXIS)]
        if self._off_g is not None:
            args.append(self._off_g)
            specs.append(P(OBS_AXIS))
        return tuple(args), tuple(specs)

    def _local(self, xt, y, mask, *rest):
        """A shallow engine copy wired to this shard's observation slab,
        with the psum'd masked reduction.  Valid only inside a shard_map
        trace (xt/y/mask are local tracers)."""
        eng = copy.copy(self.inner)
        eng.Xt = xt
        eng.y = y
        eng.offset = rest[0] if rest else None

        def local_reduce(t):
            return lax.psum(
                jnp.sum(jnp.where(mask != 0, t * mask, 0.0), axis=-1),
                OBS_AXIS,
            )

        eng.reduce_fn = local_reduce
        # isolate caches: nothing may leak tracers back to the shared inner
        eng._run_cache = {}
        return eng

    # -- state specs (mirrors freerun_sharded._specs + obs axis) -----------

    def _specs(self):
        s = P(CHAIN_AXIS)
        base = dict(
            beta=P(CHAIN_AXIS, None),
            eta=P(CHAIN_AXIS, OBS_AXIS),
            ld0=(
                s if self.inner.eval_cache == "scalar"
                else P(CHAIN_AXIS, OBS_AXIS)
            ),
            key=s, logw=P(CHAIN_AXIS, None),
            j=s, phase=s, stepdir=s, level=s, L=s, R=s, budL=s, budR=s,
            b0=s, lp0=s, w=s, xprop=s, n_shrink=s, nev=s,
        )
        # state-class extension registers: DoublingState's back-test
        # block is per-chain (C,); QuantileState's pseudo-target loc
        # buffer is (C, d) — chain-sharded, obs-replicated either way
        base["qloc"] = P(CHAIN_AXIS, None)
        cls = self.inner.state_cls
        return cls(**{f: base.get(f, s) for f in cls._fields})

    def _check_chains(self, n_chains: int) -> int:
        if n_chains % self.n_chain_shards:
            raise ValueError(
                f"n_chains={n_chains} not divisible by "
                f"{self.n_chain_shards} chain shards"
            )
        return n_chains // self.n_chain_shards

    # -- the sampler surface ----------------------------------------------

    def init(self, key, n_chains: int) -> FreeRunState:
        c_local = self._check_chains(n_chains)
        specs = self._specs()
        args, dspecs = self._data_args()

        def init_shard(key_data, *data):
            eng = self._local(*data)
            st = eng._init(
                jax.random.wrap_key_data(key_data[0]), n_chains=c_local
            )
            return st._replace(key=st.key[None])

        fn = jax.jit(
            shard_map(
                init_shard, mesh=self.mesh,
                in_specs=(P(CHAIN_AXIS), *dspecs),
                out_specs=specs,
            )
        )
        kd = np.asarray(
            jax.random.key_data(jax.random.split(key, self.n_chain_shards))
        )
        return fn(kd, *args)

    def _run_sharded(self, state: FreeRunState, n_sweeps: int, adapt: bool,
                     shrink_only: bool, stepout_sweeps=None):
        specs = self._specs()
        args, dspecs = self._data_args()
        key_ = (n_sweeps, adapt, shrink_only, stepout_sweeps,
                int(state.beta.shape[0]))
        fn = self._fn_cache.get(key_)
        if fn is None:

            def run_shard(st, *data):
                eng = self._local(*data)
                st2, draws, nevbuf = eng._run(
                    st._replace(key=st.key[0]), n_sweeps, adapt, shrink_only,
                    stepout_sweeps
                )
                return st2._replace(key=st2.key[None]), draws, nevbuf

            fn = jax.jit(
                shard_map(
                    run_shard, mesh=self.mesh, in_specs=(specs, *dspecs),
                    out_specs=(specs, P(CHAIN_AXIS, None, None),
                               P(CHAIN_AXIS, None)),
                )
            )
            self._fn_cache[key_] = fn
        return fn(state, *args)

    def run(self, state: FreeRunState, n_sweeps: int):
        """Advance every chain by ``n_sweeps`` sweeps; one (C, K)-sized
        psum over the obs axis per pass is the only communication."""
        return self._run_sharded(state, n_sweeps, adapt=False,
                                 shrink_only=self.inner.shrink_only)

    def warmup(self, state: FreeRunState, n_sweeps: int,
               stepout_sweeps=None):
        """Adaptive-width warmup (two-phase schedule as in
        FreeRunCGGibbs.warmup)."""
        if stepout_sweeps is None:
            stepout_sweeps = self.inner._auto_stepout(n_sweeps)
        return self._run_sharded(state, n_sweeps, adapt=True,
                                 shrink_only=False,
                                 stepout_sweeps=int(stepout_sweeps))

    def warmup_passes(self, state: FreeRunState, sweep_count, n_sweeps: int,
                      n_passes: int, stepout_sweeps=None):
        """Pass-bounded adaptive warmup (see FreeRunCGGibbs.warmup_passes);
        ``sweep_count`` is (C,) chain-sharded, ``None`` to start at zero."""
        specs = self._specs()
        args, dspecs = self._data_args()
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

            def run_shard(st, sc, *data):
                eng = self._local(*data)
                st2, sc2 = eng._run_pass_block(
                    st._replace(key=st.key[0]), sc,
                    n_sweeps=n_sweeps, n_passes=n_passes,
                    adapt=True, shrink_only=False,
                    stepout_sweeps=int(stepout_sweeps),
                )
                return st2._replace(key=st2.key[None]), sc2

            fn = jax.jit(
                shard_map(
                    run_shard, mesh=self.mesh,
                    in_specs=(specs, P(CHAIN_AXIS), *dspecs),
                    out_specs=(specs, P(CHAIN_AXIS)),
                )
            )
            self._fn_cache[key_] = fn
        return fn(state, sweep_count, *args)

    def run_passes(self, state: FreeRunState, sweep_count, draws, nevbuf,
                   n_sweeps: int, n_passes: int):
        """Pass-bounded, barrier-free collection (see
        FreeRunCGGibbs.run_passes); the carried (C, n_sweeps, d) draws
        buffer stays chain-sharded (obs-replicated) and donated across
        dispatches."""
        specs = self._specs()
        args, dspecs = self._data_args()
        C = int(state.beta.shape[0])
        d = self.inner.d
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
        key_ = ("run_passes", n_sweeps, n_passes, C)
        fn = self._fn_cache.get(key_)
        if fn is None:

            def run_shard(st, sc, dr, nb, *data):
                eng = self._local(*data)
                st2, sc2, dr2, nb2 = eng._run_pass_block(
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
                              P(CHAIN_AXIS, None, None), P(CHAIN_AXIS, None),
                              *dspecs),
                    out_specs=(specs, P(CHAIN_AXIS),
                               P(CHAIN_AXIS, None, None), P(CHAIN_AXIS, None)),
                ),
                donate_argnums=(2,),
            )
            self._fn_cache[key_] = fn
        return fn(state, sweep_count, draws, nevbuf, *args)

    def run_thinned(self, state: FreeRunState, n_outer: int, thin: int,
                    moments=None, ess: bool = False, ess_max_lag: int = 64):
        """Thinned collection + streaming per-chain Welford moments (see
        FreeRunCGGibbs.run_thinned).  Moments are chain-sharded
        (obs-replicated), so pooled_summary reductions lower to psums.
        ``ess=True`` additionally streams the on-device autocovariance
        accumulator and returns it FIFTH (see
        ShardedFreeRunCGGibbs.run_thinned)."""
        from functools import partial

        from .pooled import ChainMoments, init_ess

        specs = self._specs()
        args, dspecs = self._data_args()
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

            def run_shard(st, mom, es, *data):
                eng = self._local(*data)
                st2, (cnt, mean, m2), draws, es = eng._run_thinned_impl(
                    st._replace(key=st.key[0]),
                    (mom.count, mom.mean, mom.m2),
                    n_outer, thin, self.inner.shrink_only, ess=es,
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
                    in_specs=(specs, mom_specs, ess_specs, *dspecs),
                    out_specs=(specs, mom_specs, P(CHAIN_AXIS, None, None),
                               ess_specs),
                )
            )
            self._fn_cache[key_] = fn
        state, moments, draws, ess_state = fn(state, moments, ess_state, *args)
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
