"""Two-process jax.distributed dryrun of the multi-host path (CPU).

The reference's only parallelism is single-machine R worker processes
(reference R/slice_utilities.R:72-79); this package replaces it with the
JAX multi-host runtime (SURVEY.md §2.3/§5).  This script actually EXECUTES
that path without multi-host hardware: two OS processes, each with 4 virtual
CPU devices, joined into one 8-device global mesh via
``jax.distributed.initialize`` (gloo CPU collectives).

Exercised end-to-end, per process:
  * parallel.distributed.initialize with an explicit coordinator;
  * ShardedFreeRunCGGibbs over the global chain mesh: init / warmup / run /
    run_thinned (shard_map across processes, zero collectives);
  * pooled_summary over the chain-sharded moments (cross-process psum);
  * ShardedCGGibbs over a (chain x obs) global mesh where the observation
    axis spans BOTH processes — every slice evaluation all-reduces its
    log-density partial sums across the process boundary;
  * CheckpointManager save + restore of the sharded freerun state
    (orbax multi-host), and a post-restore run continuing bitwise
    identically to the uninterrupted run.

Usage:
    python scripts/multihost_dryrun.py            # launcher: spawns 2 workers
    python scripts/multihost_dryrun.py --worker I # internal worker entry
"""

import argparse
import os
import subprocess
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

N_PROC = 2
DEVS_PER_PROC = 4
PORT = int(os.environ.get("MULTIHOST_DRYRUN_PORT", "52345"))


def worker(process_id: int, ckpt_dir: str):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={DEVS_PER_PROC}"
    ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")

    from mcmcglm_tpu.parallel import distributed

    # the real initialize path (never a no-op here: explicit coordinator)
    distributed.initialize(
        coordinator_address=f"localhost:{PORT}",
        num_processes=N_PROC,
        process_id=process_id,
    )
    assert distributed.is_distributed()
    assert jax.process_count() == N_PROC, jax.process_count()
    assert jax.device_count() == N_PROC * DEVS_PER_PROC
    assert jax.local_device_count() == DEVS_PER_PROC

    import numpy as np

    import mcmcglm_tpu as mg
    from mcmcglm_tpu.parallel import (
        ShardedCGGibbs,
        ShardedFreeRunCGGibbs,
        make_mesh,
    )
    from mcmcglm_tpu.parallel.pooled import ChainMoments, pooled_summary

    rng = np.random.default_rng(0)  # identical data on every process
    n, d = 96, 5
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    beta_true = rng.normal(size=d)
    y = rng.binomial(1, 1 / (1 + np.exp(-X @ beta_true))).astype(float)
    prior = mg.IIDPrior(mg.Normal(0.0, 1.0), d)

    # -- 1. chain-sharded freerun over all 8 devices / 2 processes ---------
    mesh = make_mesh(8, 1)
    fr = ShardedFreeRunCGGibbs(
        X, y, "binomial", prior, tuning={"w": 0.5}, mesh=mesh
    )
    st = fr.init(jax.random.key(0), 16)
    st, _, _ = fr.warmup(st, 10)
    st, draws, _ = fr.run(st, 5)
    jax.block_until_ready(draws)
    assert draws.shape == (16, 5, d)
    # every process checks its own addressable shards
    for shard in draws.addressable_shards:
        assert np.isfinite(np.asarray(shard.data)).all()

    st_ckpt = st  # checkpoint this state below

    st2, mom, kept, _ = fr.run_thinned(st, n_outer=4, thin=2)
    jax.block_until_ready(kept)
    summ = jax.jit(pooled_summary)(
        ChainMoments(mom.count[0], mom.mean, mom.m2)
    )
    # pooled stats psum over the chain axis across the process boundary;
    # the (d,) results are replicated -> host-readable on every process
    rhat = np.asarray(summ["rhat"])
    assert rhat.shape == (d,) and np.isfinite(rhat).all()

    # -- 2. obs-axis sharding across the process boundary ------------------
    # chain axis = 2 (one shard per process is NOT forced; layout is
    # (2 chains x 4 obs) so the log-density all-reduce crosses processes)
    mesh2 = make_mesh(2, 4)
    eng = ShardedCGGibbs(
        X, y, "binomial", prior, tuning={"w": 0.5}, mesh=mesh2
    )
    st_x = eng.init(jax.random.key(1), 4)
    st_x, betas, _ = eng.run(st_x, 3)
    jax.block_until_ready(betas)
    assert betas.shape == (4, 3, d)
    for shard in betas.addressable_shards:
        assert np.isfinite(np.asarray(shard.data)).all()

    # -- 3. checkpoint/restore of the sharded state across processes -------
    from mcmcglm_tpu.checkpoint import CheckpointManager

    cm = CheckpointManager(ckpt_dir)
    cm.save(100, st_ckpt)
    restored = cm.restore(st_ckpt)
    assert restored is not None
    step, st_r, _ = restored
    assert step == 100
    # the restored state must continue bitwise identically
    st_a, draws_a, _ = fr.run(st_ckpt, 4)
    st_b, draws_b, _ = fr.run(st_r, 4)
    jax.block_until_ready((draws_a, draws_b))
    for sa, sb in zip(draws_a.addressable_shards, draws_b.addressable_shards):
        np.testing.assert_array_equal(np.asarray(sa.data), np.asarray(sb.data))
    cm.close()

    distributed.sync_global_devices("dryrun-done")
    if process_id == 0:
        print("MULTIHOST_DRYRUN_OK", flush=True)


def launch():
    with tempfile.TemporaryDirectory() as ckpt_dir:
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 str(i), "--ckpt-dir", ckpt_dir],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            for i in range(N_PROC)
        ]
        outs = []
        rc = 0
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
            rc |= p.returncode
        if rc != 0 or "MULTIHOST_DRYRUN_OK" not in outs[0]:
            for i, o in enumerate(outs):
                sys.stderr.write(f"--- worker {i} ---\n{o}\n")
            sys.exit(1)
        print("MULTIHOST_DRYRUN_OK (launcher)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    args = ap.parse_args()
    if args.worker is None:
        launch()
    else:
        worker(args.worker, args.ckpt_dir)
