"""Capacity evidence for the obs-sharded freerun path (VERDICT r4 #1).

The claim: the tall-data engine's steady-state PER-DEVICE footprint for
the observation-axis operands (X^T slabs, y, mask, eta, per-obs caches)
scales as 1/n_obs_shards, so problems where the replicated layout cannot
fit one card run on a (chain x obs) mesh.  The mechanical evidence is the
XLA-compiled memory analysis on the 8-virtual-device CPU mesh: per-device
argument + temp bytes of the SAME run executable under obs = 1 vs obs = 8
sharding.

Prints one JSON line per mesh and a summary object.
"""

import json
import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
from mcmcglm_tpu.parallel import (  # noqa: E402
    ObsShardedFreeRunCGGibbs,
    make_mesh,
)


def probe(n_obs_shards: int, n: int, d: int, C: int):
    n_chain = 8 // n_obs_shards
    mesh = make_mesh(n_chain, n_obs_shards)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    eng = ObsShardedFreeRunCGGibbs(
        X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
        extra={"sd": 1.0}, tuning={"w": 0.5}, mesh=mesh,
    )
    state = eng.init(jax.random.key(0), C)
    # populate + fetch the compiled run executable
    eng._run_sharded(state, 2, adapt=False, shrink_only=True)
    fn = next(
        f for k, f in eng._fn_cache.items()
        if isinstance(k, tuple) and k[0] == 2
    )
    compiled = fn.lower(state, *eng._data_args()[0]).compile()
    ma = compiled.memory_analysis()
    # per-device figures (XLA reports the SPMD per-participant program)
    out = {
        "mesh": f"{n_chain}x{n_obs_shards}",
        "argument_bytes_per_device": int(ma.argument_size_in_bytes),
        "output_bytes_per_device": int(ma.output_size_in_bytes),
        "temp_bytes_per_device": int(ma.temp_size_in_bytes),
    }
    # the dominant observation-axis operands, analytically
    out["xt_bytes_per_device"] = 4 * d * (n // n_obs_shards)
    out["eta_bytes_per_device"] = 4 * (C // n_chain) * (n // n_obs_shards)
    return out


def main():
    n, d, C = 400_000, 48, 64
    rows = [probe(s, n, d, C) for s in (1, 2, 4, 8)]
    base = rows[0]["argument_bytes_per_device"]
    for r in rows:
        r["argument_bytes_vs_obs1"] = round(
            r["argument_bytes_per_device"] / base, 3
        )
        print(json.dumps(r), flush=True)
    print(json.dumps(
        {
            "problem": {"n": n, "d": d, "n_chains": C},
            "note": (
                "per-device compiled memory of the SAME obs-sharded "
                "freerun run executable under obs=1..8 on a virtual "
                "8-device CPU mesh; argument bytes are dominated by the "
                "X^T slab + eta, both 1/n_obs_shards."
            ),
            "rows": rows,
        },
        indent=1,
    ), flush=True)


if __name__ == "__main__":
    main()
