"""Runtime benchmark harness: CGGibbs "update" vs naive linear predictor.

Re-design of the reference's measure_performance utilities
(R/measure_performance.R:3-187): time a fit with
``linear_predictor_calc="update"`` (O(n) per coordinate) against ``"naive"``
(full matvec per slice evaluation, O(nd)) across model widths, reproducing
the linear-vs-quadratic scaling claim (README.md:11-16) on an accelerator.

Timing protocol differences from the reference (deliberate): the reference
wall-clocks a single R call including interpretation overhead
(R/measure_performance.R:16-26); under XLA we must separate compile from
steady-state, so each timed configuration runs one untimed warm-up batch
first and reports steady-state sampling time only (plus the compile time in
a separate column for transparency).
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np

from .datagen import generate_normal_data

__all__ = [
    "compare_eta_comptime",
    "compare_eta_comptime_across_nvars",
    "plot_eta_comptime",
]


def compare_eta_comptime(
    formula: str,
    data,
    family="gaussian",
    beta_prior=None,
    log_likelihood_extra_args=None,
    slice_fn="stepping_out",
    n_samples: int = 500,
    burnin: int = 100,
    n_chains: int = 1,
    seed: int = 0,
    **tuning,
):
    """Time 'update' vs 'naive' on one dataset; returns a two-row DataFrame
    (analogue of R/measure_performance.R:3-42)."""
    import jax
    import pandas as pd

    from .engine import CGGibbs, EngineConfig
    from .formula import build_design
    from .models.families import check_family
    from .models.priors import Normal, make_beta_prior

    design = build_design(formula, data)
    fam = check_family(family)
    d = design.X.shape[1]
    prior_spec = beta_prior if beta_prior is not None else Normal(0.0, 1.0)
    prior = make_beta_prior(prior_spec, d)
    extra = dict(log_likelihood_extra_args or {})
    if fam.name == "gaussian" and "sd" not in extra:
        extra["sd"] = 1.0

    rows = []
    for calc in ("update", "naive"):
        eng = CGGibbs(
            design.X,
            design.y,
            fam,
            prior,
            extra=extra,
            config=EngineConfig(linear_predictor_calc=calc, slice_kernel=slice_fn),
            tuning=tuning,
        )
        state = eng.init(jax.random.key(seed), n_chains)
        t0 = time.perf_counter()
        state, _, _ = eng.run(state, 1)  # warm-up: triggers compile
        jax.block_until_ready(state)
        compile_time = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, betas, _ = eng.run(state, n_samples)
        jax.block_until_ready(betas)
        elapsed = time.perf_counter() - t0
        rows.append(
            {
                "time": elapsed,
                "compile_time": compile_time,
                "linear_predictor_calc": calc,
                "n_vars": d,
                "n_obs": design.X.shape[0],
                "n_samples": n_samples,
                "n_chains": n_chains,
                "beta_mean": float(np.mean(prior.mean_beta())),
                "beta_variance": float(np.mean(np.diag(prior.cov_beta()))),
                "family": fam.name,
                "slice_fn": getattr(eng.kernel, "name", None),
                **{k: float(v) for k, v in tuning.items()},
                **{k: float(v) for k, v in extra.items()},
            }
        )
    return pd.DataFrame(rows)


def _pin_cpu_backend():
    """Worker initializer for the parallel sweep: pin each worker process
    to the CPU backend BEFORE its first jax backend initialisation.  One
    accelerator cannot be time-shared by concurrent processes (each JAX
    process reserves most of a card's memory, and two that compute at once
    spoil each other's timings), so the process-parallel mode is CPU-only by
    construction — the reference's multisession workers are likewise
    plain CPU R processes (R/measure_performance.R:130-139)."""
    os.environ["JAX_PLATFORMS"] = "cpu"


def _comptime_one_nvars(args):
    """Module-level worker (picklable for spawned processes): generate the
    width-d dataset and run the update-vs-naive comparison — the analogue
    of generate_and_compare_eta_comptime (R/measure_performance.R:68)."""
    d, n, beta_prior, extra, slice_fn, n_samples, burnin, n_chains, seed, \
        tuning = args
    data = generate_normal_data(int(d), n=n, seed=seed + int(d))
    return compare_eta_comptime(
        "Y ~ .",
        data,
        family="gaussian",
        beta_prior=beta_prior,
        log_likelihood_extra_args=extra,
        slice_fn=slice_fn,
        n_samples=n_samples,
        burnin=burnin,
        n_chains=n_chains,
        seed=seed,
        **tuning,
    )


def compare_eta_comptime_across_nvars(
    n_vars: Sequence[int],
    n: int = 100,
    beta_prior=None,
    log_likelihood_extra_args=None,
    slice_fn="stepping_out",
    n_samples: int = 500,
    burnin: int = 100,
    n_chains: int = 1,
    seed: int = 0,
    parallelise: bool = False,
    n_cores: Optional[int] = None,
    **tuning,
):
    """Sweep the update-vs-naive comparison over model widths with simulated
    gaussian data (analogue of R/measure_performance.R:113-151; data
    generation matches generate_normal_data, R/measure_performance.R:46-63).

    Defaults w=0.5 if the stepping-out kernel is used with no tuning given
    (parity: R/measure_performance.R:125).

    ``parallelise=True`` fans the per-width comparisons out over worker
    PROCESSES (the reference's future multisession fan-out,
    R/measure_performance.R:130-139), each pinned to the CPU backend —
    see :func:`_pin_cpu_backend` for why device backends stay sequential.
    ``n_cores`` defaults to the ``NUMBER_OF_PROCESSORS`` env var minus one
    (reference parity, R/measure_performance.R:123) or ``os.cpu_count()-1``.
    Result rows carry a ``parallelised`` flag (R/measure_performance.R:149).
    Workers are spawned, so call from an importable ``__main__`` (the
    usual ``if __name__ == "__main__":`` multiprocessing guard).
    """
    import pandas as pd

    if slice_fn == "stepping_out" and not tuning:
        tuning = {"w": 0.5}
    jobs = [
        (int(d), n, beta_prior, log_likelihood_extra_args, slice_fn,
         n_samples, burnin, n_chains, seed, tuning)
        for d in n_vars
    ]
    if parallelise:
        import concurrent.futures as cf
        import multiprocessing as mp

        if n_cores is None:
            env = os.environ.get("NUMBER_OF_PROCESSORS")
            n_cores = (int(env) if env else (os.cpu_count() or 2)) - 1
        n_cores = max(1, min(int(n_cores), len(jobs)))
        with cf.ProcessPoolExecutor(
            max_workers=n_cores,
            mp_context=mp.get_context("spawn"),
            initializer=_pin_cpu_backend,
        ) as pool:
            frames = list(pool.map(_comptime_one_nvars, jobs))
    else:
        frames = [_comptime_one_nvars(j) for j in jobs]
    out = pd.concat(frames, ignore_index=True)
    out["parallelised"] = bool(parallelise)
    return out


def plot_eta_comptime(eta_comptime_data, facet_by: Optional[str] = None):
    """Time-vs-dimension line plot colored by update/naive — matplotlib
    analogue of R/measure_performance.R:175-187."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    df = eta_comptime_data
    facets = [None] if facet_by is None else sorted(df[facet_by].unique())
    fig, axes = plt.subplots(
        1, len(facets), figsize=(6 * len(facets), 4), squeeze=False
    )
    for ax, facet in zip(axes[0], facets):
        sub = df if facet is None else df[df[facet_by] == facet]
        for calc, color in (("update", "tab:blue"), ("naive", "tab:orange")):
            part = sub[sub.linear_predictor_calc == calc].sort_values("n_vars")
            ax.plot(part.n_vars, part.time, "o-", color=color, label=calc)
        ax.set_xlabel("Dimension of parameter vector")
        ax.set_ylabel("Computation time (seconds)")
        ax.legend(title="linear_predictor_calc")
        if facet is not None:
            ax.set_title(f"{facet_by}: {facet}")
    fig.tight_layout()
    return fig
