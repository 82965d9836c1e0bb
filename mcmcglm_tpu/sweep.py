"""Tuning-parameter sweep harness.

Re-design of the reference's experiment utilities
(R/slice_utilities.R:43-155): run ``mcmcglm`` across a vector of one
tuning-parameter's values and compose per-run trace plots.

Where the reference parallelises with ``future`` multisession R workers
(R/slice_utilities.R:72-79), the natural device axes are: chains (already
vmapped inside each fit) and the sweep axis itself.  ``parallelise=True``
runs the sweep points as one *batched* fit by folding the tuning values
into the chain axis (every value gets ``n_chains`` chains inside a single
compiled run) — device-level parallelism instead of process-level.  This
exploits that our engine treats tuning values as traced array inputs, so
a vmap over the tuning scalar recompiles nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .api import mcmcglm
from .results import MCMCGLM

__all__ = [
    "mcmcglm_across_tuningparams",
    "plot_mcmcglm_across_tuningparams",
]


def mcmcglm_across_tuningparams(
    values: Sequence[float],
    tuning_parameter_name: str = "w",
    *,
    parallelise: bool = False,
    **mcmcglm_kwargs,
):
    """Run :func:`mcmcglm` for each value of one tuning parameter.

    Analogue of the reference's ``mcmcglm_across_tuningparams``
    (R/slice_utilities.R:43-85): ``values`` is the vector to sweep;
    every other argument is passed through to :func:`mcmcglm` (including
    other, fixed tuning parameters).  Returns a list of fits with the
    swept parameter name attached (reference attr, R/slice_utilities.R:83).

    ``parallelise=True`` folds the sweep into the chain axis of a single
    compiled run (see module docstring) rather than spawning processes
    (reference: future multisession, R/slice_utilities.R:72-79).  The
    batched path runs the lockstep CGGibbs engine with the default
    ``linear_predictor_calc="update"``; options it cannot honor
    (``engine``, ``adapt_w``, ``weights``, ``thin``, ``progress``,
    ``qslice_fun``, ``mesh``, ``sample_method``, ``linear_predictor_calc``,
    ``engine_opts``, ``chunk_size``) trigger a fallback to the sequential
    per-value path with a warning.
    """
    values = list(values)
    if parallelise:
        unsupported = {
            "engine": "auto", "adapt_w": False, "weights": None,
            "thin": 1, "progress": False, "qslice_fun": None, "mesh": None,
            "sample_method": "slice_sampling",
            "linear_predictor_calc": "update",
            "engine_opts": None, "chunk_size": 0,
        }
        bad = sorted(
            k for k, default in unsupported.items()
            if k in mcmcglm_kwargs and mcmcglm_kwargs[k] != default
        )
        if bad:
            import warnings

            warnings.warn(
                "parallelise=True (single-compile batched sweep) does not "
                f"support {bad}; falling back to the sequential per-value "
                "sweep.",
                stacklevel=2,
            )
            parallelise = False
    if parallelise:
        fits = _batched_sweep(values, tuning_parameter_name, **mcmcglm_kwargs)
    else:
        fits = []
        for v in values:
            kwargs = dict(mcmcglm_kwargs)
            kwargs[tuning_parameter_name] = v
            fits.append(mcmcglm(**kwargs))
    for fit, v in zip(fits, values):
        fit.tuning = dict(fit.tuning)
        fit.tuning[tuning_parameter_name] = v
    fits = list(fits)
    out = SweepResult(fits)
    out.tuning_parameter_name = tuning_parameter_name
    return out


class SweepResult(list):
    """A list of MCMCGLM fits tagged with the swept parameter's name."""

    tuning_parameter_name: str = "w"


def _batched_sweep(values, name, **kwargs):
    """Single-compile sweep: replicate chains per tuning value and fan the
    tuning scalar across the chain axis via one batched engine run.

    Randomness: one ``seed`` feeds the whole batched run, but the engine
    splits it per chain slot, so every (tuning value, chain) pair gets an
    independent PRNG stream — seed sharing across values does not correlate
    their draws.  Unsupported ``mcmcglm`` options are screened by the caller
    (see :func:`mcmcglm_across_tuningparams`), which falls back to the
    sequential path rather than silently dropping them.
    """
    import jax
    import jax.numpy as jnp

    from .engine import CGGibbs, EngineConfig
    from .formula import build_design, design_from_arrays
    from .models.families import check_family
    from .models.priors import Normal, make_beta_prior
    from .ops.slice_kernels import get_slice_kernel

    n_samples = kwargs.get("n_samples", 500)
    burnin = kwargs.get("burnin", 100)
    n_chains = kwargs.get("n_chains", 1)
    seed = kwargs.get("seed", 0)
    fam = check_family(kwargs.get("family", "gaussian"))
    formula = kwargs.get("formula")
    if formula is not None:
        design = build_design(formula, kwargs["data"])
    else:
        design = design_from_arrays(
            kwargs["X"], kwargs["y"], columns=kwargs.get("columns"),
            add_intercept=kwargs.get("add_intercept", False),
        )
    d = design.X.shape[1]
    prior = make_beta_prior(kwargs.get("beta_prior") or Normal(0.0, 1.0), d)
    extra = dict(kwargs.get("log_likelihood_extra_args") or {})
    if fam.name == "gaussian" and "sd" not in extra:
        extra["sd"] = 1.0
    kernel = get_slice_kernel(kwargs.get("slice_fn", "stepping_out"))
    fixed_tuning = {
        k: v
        for k, v in kwargs.items()
        if k in getattr(kernel, "required", ()) and k != name
    }

    V = len(values)
    # tuning scalar varies along the batched chain axis: (V * n_chains,)
    tuned = np.repeat(np.asarray(values, dtype=np.float64), n_chains)

    eng = CGGibbs(
        design.X, design.y, fam, prior, extra=extra,
        config=EngineConfig(
            slice_kernel=kernel, dtype=kwargs.get("dtype", jnp.float32)
        ),
        tuning=fixed_tuning,
        chain_tuning_names=(name,),
        offset=design.offset,
    )
    betas, n_evals, _ = eng.sample(
        jax.random.key(seed),
        n_samples,
        n_chains=V * n_chains,
        chain_tuning={name: jnp.asarray(tuned, jnp.float32)},
    )
    fits = []
    for i, v in enumerate(values):
        sl = slice(i * n_chains, (i + 1) * n_chains)
        fits.append(
            MCMCGLM(
                beta=np.asarray(betas[sl]),
                columns=list(design.columns),
                family_name=fam.name,
                burnin=burnin,
                sample_method="slice_sampling",
                slice_kernel=kernel.name,
                tuning={**fixed_tuning, name: v},
                n_evals=np.asarray(n_evals[sl]),
                model_matrix=design.X,
                response=design.y,
                formula=design.formula,
            )
        )
    return fits


def plot_mcmcglm_across_tuningparams(fits, ncols: Optional[int] = None):
    """Grid of trace plots titled by tuning value — matplotlib analogue of
    the reference's patchwork composition (R/slice_utilities.R:90-155)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    name = getattr(fits, "tuning_parameter_name", "w")
    V = len(fits)
    ncols = ncols or min(2, V)
    nrows = int(np.ceil(V / ncols))
    d = fits[0].d
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(5 * ncols, 2.2 * nrows), squeeze=False
    )
    for i, fit in enumerate(fits):
        ax = axes[i // ncols][i % ncols]
        iters = np.arange(fit.beta.shape[1])
        for p in range(d):
            for c in range(fit.n_chains):
                ax.plot(iters, fit.beta[c, :, p], lw=0.6, alpha=0.8)
        ax.set_title(f"{name} = {fit.tuning.get(name)}", fontsize=10)
        ax.set_xlabel("iteration")
    for i in range(V, nrows * ncols):
        axes[i // ncols][i % ncols].set_visible(False)
    fig.tight_layout()
    return fig
