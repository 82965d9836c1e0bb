"""mcmcglm_tpu — a Bayesian-GLM inference engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the R package
``mcmcglm``: CGGibbs coordinate-wise slice-within-Gibbs sampling for
generalized linear models with arbitrary exponential-family response + link
and arbitrary priors on the coefficient vector, plus conjugate/NUTS/HMC/VI
cross-validation samplers, massively parallel chains over GPU device
meshes, and pooled convergence diagnostics.
"""

__version__ = "0.1.0"

from .api import mcmcglm
from .datagen import generate_glm_data, generate_normal_data
from .diagnostics import ess, split_rhat, summarize
from .engine import CGGibbs, ChainState, EngineConfig
from .formula import Design, build_design, design_from_arrays
from .freerun import FreeRunCGGibbs, FreeRunState
from .perf import (
    compare_eta_comptime,
    compare_eta_comptime_across_nvars,
    plot_eta_comptime,
)
from .results import MCMCGLM
from .sweep import mcmcglm_across_tuningparams, plot_mcmcglm_across_tuningparams
from .models import (
    BetaPrior,
    Distribution,
    Exponential,
    Family,
    Gamma,
    IIDPrior,
    Laplace,
    Link,
    MultivariateNormal,
    MVNPrior,
    Normal,
    StackedPrior,
    StudentT,
    Uniform,
    binomial,
    check_family,
    gamma,
    gaussian,
    get_link,
    inverse_gaussian,
    log_density,
    log_likelihood,
    log_potential_from_betaj,
    make_beta_prior,
    negative_binomial,
    poisson,
    register_family,
    register_link,
    update_linear_predictor,
)
from .ops import (
    SLICE_KERNELS,
    SliceKernel,
    get_slice_kernel,
    register_slice_kernel,
    slice_doubling,
    slice_elliptical,
    slice_genelliptical,
    slice_latent,
    slice_stepping_out,
)
