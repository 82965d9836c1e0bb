"""Families and priors tour — the `pospkg` vignette, in JAX.

Covers the scenarios of the reference's main vignette
(vignettes/pospkg.Rmd): gaussian/identity, binomial/logit, binomial/probit,
poisson/log, negative-binomial, with iid, strongly-misspecified, list and
multivariate-normal priors, plus the normal-normal conjugate cross-check.

Run: env JAX_PLATFORMS=cpu python examples/01_families_and_priors.py
"""

import numpy as np
import pandas as pd

import mcmcglm_tpu as mg

rng = np.random.default_rng(42)
n = 1000
x1 = rng.normal(size=n)
x2 = rng.binomial(1, 0.5, n).astype(float)
lin_pred = 1.0 + 1.5 * x1 + 2.0 * x2
common = dict(n_samples=500, burnin=100, n_chains=4, seed=0)


def show(title, fit):
    print(f"\n== {title}")
    print(fit.quantile().to_string(index=False))
    print("ess:", np.round(fit.ess(), 0), "rhat:", np.round(fit.rhat(), 3))


# gaussian / identity (pospkg.Rmd:39-77)
dat = pd.DataFrame({"Y": rng.normal(lin_pred, 1.0), "X1": x1, "X2": x2})
show("gaussian/identity", mg.mcmcglm("Y ~ .", "gaussian", dat, mg.Normal(0, 1), w=0.5, **common))

# binomial / logit (pospkg.Rmd:79-86)
dat["Y"] = rng.binomial(1, 1 / (1 + np.exp(-lin_pred))).astype(float)
show("binomial/logit", mg.mcmcglm("Y ~ .", "binomial", dat, mg.Normal(0, 1), w=0.8, **common))

# binomial / probit (pospkg.Rmd:101-108)
from scipy.stats import norm

dat["Y"] = rng.binomial(1, norm.cdf(lin_pred)).astype(float)
show(
    "binomial/probit",
    mg.mcmcglm("Y ~ .", mg.binomial(link="probit"), dat, mg.Normal(0, 1), w=0.8, **common),
)

# poisson / log (pospkg.Rmd:123-130)
dat["Y"] = rng.poisson(np.exp(np.clip(lin_pred, -10, 10))).astype(float)
show("poisson/log", mg.mcmcglm("Y ~ .", "poisson", dat, mg.Normal(0, 1), w=0.3, **common))

# negative binomial (pospkg.Rmd:149-156; size=1 like the reference's method)
mu = np.exp(np.clip(lin_pred, -10, 10))
dat["Y"] = rng.negative_binomial(1, 1 / (1 + mu)).astype(float)
show(
    "negative.binomial/log",
    mg.mcmcglm("Y ~ .", "negative.binomial", dat, mg.Normal(0, 2), w=0.5, **common),
)

# prior pull: strongly misspecified N(1000, 1) prior (pospkg.Rmd:183)
dat["Y"] = rng.normal(lin_pred, 1.0)
fit = mg.mcmcglm("Y ~ .", "gaussian", dat, mg.Normal(1000.0, 1.0), w=0.5, **common)
show("misspecified prior N(1000,1) — expect pull away from truth", fit)

# per-coordinate list of priors (pospkg.Rmd:194-204)
fit = mg.mcmcglm(
    "Y ~ .", "gaussian", dat,
    beta_prior=[mg.Normal(0, 1), mg.Gamma(1, 1), mg.Exponential(2.0)],
    w=0.5, **common,
)
show("list of marginal priors", fit)

# correlated MVN prior (pospkg.Rmd:224-236)
cov = np.array([[1.0, 0.5, 0.0], [0.5, 1.0, 0.0], [0.0, 0.0, 1.0]])
fit = mg.mcmcglm(
    "Y ~ .", "gaussian", dat,
    beta_prior=mg.MultivariateNormal(np.zeros(3), cov), w=0.5, **common,
)
show("multivariate normal prior", fit)

# conjugate cross-check (pospkg.Rmd:339-348)
fit = mg.mcmcglm("Y ~ .", "gaussian", dat, mg.Normal(0, 1),
                 sample_method="normal-normal", **common)
show("normal-normal conjugate oracle", fit)
