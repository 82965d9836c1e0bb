"""Adding a new family — the `customising` vignette, in JAX.

The reference's extension recipe is "define log_density.<family>"
(customising.Rmd:27-31,53-56).  Here the equivalent is one
``register_family`` call with a per-observation log-density function; the
example reproduces the vignette's inverse-gaussian model (which ships
built-in) by registering it under a new name from scratch.

Run: env JAX_PLATFORMS=cpu python examples/02_customising.py
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd

import mcmcglm_tpu as mg
from mcmcglm_tpu.models.families import Family, register_family
from mcmcglm_tpu.models.links import get_link


# --- the single definition a user writes (mirrors customising.Rmd:53-56) ---
def my_invgauss_logpdf(mu, y, extra):
    """statmod::dinvgauss parametrisation: mean mu, shape lam."""
    lam = jnp.asarray(extra.get("shape", 1.0), jnp.result_type(mu))
    return (
        0.5 * (jnp.log(lam) - jnp.log(2.0 * jnp.pi) - 3.0 * jnp.log(y))
        - lam * (y - mu) ** 2 / (2.0 * mu * mu * y)
    )


def my_inverse_gaussian(link="log"):
    return Family(name="my.inverse.gaussian", link=get_link(link),
                  log_density=my_invgauss_logpdf)


register_family("my.inverse.gaussian", my_inverse_gaussian)

# --- data as in customising.Rmd:36-47 (log link for positivity) -----------
rng = np.random.default_rng(42)
n = 1000
x1 = rng.exponential(0.5, n)
x2 = rng.binomial(1, 0.5, n).astype(float)
lin_pred = 0.2 + 0.5 * x1 + 0.3 * x2
mu = np.exp(lin_pred)
# inverse-gaussian draws via the reciprocal-normal transform
lam = 1.0
nu = rng.normal(size=n) ** 2
xq = mu + mu**2 * nu / (2 * lam) - mu / (2 * lam) * np.sqrt(
    4 * mu * lam * nu + mu**2 * nu**2
)
z = rng.uniform(size=n)
y = np.where(z <= mu / (mu + xq), xq, mu**2 / xq)
dat = pd.DataFrame({"Y": y, "X1": x1, "X2": x2})

fit = mg.mcmcglm(
    "Y ~ .",
    family="my.inverse.gaussian",
    data=dat,
    beta_prior=mg.Normal(0, 2),
    log_likelihood_extra_args={"shape": 1.0},
    w=0.3,
    n_samples=500,
    burnin=100,
    n_chains=4,
)
print(fit)
print(fit.quantile().to_string(index=False))
print("truth: (0.2, 0.5, 0.3)")
