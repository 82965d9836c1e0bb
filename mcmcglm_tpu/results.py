"""The fit-result container and its methods.

Re-design of the reference's S3 class ``mcmcglm``
(R/mcmcglm_methods.R): ``samples()``, ``coef()``, ``quantile()``,
``trace_plot()``, ``print`` — plus chain-aware extensions the reference
lacks (multiple chains, ESS, split-R-hat).

Parity decisions (SURVEY.md §7):
  * burn-in flag: a row is burn-in iff ``iteration <= burnin`` (iteration 0
    is the init draw).  The reference flags ``iteration <= burnin + 1``
    (off-by-one, R/mcmcglm.R:198) — deliberately not copied.
  * ``quantile()`` summarises the NON-burn-in samples, as its own
    documentation states (R/mcmcglm_methods.R:90); the reference
    implementation buggily summarises the burn-in subset
    (R/mcmcglm_methods.R:137) — deliberately not copied.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

import numpy as np

from .diagnostics import ess as _ess
from .diagnostics import split_rhat as _split_rhat

__all__ = ["MCMCGLM"]


def _jnp_float():
    """float64 when x64 is enabled, else float32 — avoids jax truncation
    warnings when computing host-side summaries on a f32-only backend."""
    import jax
    import jax.numpy as jnp

    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


@dataclasses.dataclass
class MCMCGLM:
    """Result of a :func:`mcmcglm_tpu.mcmcglm` fit.

    ``beta`` holds raw samples of shape (chains, n_samples + 1, d) where
    row 0 along the draws axis is the init draw (reference iteration-0
    bookkeeping, R/mcmcglm.R:193-198,222).
    """

    beta: np.ndarray  # (C, K+1, d)
    columns: list  # d parameter names
    family_name: str
    burnin: int
    sample_method: str
    slice_kernel: Optional[str]
    tuning: Mapping[str, Any]
    n_evals: Optional[np.ndarray] = None  # (C, K) slice evaluations per sweep
    model_matrix: Optional[np.ndarray] = None
    response: Optional[np.ndarray] = None
    formula: Optional[str] = None
    call: Optional[str] = None
    elapsed_seconds: Optional[float] = None
    family: Optional[Any] = None  # the fitted Family object (keeps the link)
    extra: Optional[Mapping[str, Any]] = None  # log_likelihood_extra_args
    offset: Optional[np.ndarray] = None  # (n,) fixed eta offset (formula offset())

    # -- core accessors ----------------------------------------------------

    @property
    def n_chains(self) -> int:
        return self.beta.shape[0]

    @property
    def n_iterations(self) -> int:
        return self.beta.shape[1] - 1

    @property
    def d(self) -> int:
        return self.beta.shape[2]

    def _burnin_mask(self):
        iters = np.arange(self.beta.shape[1])
        return iters <= self.burnin

    def post_burnin(self) -> np.ndarray:
        """Samples after burn-in: (C, K - burnin, d)."""
        return self.beta[:, self.burnin + 1 :, :]

    def samples(self):
        """Long-format DataFrame of all draws — the analogue of the
        reference's ``samples()`` / ``beta_samples`` data.frame
        (R/mcmcglm_methods.R:43-50): one row per (chain, iteration) with
        parameter columns plus ``iteration`` and ``burnin`` flags, plus a
        ``chain`` column (the reference is single-chain)."""
        import pandas as pd

        C, K1, d = self.beta.shape
        burn = self._burnin_mask()
        frames = []
        for c in range(C):
            df = pd.DataFrame(self.beta[c], columns=self.columns)
            df["iteration"] = np.arange(K1)
            df["burnin"] = burn
            df["chain"] = c
            frames.append(df)
        return pd.concat(frames, ignore_index=True)

    def coef(self):
        """Posterior mean over non-burn-in draws pooled across chains —
        the reference's ``beta_mean`` / ``coef()`` (R/mcmcglm.R:276-280,
        R/mcmcglm_methods.R:84-86)."""
        import pandas as pd

        post = self.post_burnin().reshape(-1, self.d)
        return pd.Series(post.mean(axis=0), index=self.columns, name="beta_mean")

    def quantile(self, probs: Sequence[float] = (0.025, 0.5, 0.975)):
        """Per-parameter mean + quantiles over NON-burn-in draws, wide
        format (var × statistic) like the reference's quantile method
        (R/mcmcglm_methods.R:124-158, with its burn-in filter bug fixed)."""
        import pandas as pd

        post = self.post_burnin().reshape(-1, self.d)
        out = {"var": list(self.columns), "mean": post.mean(axis=0)}
        for p in probs:
            out[f"q_{str(p).replace('0.', '')}"] = np.quantile(post, p, axis=0)
        return pd.DataFrame(out)

    def summary(self, probs: Sequence[float] = (0.025, 0.5, 0.975)):
        """quantile() plus per-parameter ESS and split-R-hat columns."""
        from .diagnostics import summarize

        return summarize(self.post_burnin(), columns=self.columns, probs=probs)

    # -- posterior prediction (beyond the reference) -----------------------

    def predict(self, X_new=None, kind: str = "mean", n_draws: int = 0, seed: int = 0,
                offset=None):
        """Posterior draws of the GLM mean mu = linkinv(X beta) at new
        design points (the reference has no predict method).

        kind="link" returns draws of eta; "mean" returns linkinv(eta).
        Returns an array of shape (n_posterior_draws, n_new) using all
        post-burn-in draws (or a random subsample of ``n_draws`` > 0).
        A model fitted with a formula ``offset()`` term applies the stored
        offset when predicting on the training matrix; pass ``offset=`` for
        new design points.
        """

        if X_new is None:
            if self.model_matrix is None:
                raise ValueError("no stored model matrix; pass X_new")
            X_new = self.model_matrix
            if offset is None:
                offset = self.offset
        X_new = np.asarray(X_new, dtype=np.float64)
        post = self.post_burnin().reshape(-1, self.d)
        if n_draws and n_draws < post.shape[0]:
            idx = np.random.default_rng(seed).choice(
                post.shape[0], n_draws, replace=False
            )
            post = post[idx]
        eta = post @ X_new.T  # (draws, n_new)
        if offset is not None:
            eta = eta + np.asarray(offset, np.float64)[None, :]
        if kind == "link":
            return eta
        if kind != "mean":
            raise ValueError("kind must be 'mean' or 'link'")
        fam = self.family
        if fam is None:
            from .models.families import check_family

            fam = check_family(self.family_name)  # default link fallback
        import jax.numpy as jnp

        return np.asarray(fam.linkinv(jnp.asarray(eta, _jnp_float())))

    # -- model criticism (beyond the reference) ----------------------------

    def _pointwise_loglik(self, n_draws: int = 1000, seed: int = 0):
        """(S, n) per-observation log densities over posterior draws."""
        if self.model_matrix is None or self.response is None or self.family is None:
            raise ValueError("fit lacks stored data/family; cannot compute")
        import jax.numpy as jnp

        post = self.post_burnin().reshape(-1, self.d)
        if n_draws and n_draws < post.shape[0]:
            idx = np.random.default_rng(seed).choice(post.shape[0], n_draws, False)
            post = post[idx]
        eta = post @ np.asarray(self.model_matrix, np.float64).T  # (S, n)
        if self.offset is not None:
            eta = eta + np.asarray(self.offset, np.float64)[None, :]
        ft = _jnp_float()
        ld = self.family.log_density_eta(
            jnp.asarray(eta, ft),
            jnp.asarray(np.asarray(self.response, np.float64), ft),
            dict(self.extra or {}),
        )
        return np.asarray(ld, np.float64)

    def waic(self, n_draws: int = 1000, seed: int = 0):
        """Widely Applicable Information Criterion (Watanabe 2010; gelman
        et al. formulation): elpd_waic = lppd - p_waic with
        p_waic = sum_i Var_s[log p(y_i | theta_s)].

        Returns dict(elpd_waic, p_waic, waic, se).  Model-criticism tooling
        absent from the reference entirely."""
        ld = self._pointwise_loglik(n_draws, seed)  # (S, n)
        S = ld.shape[0]
        m = ld.max(axis=0)
        lppd_i = m + np.log(np.exp(ld - m).mean(axis=0))
        p_i = ld.var(axis=0, ddof=1)
        elpd_i = lppd_i - p_i
        n = ld.shape[1]
        return {
            "elpd_waic": float(elpd_i.sum()),
            "p_waic": float(p_i.sum()),
            "waic": float(-2.0 * elpd_i.sum()),
            "se": float(np.sqrt(n * elpd_i.var(ddof=1))),
        }

    def loo(self, n_draws: int = 1000, seed: int = 0):
        """Importance-sampling leave-one-out expected log predictive
        density with truncated weights (Ionides 2008 truncation at
        S^{3/4} * mean weight; a robust non-Pareto-smoothed PSIS-LOO
        stand-in).  Returns dict(elpd_loo, p_loo, se)."""
        ld = self._pointwise_loglik(n_draws, seed)  # (S, n)
        S = ld.shape[0]
        lw = -ld  # log importance ratios 1/p(y_i | theta_s)
        lw = lw - lw.max(axis=0)
        w = np.exp(lw)
        wbar = w.mean(axis=0)
        w = np.minimum(w, wbar * S ** 0.75)  # truncate extreme weights
        w /= w.sum(axis=0)
        # elpd_loo_i = log( sum_s w_s p(y_i|theta_s) )
        m = ld.max(axis=0)
        elpd_i = m + np.log((w * np.exp(ld - m)).sum(axis=0))
        lppd_m = ld.max(axis=0)
        lppd_i = lppd_m + np.log(np.exp(ld - lppd_m).mean(axis=0))
        n = ld.shape[1]
        return {
            "elpd_loo": float(elpd_i.sum()),
            "p_loo": float((lppd_i - elpd_i).sum()),
            "se": float(np.sqrt(n * elpd_i.var(ddof=1))),
        }

    # -- diagnostics beyond the reference ---------------------------------

    def ess(self) -> np.ndarray:
        """Bulk ESS per parameter over non-burn-in draws."""
        return _ess(self.post_burnin())

    def rhat(self) -> np.ndarray:
        """Split-R-hat per parameter over non-burn-in draws."""
        return _split_rhat(self.post_burnin())

    def ess_per_second(self) -> Optional[np.ndarray]:
        if self.elapsed_seconds is None or self.elapsed_seconds <= 0:
            return None
        return self.ess() / self.elapsed_seconds

    # -- plotting ----------------------------------------------------------

    def trace_plot(self, samples_drop: Optional[int] = None, ax=None):
        """Faceted per-parameter trace plot colored by burn-in status —
        matplotlib analogue of the reference's ggplot trace_plot
        (R/mcmcglm_methods.R:195-220).  ``samples_drop`` defaults to half
        the burn-in (R/mcmcglm_methods.R:201)."""
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        if samples_drop is None:
            samples_drop = int(np.ceil(self.burnin / 2))
        iters = np.arange(self.beta.shape[1])
        keep = iters > samples_drop
        burn = self._burnin_mask()

        d = self.d
        ncols = min(3, d)
        nrows = int(np.ceil(d / ncols))
        fig, axes = plt.subplots(
            nrows, ncols, figsize=(4 * ncols, 2.5 * nrows), squeeze=False
        )
        for p in range(d):
            ax_p = axes[p // ncols][p % ncols]
            for c in range(self.n_chains):
                for is_burn, color in ((True, "tab:red"), (False, "tab:blue")):
                    mask = keep & (burn == is_burn)
                    # include boundary point so segments connect
                    ax_p.plot(
                        iters[mask],
                        self.beta[c, mask, p],
                        color=color,
                        lw=0.7,
                        alpha=0.8,
                    )
            ax_p.set_title(f"Var: {self.columns[p]}", fontsize=9)
            ax_p.set_xlabel("iteration")
        for p in range(d, nrows * ncols):
            axes[p // ncols][p % ncols].set_visible(False)
        fig.tight_layout()
        return fig

    # -- printing ----------------------------------------------------------

    def __repr__(self):
        """Mirrors the reference's print method: call + mean of parameter
        samples (R/mcmcglm_methods.R:2-9)."""
        coefs = self.coef()
        lines = ["Object of class 'MCMCGLM'", ""]
        if self.call:
            lines += [f"Call:  {self.call}", ""]
        lines += [
            f"family: {self.family_name}  method: {self.sample_method}"
            + (f" ({self.slice_kernel})" if self.slice_kernel else ""),
            f"chains: {self.n_chains}  iterations: {self.n_iterations}  "
            f"burnin: {self.burnin}",
            "",
            "Average of parameter samples:",
            coefs.to_string(),
        ]
        return "\n".join(lines)
