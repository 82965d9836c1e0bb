"""Tests for two-phase warmup (freerun.py::warmup stepout_sweeps).

Two-phase warmup runs a few full stepping-out sweeps (locating each
coordinate's scale) then switches to the shrink-only kernel with width
adaptation continuing.  Warmup draws are discarded, so the kernel mix
never touches the collected chain's law — but the FROZEN widths it
produces must still be good, and posterior recovery must stay exact.
The reference has no adaptation at all (R/mcmcglm.R:40-41).
"""

import numpy as np
import jax
import pytest

import mcmcglm_tpu as mg
from mcmcglm_tpu.datagen import generate_glm_data
from mcmcglm_tpu.freerun import FreeRunCGGibbs


def _gaussian_problem(n=400, d=4, seed=0):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    beta_true = np.linspace(1.0, -0.5, d)
    y = X @ beta_true + rng.normal(size=n)
    P = X.T @ X + np.eye(d)
    mu = np.linalg.solve(P, X.T @ y)
    sd = np.sqrt(np.diag(np.linalg.inv(P)))
    return X, y, mu, sd


def _make(X, y, d, spec_k=4, w=0.7):
    return FreeRunCGGibbs(
        X, y, "gaussian", mg.IIDPrior(mg.Normal(0.0, 1.0), d),
        extra={"sd": 1.0}, tuning={"w": w}, spec_k=spec_k,
    )


def test_twophase_warmup_posterior_recovery():
    """Default (two-phase) warmup then shrink-only sampling recovers the
    conjugate posterior exactly — the frozen widths are good."""
    X, y, mu, sd = _gaussian_problem()
    d = X.shape[1]
    fr = _make(X, y, d)
    st = fr.init(jax.random.key(1), 16)
    st, _, _ = fr.warmup(st, 100)  # default: ~10 stepping + 90 shrink-only
    st, draws, _ = fr.run(st, 400)
    post = np.asarray(draws)[:, 100:, :].reshape(-1, d)
    assert np.abs(post.mean(0) - mu).max() < 0.02
    assert np.abs(post.std(0) / sd - 1.0).max() < 0.08


def test_twophase_widths_match_full_schedule():
    """Adapted widths from the two-phase schedule land in the same place
    as the full stepping-out schedule: both are the SAME Robbins-Monro
    pull toward adapt_c x the accepted move, only the proposal mechanism
    during warmup differs."""
    X, y, _, _ = _gaussian_problem()
    d = X.shape[1]

    logws = {}
    for label, so in (("full", 60), ("twophase", None)):
        fr = _make(X, y, d)
        st = fr.init(jax.random.key(3), 32)
        st, _, _ = fr.warmup(st, 60, stepout_sweeps=so)
        logws[label] = np.asarray(st.logw)

    # per-coordinate mean log-width across chains: same target, so the
    # two schedules must agree well within a factor of ~2 (log 2 = 0.69)
    m_full = logws["full"].mean(axis=0)
    m_two = logws["twophase"].mean(axis=0)
    assert np.abs(m_full - m_two).max() < 0.6


def test_twophase_warmup_cheaper_than_full():
    """The whole point: two-phase warmup consumes fewer target
    evaluations than the full stepping-out schedule (~3 passes/coordinate
    for stepping-out vs ~1 shrink-only)."""
    X, y, _ = generate_glm_data("binomial", n=500, d=10, seed=2)
    nev = {}
    for label, so in (("full", 40), ("twophase", None)):
        fr = FreeRunCGGibbs(
            X, y, "binomial", mg.IIDPrior(mg.Normal(0, 1), 10),
            tuning={"w": 0.5}, spec_k=4,
        )
        st = fr.init(jax.random.key(4), 8)
        st, _, _ = fr.warmup(st, 40, stepout_sweeps=so)
        nev[label] = float(np.mean(np.asarray(st.nev)))
    assert nev["twophase"] < 0.8 * nev["full"]


@pytest.mark.parametrize("so", [0, 5])
def test_stepout_sweeps_edge_values(so):
    """stepout_sweeps=0 (shrink-only throughout, e.g. resuming an adapted
    state) and small values both produce working samplers."""
    X, y, mu, sd = _gaussian_problem()
    d = X.shape[1]
    fr = _make(X, y, d)
    st = fr.init(jax.random.key(5), 16)
    st, _, _ = fr.warmup(st, 40, stepout_sweeps=so)
    st, draws, _ = fr.run(st, 200)
    post = np.asarray(draws)[:, 50:, :].reshape(-1, d)
    assert np.isfinite(post).all()
    assert np.abs(post.mean(0) - mu).max() < 0.05


def test_twophase_chunked_matches_quota_threading():
    """Chunked warmup calls that thread the remaining stepping-out quota
    (scripts/baseline_configs.py pattern) behave like one big call in
    law: the stepping portion runs only in the first chunks."""
    X, y, _, _ = _gaussian_problem()
    d = X.shape[1]
    fr = _make(X, y, d)
    st = fr.init(jax.random.key(6), 8)
    total, done, chunk = 30, 0, 10
    stepout_total = fr._auto_stepout(total)
    assert stepout_total == 6
    while done < total:
        st, _, _ = fr.warmup(
            st, chunk, stepout_sweeps=max(0, stepout_total - done)
        )
        done += chunk
    st, draws, _ = fr.run(st, 100)
    assert np.isfinite(np.asarray(draws)).all()


def test_spec1_twophase_also_works():
    """The classic (spec_k=1) pass supports the per-lane switch too."""
    X, y, mu, sd = _gaussian_problem()
    d = X.shape[1]
    fr = _make(X, y, d, spec_k=1)
    st = fr.init(jax.random.key(7), 16)
    st, _, _ = fr.warmup(st, 80)
    st, draws, _ = fr.run(st, 300)
    post = np.asarray(draws)[:, 100:, :].reshape(-1, d)
    assert np.abs(post.mean(0) - mu).max() < 0.03
