"""Tests for the K-speculative freerun pass (freerun.py::_pass_spec).

The speculative engine must be *identical in law* to the spec_k=1
automaton: it generates the shrinkage all-rejections proposal chain up
front (the interval recursion is deterministic given the uniforms) and
selects the first acceptor, so the committed draw — and the per-coordinate
ALGORITHMIC evaluation count — have exactly the single-proposal kernel's
distribution.  Validation mirrors the reference package's strategy
(known-truth + conjugate oracle, SURVEY.md §4) plus an eval-count
law-equivalence check.
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


@pytest.mark.parametrize("shrink_only", [True, False])
@pytest.mark.parametrize("spec_k", [2, 4])
def test_spec_gaussian_conjugate_recovery(shrink_only, spec_k):
    X, y, mu, sd = _gaussian_problem()
    d = X.shape[1]
    fr = FreeRunCGGibbs(
        X, y, "gaussian", mg.IIDPrior(mg.Normal(0.0, 1.0), d),
        extra={"sd": 1.0}, tuning={"w": 0.7}, shrink_only=shrink_only,
        spec_k=spec_k,
    )
    st = fr.init(jax.random.key(1), 16)
    st, _, _ = fr.warmup(st, 100)
    st, draws, _ = fr.run(st, 400)
    post = np.asarray(draws)[:, 100:, :].reshape(-1, d)
    assert np.abs(post.mean(0) - mu).max() < 0.02
    assert np.abs(post.std(0) / sd - 1.0).max() < 0.08


def test_spec_eval_count_matches_classic_in_law():
    """nev counts algorithmic evaluations; their per-coordinate mean must
    agree between spec_k=1 and spec_k=4 (same kernel, same law)."""
    X, y, _ = generate_glm_data("binomial", n=600, d=12, seed=0)
    rates = []
    for K in (1, 4):
        eng = FreeRunCGGibbs(
            X, y, "binomial", mg.IIDPrior(mg.Normal(0, 1), 12),
            tuning={"w": 0.5}, spec_k=K,
        )
        st = eng.init(jax.random.key(0), 16)
        st, _, _ = eng.warmup(st, 60)
        nev0 = np.asarray(st.nev).copy()
        st, _, nev = eng.run(st, 200)
        rates.append((np.asarray(nev)[:, -1] - nev0).mean() / (200 * 12))
    assert abs(rates[0] - rates[1]) / rates[0] < 0.05


def test_spec_matches_classic_posterior_binomial():
    X, y, _ = generate_glm_data("binomial", n=500, d=6, seed=3)
    pr = mg.IIDPrior(mg.Normal(0.0, 1.0), 6)
    posts = []
    for K in (1, 4):
        fr = FreeRunCGGibbs(X, y, "binomial", pr, tuning={"w": 0.5}, spec_k=K)
        b, _, _ = fr.sample(jax.random.key(2), 500, n_chains=8)
        posts.append(b[:, 150:, :].reshape(-1, 6))
    p1, p2 = posts
    assert np.abs(p1.mean(0) - p2.mean(0)).max() < 0.05
    assert np.abs(p1.std(0) / p2.std(0) - 1.0).max() < 0.15


def test_spec_per_obs_cache():
    """The per-observation cache path recomputes the committed densities
    (the battery is reduction-fused); posterior must still be exact."""
    X, y, mu, sd = _gaussian_problem(n=300, d=3, seed=2)
    fr = FreeRunCGGibbs(
        X, y, "gaussian", mg.IIDPrior(mg.Normal(0.0, 1.0), 3),
        extra={"sd": 1.0}, tuning={"w": 0.7}, eval_cache="per_obs", spec_k=3,
    )
    st = fr.init(jax.random.key(0), 16)
    st, _, _ = fr.warmup(st, 80)
    st, draws, _ = fr.run(st, 300)
    post = np.asarray(draws)[:, 80:, :].reshape(-1, 3)
    assert np.abs(post.mean(0) - mu).max() < 0.03
    assert np.abs(post.std(0) / sd - 1.0).max() < 0.1


def test_spec_stacked_prior_and_thinned():
    X, y, _, _ = _gaussian_problem(n=300, d=3, seed=2)
    fr = FreeRunCGGibbs(
        X, y, "gaussian",
        mg.StackedPrior([mg.Normal(0, 1), mg.Normal(1, 2), mg.Exponential(1.0)]),
        extra={"sd": 1.0}, tuning={"w": 0.7}, spec_k=4,
    )
    st = fr.init(jax.random.key(3), 4)
    st, mom, draws, _ = fr.run_thinned(st, n_outer=20, thin=2)
    assert np.isfinite(np.asarray(draws)).all()
    assert float(np.asarray(mom.count).min()) == 40.0


def test_spec_k_validation():
    X, y, _, _ = _gaussian_problem(n=100, d=3)
    with pytest.raises(ValueError, match="spec_k"):
        FreeRunCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), 3),
            extra={"sd": 1.0}, tuning={"w": 0.5}, spec_k=0,
        )


class TestXlaBattery:
    """The K-proposal battery (the XLA (C, K, n) broadcast + reduce in
    ops/freerun_passes.py::run_pass_spec): its commit keeps eta and the
    scalar log-likelihood cache consistent with the committed beta, its
    relative densities are exact, and it samples the right posterior."""

    @pytest.mark.parametrize("C", [16, 13])
    @pytest.mark.parametrize("weighted", [False, True])
    @pytest.mark.parametrize("K", [2, 4])
    def test_pass_commit_consistent(self, C, weighted, K):
        """After spec passes, eta == X beta and the cached scalar sum is
        the fresh reduction at eta (the accepted proposal's own sum)."""
        import jax.numpy as jnp

        X, y, _ = generate_glm_data("binomial", n=500, d=8, seed=1)
        w = np.linspace(0.5, 2.0, 500) if weighted else None
        eng = FreeRunCGGibbs(
            X, y, "binomial", mg.IIDPrior(mg.Normal(0, 1), 8),
            tuning={"w": 0.5}, spec_k=K, eval_cache="scalar",
            obs_weights=w,
        )
        st = eng.init(jax.random.key(3), C)
        beta0 = np.asarray(st.beta).copy()
        st, _, _ = eng.run(st, 2)
        beta = np.asarray(st.beta, np.float64)
        assert np.abs(beta - beta0).max() > 0  # chains committed moves
        eta_want = beta @ np.asarray(X, np.float64).T
        np.testing.assert_allclose(np.asarray(st.eta), eta_want, atol=2e-4)
        ld0_want = eng.reduce_fn(eng._ld_eta(st.eta, eng.y, eng.extra))
        np.testing.assert_allclose(np.asarray(st.ld0), np.asarray(ld0_want),
                                   rtol=1e-5)

    @pytest.mark.parametrize("family,link", [
        ("gaussian", "identity"), ("binomial", "logit"),
        ("binomial", "cloglog"), ("poisson", "log"),
        ("negative.binomial", "log"), ("Gamma", "log"),
        ("inverse.gaussian", "log"),
    ])
    def test_relative_density_differences_exact(self, family, link):
        """The battery compares RELATIVE densities (eta-independent
        constants dropped); their differences across eta must equal the
        absolute densities' differences (float64 reference)."""
        import jax.numpy as jnp

        from mcmcglm_tpu.models.families import FAMILIES

        fam = FAMILIES[family](link)
        rng = np.random.default_rng(0)
        n = 400
        e0 = 0.3 * rng.normal(size=n)
        e1 = e0 + 0.1 * rng.normal(size=n)
        mean = np.asarray(fam.linkinv(jnp.asarray(e0)))
        y = ((rng.uniform(size=n) < mean).astype(float)
             if family == "binomial"
             else rng.poisson(mean).astype(float)
             if family in ("poisson", "negative.binomial")
             else mean + rng.normal(size=n) if family == "gaussian"
             else mean * rng.gamma(4.0, 0.25, size=n))
        extra = {"sd": 1.0} if family == "gaussian" else {}
        rel = [np.sum(np.asarray(fam.log_density_eta_rel(
            jnp.asarray(e, jnp.float32), jnp.asarray(y, jnp.float32),
            extra), np.float64)) for e in (e0, e1)]
        ab = [np.sum(np.asarray(fam.log_density_eta(
            jnp.asarray(e, jnp.float64), jnp.asarray(y, jnp.float64),
            extra))) for e in (e0, e1)]
        scale = max(1.0, np.sum(np.abs(ab[0])))
        assert abs((rel[1] - rel[0]) - (ab[1] - ab[0])) < 2e-6 * scale

    def test_battery_posterior_matches_oracle(self):
        X, y, mu, sd = _gaussian_problem(n=400, d=4, seed=0)
        fr = FreeRunCGGibbs(
            X, y, "gaussian", mg.IIDPrior(mg.Normal(0.0, 1.0), 4),
            extra={"sd": 1.0}, tuning={"w": 0.7}, spec_k=4,
            eval_cache="scalar",
        )
        st = fr.init(jax.random.key(1), 16)
        st, _, _ = fr.warmup(st, 100)
        st, draws, _ = fr.run(st, 400)
        post = np.asarray(draws)[:, 100:, :].reshape(-1, 4)
        assert np.abs(post.mean(0) - mu).max() < 0.02
        assert np.abs(post.std(0) / sd - 1.0).max() < 0.08

    def test_battery_weighted_obs(self):
        """obs_weights fold into the battery's reduction: weight 2 on a
        row is the same posterior as that row duplicated."""
        X, y, _, _ = _gaussian_problem(n=300, d=3, seed=2)
        w = np.ones(300); w[:150] = 2.0
        Xd = np.concatenate([X, X[:150]]); yd = np.concatenate([y, y[:150]])
        posts = []
        for Xi, yi, wi in ((X, y, w), (Xd, yd, None)):
            fr = FreeRunCGGibbs(
                Xi, yi, "gaussian", mg.IIDPrior(mg.Normal(0.0, 1.0), 3),
                extra={"sd": 1.0}, tuning={"w": 0.7}, spec_k=3,
                eval_cache="scalar", obs_weights=wi,
            )
            st = fr.init(jax.random.key(0), 8)
            st, _, _ = fr.warmup(st, 60)
            st, draws, _ = fr.run(st, 250)
            posts.append(np.asarray(draws)[:, 60:, :].reshape(-1, 3))
        assert np.abs(posts[0].mean(0) - posts[1].mean(0)).max() < 0.05
        assert np.abs(posts[0].std(0) / posts[1].std(0) - 1.0).max() < 0.15

    @pytest.mark.parametrize("impl", ["triton", "pallas3", "nope"])
    def test_battery_validation(self, impl):
        """Only the XLA battery exists: 'auto' and 'xla' construct, the
        removed fused batteries are refused by name."""
        X, y, _, _ = _gaussian_problem(n=100, d=3)
        kw = dict(extra={"sd": 1.0}, tuning={"w": 0.5}, spec_k=4)
        pr = mg.IIDPrior(mg.Normal(0, 1), 3)
        for ok in ("auto", "xla"):
            FreeRunCGGibbs(X, y, "gaussian", pr, battery_impl=ok, **kw)
        with pytest.raises(ValueError, match="battery_impl"):
            FreeRunCGGibbs(X, y, "gaussian", pr, battery_impl=impl, **kw)


class TestSpecInLaw:
    """The K-proposal pass samples the same posterior as the classic
    one-evaluation pass: same evaluation counts per coordinate and
    agreeing moments."""

    @pytest.mark.parametrize("family,w,d", [
        ("binomial", 0.5, 6), ("poisson", 0.3, 5),
    ])
    def test_spec_matches_classic_in_law(self, family, w, d):
        X, y, _ = generate_glm_data(family, n=500, d=d, seed=3)
        pr = mg.IIDPrior(mg.Normal(0.0, 1.0), d)
        posts, rates = [], []
        for K in (1, 4):
            fr = FreeRunCGGibbs(
                X, y, family, pr, tuning={"w": w}, spec_k=K,
                eval_cache="scalar", adapt_c=40.0,
            )
            st = fr.init(jax.random.key(0), 16)
            st, _, _ = fr.warmup(st, 60)
            nev0 = np.asarray(st.nev).copy()
            st, draws, nev = fr.run(st, 250)
            posts.append(np.asarray(draws)[:, 60:, :].reshape(-1, d))
            rates.append((np.asarray(nev)[:, -1] - nev0).mean() / (250 * d))
        assert abs(rates[0] - rates[1]) / rates[0] < 0.06
        assert np.abs(posts[0].mean(0) - posts[1].mean(0)).max() < 0.06
        assert np.abs(posts[0].std(0) / posts[1].std(0) - 1.0).max() < 0.15

    def test_spec_odd_chain_count(self):
        X, y, _ = generate_glm_data("binomial", n=300, d=5, seed=1)
        fr = FreeRunCGGibbs(
            X, y, "binomial", mg.IIDPrior(mg.Normal(0.0, 1.0), 5),
            tuning={"w": 0.5}, spec_k=4, eval_cache="scalar",
        )
        st = fr.init(jax.random.key(0), 12)
        assert st.eta.shape == (12, 300)  # plain (C, n) layout, no padding
        st, _, _ = fr.warmup(st, 30)
        st, draws, _ = fr.run(st, 80)
        assert np.isfinite(np.asarray(draws)).all()


class TestBatteryNaNSafety:
    """Gamma and inverse-gaussian log densities contain log(y) / 1/y terms
    that go NaN/inf for wild proposals; the battery must keep every chain
    moving and finite."""

    def _gamma_problem(self, n=300, d=4, seed=0):
        rng = np.random.default_rng(seed)
        X = np.column_stack(
            [np.ones(n), rng.normal(size=(n, d - 1)) / np.sqrt(d - 1)]
        )
        beta_true = np.linspace(0.8, -0.4, d)
        mu = np.exp(X @ beta_true)
        y = rng.gamma(shape=2.0, scale=mu / 2.0)
        return X, y, beta_true

    def test_gamma_battery_no_nan_freeze(self):
        from mcmcglm_tpu.models.families import gamma

        X, y, beta_true = self._gamma_problem()
        d = X.shape[1]
        fr = FreeRunCGGibbs(
            X, y, gamma("log"), mg.IIDPrior(mg.Normal(0.0, 2.0), d),
            extra={"shape": 2.0}, tuning={"w": 0.5}, spec_k=4,
            eval_cache="scalar",
        )
        st = fr.init(jax.random.key(0), 16)
        init_beta = np.asarray(st.beta).copy()
        st, _, _ = fr.warmup(st, 40)
        st, draws, _ = fr.run(st, 150)
        draws = np.asarray(draws)
        assert np.isfinite(draws).all()
        # chains actually moved (a NaN comparison would freeze them)
        assert np.abs(draws[:, -1, :] - init_beta).max() > 0.01
        post = draws[:, 50:, :].reshape(-1, d)
        assert np.abs(post.mean(0) - beta_true).max() < 0.25

    def test_gamma_battery_matches_classic_posterior(self):
        from mcmcglm_tpu.models.families import gamma

        X, y, _ = self._gamma_problem()
        d = X.shape[1]
        posts = []
        for K in (1, 4):
            fr = FreeRunCGGibbs(
                X, y, gamma("log"), mg.IIDPrior(mg.Normal(0.0, 2.0), d),
                extra={"shape": 2.0}, tuning={"w": 0.5}, spec_k=K,
                eval_cache="scalar", adapt_c=40.0,
            )
            st = fr.init(jax.random.key(3), 16)
            st, _, _ = fr.warmup(st, 60)
            st, draws, _ = fr.run(st, 250)
            posts.append(np.asarray(draws)[:, 80:, :].reshape(-1, d))
        assert np.abs(posts[0].mean(0) - posts[1].mean(0)).max() < 0.08
        assert np.abs(posts[0].std(0) / posts[1].std(0) - 1.0).max() < 0.2

    def test_invgauss_battery_no_nan(self):
        from mcmcglm_tpu.models.families import inverse_gaussian

        rng = np.random.default_rng(1)
        n, d = 200, 3
        X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
        y = rng.wald(mean=1.0, scale=2.0, size=n)
        fr = FreeRunCGGibbs(
            X, y, inverse_gaussian("log"), mg.IIDPrior(mg.Normal(0.0, 1.0), d),
            extra={"dispersion": 0.5}, tuning={"w": 0.5}, spec_k=4,
            eval_cache="scalar",
        )
        st = fr.init(jax.random.key(0), 8)
        st, _, _ = fr.warmup(st, 30)
        st, draws, _ = fr.run(st, 60)
        assert np.isfinite(np.asarray(draws)).all()


def test_warmup_passes_bitwise_matches_warmup():
    """The pass-bounded warmup (pod-scale dispatch mode) executes the exact
    same pass sequence as one monolithic warmup call: final state bitwise
    identical, regardless of how the pass budget slices the run."""
    X, y, _ = generate_glm_data("binomial", n=400, d=6, seed=5)
    d = X.shape[1]

    def make():
        return FreeRunCGGibbs(
            X, y, "binomial", mg.IIDPrior(mg.Normal(0.0, 1.0), d),
            tuning={"w": 0.5}, spec_k=4,
        )

    fr1 = make()
    st1 = fr1.init(jax.random.key(7), 8)
    st1, _, _ = fr1.warmup(st1, 20)

    fr2 = make()
    st2 = fr2.init(jax.random.key(7), 8)
    sc = jax.numpy.zeros((8,), jax.numpy.int32)
    for _ in range(10_000):
        st2, sc = fr2.warmup_passes(st2, sc, 20, 37)
        if (np.asarray(sc) >= 20).all():
            break
    else:
        raise AssertionError("warmup_passes never completed")
    assert np.array_equal(np.asarray(st1.beta), np.asarray(st2.beta))
    assert np.array_equal(np.asarray(st1.logw), np.asarray(st2.logw))
    assert np.array_equal(np.asarray(st1.nev), np.asarray(st2.nev))
    assert np.array_equal(
        np.asarray(jax.random.key_data(st1.key)),
        np.asarray(jax.random.key_data(st2.key)),
    )


class TestBf16XStorage:
    """x_storage='bf16': the design matrix is rounded ONCE up front and
    every path computes on the same rounded values, so the engine exactly
    samples the posterior of X' = bf16(X).  These tests pin (a) the posterior shift
    from the design rounding is far below the posterior sd, (b) the
    rounding is applied consistently (eta matches X' beta, not X beta)."""

    def _problem(self, n=1000, d=8, seed=0):
        rng = np.random.default_rng(seed)
        X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
        beta_true = rng.normal(size=d) * 0.5
        y = rng.binomial(1, 1.0 / (1.0 + np.exp(-X @ beta_true))).astype(float)
        return X, y

    def _fit(self, X, y, x_storage, seed=3):
        d = X.shape[1]
        fr = FreeRunCGGibbs(
            X, y, "binomial", mg.IIDPrior(mg.Normal(0.0, 1.0), d),
            tuning={"w": 0.5}, spec_k=4, x_storage=x_storage,
        )
        st = fr.init(jax.random.key(seed), 16)
        st, _, _ = fr.warmup(st, 40)
        st, draws, _ = fr.run(st, 300)
        return np.asarray(draws)[:, 50:, :].reshape(-1, d)

    def test_posterior_shift_below_sd(self):
        X, y = self._problem()
        p32 = self._fit(X, y, "f32")
        p16 = self._fit(X, y, "bf16")
        sd = p32.std(0)
        shift = np.abs(p16.mean(0) - p32.mean(0)) / sd
        # the X' perturbation is ~2^-9 relative; the induced posterior
        # shift must drown in the posterior spread (MC error here ~0.05)
        assert shift.max() < 0.2

    def test_eta_consistent_with_rounded_design(self):
        X, y = self._problem(n=600, d=6)
        d = X.shape[1]
        fr = FreeRunCGGibbs(
            X, y, "binomial", mg.IIDPrior(mg.Normal(0.0, 1.0), d),
            tuning={"w": 0.5}, spec_k=4, x_storage="bf16",
        )
        st = fr.init(jax.random.key(0), 8)
        st, _, _ = fr.run(st, 3)
        eta = np.asarray(st.eta)
        Xp = np.asarray(X).astype(np.float32)
        import jax.numpy as jnp
        Xr = np.asarray(jnp.asarray(Xp).astype(jnp.bfloat16).astype(jnp.float32))
        # eta must track the ROUNDED design exactly (f32 accumulation of
        # incremental updates), not the original X
        drift_rounded = np.abs(
            eta - np.asarray(st.beta) @ np.asarray(Xr).T
        ).max()
        assert drift_rounded < 5e-4

    def test_bad_x_storage_raises(self):
        X, y = self._problem(n=200, d=4)
        with pytest.raises(ValueError, match="x_storage"):
            FreeRunCGGibbs(
                X, y, "binomial", mg.IIDPrior(mg.Normal(0.0, 1.0), 4),
                tuning={"w": 0.5}, x_storage="fp8",
            )


def test_commit_row_equals_scatter_semantics():
    """_commit_row (the one-hot dense select that replaced a per-pass
    scatter) must be element-for-element the scatter it replaced,
    including the gated form (only gated lanes write)."""
    import jax.numpy as jnp

    X, y, _ = generate_glm_data("binomial", n=200, d=7, seed=0)
    fr = FreeRunCGGibbs(
        X, y, "binomial", mg.IIDPrior(mg.Normal(0.0, 1.0), 7),
        tuning={"w": 0.5},
    )
    rng = np.random.default_rng(5)
    C, d = 9, 7
    arr = jnp.asarray(rng.normal(size=(C, d)).astype(np.float32))
    j = jnp.asarray(rng.integers(0, d, size=C), jnp.int32)
    val = jnp.asarray(rng.normal(size=C).astype(np.float32))
    gate = jnp.asarray(rng.integers(0, 2, size=C).astype(bool))

    rows = jnp.arange(C)
    want_plain = arr.at[rows, j].set(val)
    got_plain = fr._commit_row(arr, j, val)
    assert np.array_equal(np.asarray(want_plain), np.asarray(got_plain))

    jw = jnp.where(gate, j, d)  # the old OOB-drop gating
    want_gated = arr.at[rows, jw].set(val, mode="drop")
    got_gated = fr._commit_row(arr, j, val, gate=gate)
    assert np.array_equal(np.asarray(want_gated), np.asarray(got_gated))


def test_idle_lanes_do_not_burn_shrink_budget_across_boundaries():
    """Regression (many-chain boundary anomaly): after a chain fills its sweep quota it idles while slower chains
    finish; its automaton must FREEZE — previously the idle lane kept
    shrinking its interval and burning its shrink budget, so at the next
    run boundary it resumed with rem=0 and exhaust-committed b0, skipping
    the first coordinate after the sweep wrap (the intercept) for every
    chain that idled long enough; with thousands of chains and thin=1
    collection this FROZE the intercept outright for many chains.  Provoked
    here with a tiny max_shrink, many chains (long boundary tails
    relative to d) and many one-sweep boundaries; the metric is the
    intercept MOVE RATE across boundaries (pre-fix ~0.45 here; the
    slice draw virtually always moves, so post-fix it must be ~1)."""
    X, y, _ = generate_glm_data("binomial", n=400, d=3, seed=1)
    fr = FreeRunCGGibbs(
        X, y, "binomial", mg.IIDPrior(mg.Normal(0.0, 1.0), 3),
        tuning={"w": 0.5}, spec_k=4, max_shrink=16,
    )
    st = fr.init(jax.random.key(0), 256)
    st, _, _ = fr.warmup(st, 20)
    kept = []
    for _ in range(30):  # 30 one-sweep run boundaries
        st, draws, _ = fr.run(st, 1)
        kept.append(np.asarray(draws))
    col0 = np.concatenate(kept, axis=1)[:, :, 0]  # (C, 30) intercept
    moved = np.abs(np.diff(col0, axis=1)) > 0
    move_rate = float(moved.mean())
    assert move_rate > 0.95, f"intercept move rate {move_rate:.3f}"


def test_idle_lanes_never_saturate_shrink_budget():
    """Mechanism-level invariant for the same regression: the persisted
    n_shrink register can never reach max_shrink — an active lane that
    would reach it exhaust-commits (and resets) within the same pass, and
    idle lanes are frozen.  Pre-fix, idle lanes' n_shrink saturated AT
    max_shrink across run boundaries (the freeze precondition)."""
    X, y, _ = generate_glm_data("binomial", n=400, d=3, seed=1)
    fr = FreeRunCGGibbs(
        X, y, "binomial", mg.IIDPrior(mg.Normal(0.0, 1.0), 3),
        tuning={"w": 0.5}, spec_k=4, max_shrink=8,
    )
    st = fr.init(jax.random.key(0), 256)
    st, _, _ = fr.warmup(st, 10)
    worst = 0
    for _ in range(10):
        st, _, _ = fr.run(st, 1)
        worst = max(worst, int(np.asarray(st.n_shrink).max()))
    assert worst < fr.max_shrink, (
        f"persisted n_shrink reached {worst} (max_shrink {fr.max_shrink}): "
        "idle lanes are burning shrink budget across boundaries"
    )


def test_pass_hlo_scatter_budget():
    """Structural performance guard (like the zero-collective HLO test,
    tests/test_sharding.py): the compiled pass may contain AT MOST the
    two cond-gated sweep-buffer scatters (draws + nevbuf).  The beta and
    logw commits are one-hot dense selects that fuse with their
    neighbours; reintroducing a per-pass scatter would add a kernel of
    its own to every pass."""
    import re
    from functools import partial

    X, y, _ = generate_glm_data("binomial", n=300, d=6, seed=0)
    fr = FreeRunCGGibbs(
        X, y, "binomial", mg.IIDPrior(mg.Normal(0.0, 1.0), 6),
        tuning={"w": 0.5}, spec_k=4,
    )
    st = fr.init(jax.random.key(0), 8)
    txt = jax.jit(partial(
        fr._run, n_sweeps=2, adapt=True, shrink_only=False,
        stepout_sweeps=1,
    )).lower(st).compile().as_text()
    n_scatter = len(re.findall(r"scatter\(", txt))
    assert n_scatter <= 2, (
        f"{n_scatter} scatter ops in the pass HLO (expected <=2: the "
        "gated draws/nevbuf sweep buffers) — a commit path regressed "
        "to scatter"
    )


def test_run_passes_bitwise_matches_run():
    """The pass-bounded barrier-free collection (run_passes — the pod
    thin=1 mode) executes the exact same pass sequence as run(): final
    state and collected draws bitwise identical, regardless of how the
    pass budget slices the dispatches."""
    X, y, _ = generate_glm_data("binomial", n=400, d=6, seed=5)

    def make():
        return FreeRunCGGibbs(
            X, y, "binomial", mg.IIDPrior(mg.Normal(0.0, 1.0), 6),
            tuning={"w": 0.5}, spec_k=4,
        )

    fr1 = make()
    st1 = fr1.init(jax.random.key(7), 8)
    st1, _, _ = fr1.warmup(st1, 10)
    st1, draws1, nev1 = fr1.run(st1, 12)

    fr2 = make()
    st2 = fr2.init(jax.random.key(7), 8)
    st2, _, _ = fr2.warmup(st2, 10)
    sc, draws2, nb = None, None, None
    for _ in range(10_000):
        st2, sc, draws2, nb = fr2.run_passes(st2, sc, draws2, nb, 12, 37)
        if (np.asarray(sc) >= 12).all():
            break
    else:
        raise AssertionError("run_passes never completed")
    assert np.array_equal(np.asarray(st1.beta), np.asarray(st2.beta))
    assert np.array_equal(np.asarray(draws1), np.asarray(draws2))
    assert np.array_equal(np.asarray(nev1), np.asarray(nb))


def test_sharded_run_passes_collects_and_mixes():
    """Sharded run_passes over the virtual mesh: draws land in the
    chain-sharded buffer, every chain completes its quota, and the
    intercept mixes (the boundary-freeze regression has no boundaries
    left to bite)."""
    from mcmcglm_tpu.parallel.freerun_sharded import ShardedFreeRunCGGibbs

    X, y, _ = generate_glm_data("binomial", n=400, d=5, seed=2)
    eng = ShardedFreeRunCGGibbs(
        X, y, "binomial", mg.IIDPrior(mg.Normal(0.0, 1.0), 5),
        tuning={"w": 0.5}, spec_k=4,
    )
    st = eng.init(jax.random.key(0), 32)
    st, _, _ = eng.warmup(st, 15)
    sc, draws, nb = None, None, None
    for _ in range(10_000):
        st, sc, draws, nb = eng.run_passes(st, sc, draws, nb, 25, 300)
        if (np.asarray(sc) >= 25).all():
            break
    else:
        raise AssertionError("sharded run_passes never completed")
    dr = np.asarray(draws)
    assert dr.shape == (32, 25, 5)
    assert np.isfinite(dr).all()
    assert (dr[:, :, 0].std(axis=1) > 1e-7).all()  # intercept moves
