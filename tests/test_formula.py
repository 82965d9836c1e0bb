"""Tests for the formula/design-matrix layer (analogue of R model.matrix;
reference: R/family_data_processing.R:20-36)."""

import numpy as np
import pandas as pd
import pytest

from mcmcglm_tpu.formula import build_design, design_from_arrays


@pytest.fixture
def df():
    rng = np.random.default_rng(0)
    return pd.DataFrame(
        {
            "Y": rng.normal(size=10),
            "X1": rng.normal(size=10),
            "X2": rng.binomial(1, 0.5, 10).astype(float),
            "g": pd.Categorical(["a", "b", "c", "a", "b", "c", "a", "b", "c", "a"]),
        }
    )


class TestBuildDesign:
    def test_named_terms(self, df):
        d = build_design("Y ~ X1 + X2", df)
        assert d.columns == ["(Intercept)", "X1", "X2"]
        np.testing.assert_array_equal(d.X[:, 0], 1.0)
        np.testing.assert_array_equal(d.X[:, 1], df["X1"])
        np.testing.assert_array_equal(d.y, df["Y"])

    def test_dot(self, df):
        d = build_design("Y ~ .", df[["Y", "X1", "X2"]])
        assert d.columns == ["(Intercept)", "X1", "X2"]

    def test_no_intercept(self, df):
        for f in ["Y ~ X1 - 1", "Y ~ 0 + X1"]:
            d = build_design(f, df)
            assert d.columns == ["X1"]

    def test_categorical_expansion(self, df):
        d = build_design("Y ~ g", df)
        # treatment coding drops the first level, like R's default contrasts
        assert d.columns == ["(Intercept)", "gb", "gc"]
        np.testing.assert_array_equal(d.X[:, 1], (df["g"] == "b").astype(float))

    def test_interaction(self, df):
        d = build_design("Y ~ X1:X2", df)
        assert d.columns == ["(Intercept)", "X1:X2"]
        np.testing.assert_allclose(d.X[:, 1], df["X1"] * df["X2"])

    def test_star_expansion(self, df):
        d = build_design("Y ~ X1*X2", df)
        assert d.columns == ["(Intercept)", "X1", "X2", "X1:X2"]

    def test_three_way_interaction(self, df):
        d = build_design("Y ~ X1:X2:X1", df)
        assert d.columns == ["(Intercept)", "X1:X2:X1"]
        np.testing.assert_allclose(
            d.X[:, 1], df["X1"] * df["X2"] * df["X1"]
        )

    def test_three_way_star_expansion(self, df):
        """a*b*c = all main effects + interactions up to degree 3, ordered
        by degree (R's model.matrix expansion,
        reference R/family_data_processing.R:31-33)."""
        df = dict(df)
        df["X3"] = np.asarray(df["X1"]) + 1.0
        d = build_design("Y ~ X1*X2*X3", df)
        assert d.columns == [
            "(Intercept)", "X1", "X2", "X3",
            "X1:X2", "X1:X3", "X2:X3", "X1:X2:X3",
        ]
        np.testing.assert_allclose(
            d.X[:, -1], np.asarray(df["X1"]) * df["X2"] * df["X3"]
        )

    def test_categorical_in_higher_order_interaction(self, df):
        """Categoricals inside an n-way term expand per non-base level with
        R contrast naming (x:gb, x:gc)."""
        d = build_design("Y ~ X1:g:X2", df)
        assert d.columns == ["(Intercept)", "X1:gb:X2", "X1:gc:X2"]
        gb = (np.asarray(df["g"]) == "b").astype(float)
        np.testing.assert_allclose(
            d.X[:, 1], np.asarray(df["X1"]) * gb * df["X2"]
        )

    def test_dict_input(self):
        data = {"Y": np.arange(5.0), "Z": np.ones(5)}
        d = build_design("Y ~ Z", data)
        assert d.columns == ["(Intercept)", "Z"]

    def test_missing_response(self, df):
        with pytest.raises(ValueError, match="response"):
            build_design("W ~ X1", df)

    def test_missing_var(self, df):
        with pytest.raises(ValueError, match="not found"):
            build_design("Y ~ nope", df)

    def test_not_a_formula(self, df):
        with pytest.raises(ValueError, match="formula"):
            build_design("Y + X1", df)


class TestDesignFromArrays:
    def test_basic(self):
        X = np.ones((5, 2))
        y = np.arange(5.0)
        d = design_from_arrays(X, y)
        assert d.columns == ["X1", "X2"]

    def test_add_intercept(self):
        d = design_from_arrays(np.ones((4, 1)), np.zeros(4), add_intercept=True)
        assert d.columns == ["(Intercept)", "X1"]
        assert d.X.shape == (4, 2)

    def test_shape_mismatch(self):
        with pytest.raises(ValueError, match="rows"):
            design_from_arrays(np.ones((4, 2)), np.zeros(5))


class TestFunctionTerms:
    """Round-2 formula tail: function terms, I(), offset() — the
    model.matrix surface R users actually hit
    (reference R/family_data_processing.R:21-33)."""

    def _dat(self):
        rng = np.random.default_rng(0)
        n = 50
        return {
            "y": rng.normal(size=n),
            "x": rng.uniform(0.5, 2.0, size=n),
            "z": rng.normal(size=n),
            "t": np.arange(n, dtype=float) + 1.0,
        }

    def test_log_term(self):
        d = self._dat()
        des = build_design("y ~ log(x)", d)
        assert des.columns == ["(Intercept)", "log(x)"]
        np.testing.assert_allclose(des.X[:, 1], np.log(d["x"]))

    def test_function_of_expression(self):
        d = self._dat()
        des = build_design("y ~ log(x + 1)", d)
        np.testing.assert_allclose(des.X[:, 1], np.log(d["x"] + 1))

    def test_I_power_r_spelling(self):
        d = self._dat()
        des = build_design("y ~ x + I(x^2)", d)
        assert des.columns == ["(Intercept)", "x", "I(x^2)"]
        np.testing.assert_allclose(des.X[:, 2], d["x"] ** 2)

    def test_I_arithmetic(self):
        d = self._dat()
        des = build_design("y ~ I(x * z + 2)", d)
        np.testing.assert_allclose(des.X[:, 1], d["x"] * d["z"] + 2)

    def test_function_term_in_interaction(self):
        d = self._dat()
        des = build_design("y ~ log(x):z - 1", d)
        assert des.columns == ["log(x):z"]
        np.testing.assert_allclose(des.X[:, 0], np.log(d["x"]) * d["z"])

    def test_offset_extracted(self):
        d = self._dat()
        des = build_design("y ~ z + offset(log(t))", d)
        assert des.columns == ["(Intercept)", "z"]
        np.testing.assert_allclose(des.offset, np.log(d["t"]))

    def test_two_offsets_sum(self):
        d = self._dat()
        des = build_design("y ~ z + offset(log(t)) + offset(x)", d)
        np.testing.assert_allclose(des.offset, np.log(d["t"]) + d["x"])

    def test_no_offset_is_none(self):
        des = build_design("y ~ z", self._dat())
        assert des.offset is None

    def test_unknown_function_fails_loudly(self):
        with pytest.raises(ValueError, match="poly"):
            build_design("y ~ poly(x, 2)", self._dat())

    def test_unknown_variable_in_function_fails(self):
        with pytest.raises(ValueError, match="nope"):
            build_design("y ~ log(nope)", self._dat())

    def test_unbalanced_parens_fail(self):
        with pytest.raises(ValueError, match="unbalanced"):
            build_design("y ~ log(x", self._dat())

    def test_nonfinite_column_fails_loudly(self):
        d = self._dat()
        d["x"][0] = -1.0
        with pytest.raises(ValueError, match="non-finite"):
            build_design("y ~ log(x)", d)

    def test_unsupported_removal_fails(self):
        with pytest.raises(ValueError, match="removal"):
            build_design("y ~ z - x", self._dat())

    def test_plus_inside_I_not_split(self):
        d = self._dat()
        des = build_design("y ~ I(x + z)", d)
        assert des.columns == ["(Intercept)", "I(x + z)"]
        np.testing.assert_allclose(des.X[:, 1], d["x"] + d["z"])


class TestOffsetEndToEnd:
    def test_poisson_rate_model_recovers_with_offset(self):
        """Poisson rate model: y ~ Pois(t * exp(eta)), the canonical
        offset(log(t)) use case.  Without the offset the intercept would
        absorb E[log t]; with it the coefficients are recovered."""
        import mcmcglm_tpu as mg

        rng = np.random.default_rng(7)
        n = 800
        x = rng.normal(size=n)
        t = rng.uniform(0.5, 4.0, size=n)  # exposure times
        eta = 0.5 + 0.8 * x
        y = rng.poisson(t * np.exp(eta)).astype(float)
        fit = mg.mcmcglm(
            formula="y ~ x + offset(log(t))",
            data={"y": y, "x": x, "t": t},
            family="poisson", beta_prior=mg.Normal(0, 10),
            n_samples=300, burnin=100, n_chains=4, seed=0, w=0.5,
        )
        np.testing.assert_allclose(fit.coef().values, [0.5, 0.8], atol=0.1)
        # predict on training data applies the stored offset
        mu = fit.predict(kind="mean").mean(0)
        np.testing.assert_allclose(mu, t * np.exp(eta), rtol=0.5)

    def test_offset_on_xla_engine_and_oracle(self):
        """offset must thread through the xla engine and the conjugate
        normal-normal path (gaussian: y - offset shift)."""
        import mcmcglm_tpu as mg

        rng = np.random.default_rng(8)
        n = 500
        x = rng.normal(size=n)
        off = rng.normal(size=n)
        y = 1.0 + 2.0 * x + off + rng.normal(size=n)
        dat = {"y": y, "x": x, "off": off}
        f1 = mg.mcmcglm(formula="y ~ x + offset(off)", data=dat,
                        family="gaussian", n_samples=200, burnin=50,
                        n_chains=4, seed=1, w=0.5, engine="xla")
        np.testing.assert_allclose(f1.coef().values, [1.0, 2.0], atol=0.15)
        f2 = mg.mcmcglm(formula="y ~ x + offset(off)", data=dat,
                        family="gaussian", sample_method="normal-normal",
                        n_samples=200, burnin=50, n_chains=4, seed=2)
        np.testing.assert_allclose(f2.coef().values, [1.0, 2.0], atol=0.15)
        np.testing.assert_allclose(f1.coef().values, f2.coef().values, atol=0.1)
