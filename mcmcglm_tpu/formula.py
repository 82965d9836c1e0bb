"""Formula/data ingestion: a lightweight model-matrix builder.

JAX-side replacement for the reference's use of R's model-frame machinery
(``stats::model.frame`` / ``model.matrix`` / ``model.response``; reference:
R/family_data_processing.R:20-36).  Accepts a pandas DataFrame (or a dict of
1-D arrays) plus an R-style formula string and produces the response vector
and a dense design matrix:

  * ``"Y ~ X1 + X2"`` — named main effects;
  * ``"Y ~ ."`` — all non-response columns (the form used throughout the
    reference docs, e.g. README.md:71);
  * ``"Y ~ X1 + X2 - 1"`` / ``"... + 0"`` — drop the intercept;
  * ``"Y ~ X1:X2"`` and ``"Y ~ X1*X2"`` — interactions / crossed expansion,
    at any order (``a:b:c``; ``a*b*c`` expands to all main effects and
    interactions up to degree 3, ordered by degree like R);
  * categorical (pandas ``category`` / object / bool) columns expand to
    treatment-coded dummies dropping the first level, like R's default
    contrasts; interaction terms expand over dummy pairs;
  * function terms ``log(x)``, ``sqrt(x)``, ``exp(x)`` … and arbitrary
    arithmetic under ``I(...)`` (R's as-is operator, with R's ``^`` power
    spelling), matching what R's ``model.matrix`` accepts
    (R/family_data_processing.R:31-33);
  * ``offset(expr)`` — a fixed additive component of the linear predictor
    (coefficient pinned to 1), returned as ``Design.offset`` and threaded
    into eta by the engines;
  * anything outside this grammar fails loudly with a named reason
    (never a silent mis-parse).

Arrays can also bypass formulas entirely: ``design_from_arrays`` wraps an
explicit (X, y) pair with optional column names — the natural API for the
large-scale sharded path where data never lives in a DataFrame.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping, Optional, Sequence

import numpy as np

__all__ = ["Design", "build_design", "design_from_arrays"]


@dataclasses.dataclass
class Design:
    """The response + model matrix pair (analogue of the reference's
    ``extract_model_data`` return value, R/family_data_processing.R:35)."""

    X: np.ndarray  # (n, d) float64 design matrix
    y: np.ndarray  # (n,) response
    columns: list  # d column names, R-style (e.g. "(Intercept)", "X1", "a:b")
    response: str  # response column name
    formula: Optional[str] = None
    offset: Optional[np.ndarray] = None  # (n,) additive eta offset, or None


def _as_column_dict(data) -> Mapping[str, np.ndarray]:
    try:  # pandas DataFrame
        import pandas as pd

        if isinstance(data, pd.DataFrame):
            return {c: data[c] for c in data.columns}
    except ImportError:  # pragma: no cover
        pass
    if isinstance(data, Mapping):
        return dict(data)
    raise TypeError(
        "data must be a pandas DataFrame or a mapping of column name -> 1-D array"
    )


def _is_categorical(col) -> bool:
    try:
        import pandas as pd

        if isinstance(col, pd.Series):
            if isinstance(col.dtype, pd.CategoricalDtype):
                return True
            if col.dtype == object or col.dtype == bool:
                return True
            return False
    except ImportError:  # pragma: no cover
        pass
    arr = np.asarray(col)
    return arr.dtype.kind in ("U", "S", "O", "b")


def _levels(col):
    try:
        import pandas as pd

        if isinstance(col, pd.Series) and isinstance(col.dtype, pd.CategoricalDtype):
            return list(col.cat.categories)
    except ImportError:  # pragma: no cover
        pass
    return sorted(set(np.asarray(col).tolist()))


def _expand_var(name, col):
    """Expand one variable into (colname, float column) pairs.

    Categorical -> treatment-coded dummies dropping the first level
    (R's default contrasts); numeric passes through."""
    if _is_categorical(col):
        levels = _levels(col)
        arr = np.asarray(col)
        return [
            (f"{name}{lvl}", (arr == lvl).astype(np.float64))
            for lvl in levels[1:]
        ]
    return [(name, np.asarray(col, dtype=np.float64))]


# function terms the grammar accepts outside I(...) — the transformations
# R formulas commonly apply via model.matrix (log(x), sqrt(x), ...)
_TERM_FUNCS = {
    "log": np.log, "log2": np.log2, "log10": np.log10, "log1p": np.log1p,
    "exp": np.exp, "sqrt": np.sqrt, "abs": np.abs,
    "sin": np.sin, "cos": np.cos, "tan": np.tan,
}


def _split_top(s: str, seps: str):
    """Split ``s`` at top-level occurrences of any char in ``seps`` —
    separators inside parentheses (function/I()/offset() arguments) do not
    split.  Returns (pieces, separators_between_them)."""
    pieces, ops = [], []
    depth = 0
    cur = []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth < 0:
                raise ValueError(f"unbalanced ')' in formula term {s!r}")
        if depth == 0 and ch in seps:
            pieces.append("".join(cur))
            ops.append(ch)
            cur = []
        else:
            cur.append(ch)
    if depth != 0:
        raise ValueError(f"unbalanced '(' in formula term {s!r}")
    pieces.append("".join(cur))
    return pieces, ops


def _eval_term_expr(expr: str, cols: Mapping[str, np.ndarray], context: str):
    """Safely evaluate an arithmetic expression over data columns (the
    inside of ``I(...)`` / ``offset(...)`` / a function term's argument).
    R's ``^`` power operator is translated to ``**``."""
    env = {}
    for name, col in cols.items():
        if name.isidentifier():
            env[name] = np.asarray(col, dtype=np.float64)
    env.update(_TERM_FUNCS)
    env["pi"] = np.pi
    code = expr.replace("^", "**")
    try:
        out = eval(code, {"__builtins__": {}}, env)  # noqa: S307 - no builtins
    except NameError as e:
        raise ValueError(
            f"unknown variable or function in {context} term {expr!r}: {e} "
            f"(supported functions: {sorted(_TERM_FUNCS)}, I(), offset())"
        ) from None
    except SyntaxError:
        raise ValueError(
            f"could not parse {context} term expression {expr!r}"
        ) from None
    return np.asarray(out, dtype=np.float64)


def _parse_terms(rhs: str, columns: Sequence[str], response: str):
    """Parse the RHS into (term strings, include_intercept, offset exprs).
    Splitting is parenthesis-aware so 'log(x + 1)' survives intact."""
    include_intercept = True
    terms: list[str] = []
    offsets: list[str] = []
    pieces, _ = _split_top(rhs, "+")
    for raw in pieces:
        raw = raw.strip()
        if not raw:
            continue
        # handle subtraction of intercept written as "x - 1"
        parts, _ = _split_top(raw, "-")
        parts = [p.strip() for p in parts]
        head, removed = parts[0], parts[1:]
        for r in removed:
            if r in ("1",):
                include_intercept = False
            elif r:
                raise ValueError(
                    f"unsupported removal term '- {r}' in formula (only "
                    "'- 1' intercept removal is supported)"
                )
        if head in ("0",):
            include_intercept = False
            continue
        if head in ("1", ""):
            continue
        if head == ".":
            terms.extend(c for c in columns if c != response and c not in terms)
            continue
        if head.startswith("offset(") and head.endswith(")"):
            offsets.append(head[len("offset("):-1])
            continue
        star_parts, _ = _split_top(head, "*")
        if len(star_parts) > 1:
            # full factorial crossing, any order (R: a*b*c = all main
            # effects + all interactions up to a:b:c, ordered by degree —
            # the expansion stats::model.matrix performs,
            # R/family_data_processing.R:31-33)
            factors = [t.strip() for t in star_parts]
            for r in range(1, len(factors) + 1):
                for combo in itertools.combinations(factors, r):
                    t = ":".join(combo)
                    if t not in terms:
                        terms.append(t)
        else:
            if head not in terms:
                terms.append(head)
    return terms, include_intercept, offsets


def _expand_single_term(term: str, cols: Mapping[str, np.ndarray]):
    """Expand one non-interaction term into (name, column) pairs.

    Plain column names go through categorical expansion; anything with
    parentheses/operators is a function/``I()`` term evaluated as an
    arithmetic expression over the data columns (R-style names kept as-is,
    e.g. ``"log(x)"``, ``"I(x^2)"``)."""
    term = term.strip()
    if term.isidentifier():
        if term not in cols:
            raise ValueError(f"variable {term!r} not found in data")
        return _expand_var(term, cols[term])
    # function / I() / arithmetic term
    if term.startswith("I(") and term.endswith(")"):
        col = _eval_term_expr(term[2:-1], cols, "I()")
    else:
        col = _eval_term_expr(term, cols, "function")
    col = np.asarray(col, dtype=np.float64)
    if col.ndim == 0:
        raise ValueError(
            f"term {term!r} evaluated to a scalar, not a column"
        )
    return [(term, col)]


def build_design(formula: str, data) -> Design:
    """formula + data -> Design (reference: R/family_data_processing.R:20-36)."""
    if "~" not in formula:
        raise ValueError(f"not a formula: {formula!r} (expected 'Y ~ ...')")
    lhs, rhs = formula.split("~", 1)
    response = lhs.strip()
    cols = _as_column_dict(data)
    if response not in cols:
        raise ValueError(f"response {response!r} not found in data")
    terms, intercept, offset_exprs = _parse_terms(rhs, list(cols.keys()), response)

    names: list[str] = []
    columns: list[np.ndarray] = []
    n = len(np.asarray(cols[response]))
    if intercept:
        names.append("(Intercept)")
        columns.append(np.ones(n))
    for term in terms:
        parts, _ = _split_top(term, ":")
        if len(parts) > 1:
            # n-way interaction: cartesian product of each factor's
            # expansion (categoricals contribute one dummy per non-base
            # level), columns multiplied elementwise, names joined with ':'
            # in R's contrast style (e.g. "x:gb:tc")
            expansions = [
                _expand_single_term(p.strip(), cols) for p in parts
            ]
            for combo in itertools.product(*expansions):
                names.append(":".join(nm for nm, _ in combo))
                col = np.asarray(combo[0][1], np.float64)
                for _, c in combo[1:]:
                    col = col * c
                columns.append(col)
        else:
            for nm, c in _expand_single_term(term, cols):
                names.append(nm)
                columns.append(c)
    if not columns:
        raise ValueError("empty model: formula produced no columns")
    offset = None
    if offset_exprs:
        offset = np.zeros(n)
        for expr in offset_exprs:
            offset = offset + np.broadcast_to(
                _eval_term_expr(expr, cols, "offset()"), (n,)
            )
    X = np.column_stack(columns)
    for nm, c in zip(names, X.T):
        if not np.isfinite(c).all():
            raise ValueError(
                f"model column {nm!r} contains non-finite values "
                "(check function-term domains, e.g. log of non-positives)"
            )
    y = np.asarray(cols[response], dtype=np.float64)
    return Design(X=X, y=y, columns=names, response=response,
                  formula=formula, offset=offset)


def design_from_arrays(X, y, columns=None, add_intercept=False) -> Design:
    """Wrap explicit arrays as a Design (the array-first API path)."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    if X.ndim != 2:
        raise ValueError(f"X must be 2-D (n, d); got shape {X.shape}")
    if X.shape[0] != y.shape[0]:
        raise ValueError(
            f"X has {X.shape[0]} rows but y has {y.shape[0]} observations"
        )
    if add_intercept:
        X = np.column_stack([np.ones(X.shape[0]), X])
        if columns is not None:
            columns = ["(Intercept)"] + list(columns)
    if columns is None:
        columns = (
            ["(Intercept)"] + [f"X{i}" for i in range(1, X.shape[1])]
            if add_intercept
            else [f"X{i}" for i in range(1, X.shape[1] + 1)]
        )
    if len(columns) != X.shape[1]:
        raise ValueError("columns length must match X's second dimension")
    return Design(X=X, y=y, columns=list(columns), response="y", formula=None)
