"""Small linear-algebra helpers shared across the engine.

``matvec`` pins ``precision=HIGHEST`` on every backend, for two
independent reasons:

* XLA:CPU pathology (jax 0.9): compiling a default-precision dot with
  small/ragged shapes can take minutes in the CPU backend's dot
  autotuner, while HIGHEST compiles in well under a second.  CPU is the
  test and multi-chip-dryrun platform.
* Accelerator correctness: a default-precision f32 matmul may round its
  operands (to TF32 on an NVIDIA GPU, to bfloat16 on other matrix
  units).  ``eta0 = X @ beta0`` is the ONLY full matvec the CGGibbs
  engines ever run — eta is maintained incrementally (in f32) from then
  on, so any init error is FROZEN for the whole chain.  For a generic
  column the bf16 error averages out over observations, but the
  intercept's all-ones column turns the rounding of beta0[0] into a
  constant per-chain eta offset of ~|beta0|*2^-9 ~ 1e-3, i.e. a
  permanent per-chain intercept shift (seen as a pooled intercept ESS
  that plateaus however long the chains run).

The matvec runs once per init (plus per-evaluation on the
``linear_predictor_calc="naive"`` benchmark-parity path), so HIGHEST
costs nothing that matters.
"""

from __future__ import annotations

from jax import lax

__all__ = ["matvec"]


def matvec(beta, Xt):
    """eta = beta @ Xt for beta (d,) and Xt (d, n) -> (n,)."""
    return lax.dot_general(
        beta, Xt, (((0,), (0,)), ((), ())), precision=lax.Precision.HIGHEST
    )
