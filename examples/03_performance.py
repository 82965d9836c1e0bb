"""CGGibbs update-vs-naive runtime comparison — the `performance` vignette.

Mirrors vignettes/performance.Rmd:29-41: sweep model widths and compare
linear_predictor_calc="update" (O(n) per coordinate) against "naive"
(full matvec per slice evaluation), then plot time vs dimension.

THE claim (reference README.md:11-16): total runtime is LINEAR in the
parameter count d with the incremental update, QUADRATIC with the naive
recompute.  This sweep reproduces the reference's *methodology*
(R/measure_performance.R:113-151).  Run on the CPU at these small d its
timings are dominated by per-sweep dispatch overhead, not by the O(n) vs
O(n d) arithmetic — read it as "how to produce the curve"; the curve that
tests the claim is the same call on the GPU at larger d.

Run: env JAX_PLATFORMS=cpu python examples/03_performance.py
"""

import mcmcglm_tpu as mg

print("Local sweep (reference methodology; small-d timings are "
      "dispatch-bound on CPU):")
df = mg.compare_eta_comptime_across_nvars(
    n_vars=[2, 50, 100, 200, 400],
    n=100,
    n_samples=100,
    burnin=0,
)
print(df[["n_vars", "linear_predictor_calc", "time", "compile_time"]].to_string(index=False))
fig = mg.plot_eta_comptime(df)
fig.savefig("eta_comptime.png", dpi=120)
print("wrote eta_comptime.png")
