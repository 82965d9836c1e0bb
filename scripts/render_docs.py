"""Render the example walkthroughs into docs/ with executed output.

The reference ships knitted vignettes whose chunks show real fitted tables
(vignettes/pospkg.Rmd:79-86 etc.) plus a pkgdown site; this package's
analogue is this renderer: each example script is executed and
its source + captured stdout are written as a markdown document under
docs/, so the docs always show numbers a reader can reproduce by running
the same file.

Run: env JAX_PLATFORMS=cpu python scripts/render_docs.py
"""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXAMPLES = [
    (
        "01_families_and_priors.py",
        "Families and priors tour",
        "Every scenario of the reference's main vignette "
        "(`pospkg.Rmd`): gaussian/identity, binomial/logit, "
        "binomial/probit, poisson/log, negative binomial; iid, strongly "
        "misspecified, per-coordinate list and multivariate-normal priors; "
        "the elliptical slice kernels; the normal-normal conjugate "
        "cross-check.",
    ),
    (
        "02_customising.py",
        "Adding a new family",
        "The reference's extension recipe (`customising.Rmd`) is \"define "
        "a log_density S3 method\"; here it is one `register_family` call "
        "with a per-observation log-density, reproducing the vignette's "
        "inverse-gaussian model from scratch.",
    ),
    (
        "03_performance.py",
        "Update-vs-naive runtime",
        "The linear-vs-quadratic CGGibbs runtime claim "
        "(reference README.md:11-16) through the reference's own "
        "methodology (`performance.Rmd`).  Rendered on the CPU, where "
        "small-d timings are dispatch-bound: this shows how to produce "
        "the curve, not the device evidence.",
    ),
    (
        "04_multichip.py",
        "Multi-chip sharded sampling",
        "The multi-device walkthrough: 64 chains of a logistic GLM "
        "over a (chain x obs) device mesh with pooled streaming "
        "diagnostics (`parallel/`).  Rendered here on the 8-virtual-"
        "device CPU mesh (the CI platform); on a multi-GPU host the same "
        "script is real multi-device execution.",
    ),
    (
        "05_speculative_batteries.py",
        "Speculative proposal batteries",
        "The flagship throughput lever: K slice proposals per device "
        "pass, evaluated in one (C, K, n) reduce and consumed "
        "first-acceptor — identical in law to the one-at-a-time kernel. "
        "Rendered on the CPU; the measured GPU rates are in `PERF.md`.",
    ),
    (
        "06_tall_data_and_recovery.py",
        "Tall data, on-device diagnostics, alternative kernels",
        "The obs-sharded freerun engine (fast automaton over a "
        "(chain x obs) mesh, one psum of partial log-lik sums per pass) "
        "for datasets exceeding one card's memory; streaming min-ESS on "
        "device (split-chain autocovariance accumulator — only a (d,) "
        "vector reaches the host); and the latent (Li & Walker 2020) "
        "and doubling (Neal 2003) slice kernels at full freerun speed "
        "— all six qslice kernels ride the automaton.  Fault-injected "
        "restart recovery is exercised separately by "
        "`scripts/fault_injection_dryrun.py`.",
    ),
]

# per-example env additions (the renderer itself pins JAX_PLATFORMS=cpu)
EXTRA_ENV = {
    "04_multichip.py": {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
    },
    "06_tall_data_and_recovery.py": {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
    },
}


def main():
    docs = os.path.join(_REPO, "docs")
    os.makedirs(docs, exist_ok=True)
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    env["PYTHONPATH"] = _REPO
    index = [
        "# mcmcglm_tpu — rendered walkthroughs",
        "",
        "Executed-output equivalents of the reference package's knitted",
        "vignettes, produced by `scripts/render_docs.py` (re-run it to",
        "refresh the numbers).  Plots land next to the documents.",
        "",
    ]
    for fname, title, blurb in EXAMPLES:
        path = os.path.join(_REPO, "examples", fname)
        print(f"running {fname} ...", flush=True)
        ex_env = dict(env)
        for k, v in EXTRA_ENV.get(fname, {}).items():
            ex_env[k] = (ex_env.get(k, "") + " " + v).strip()
        r = subprocess.run(
            [sys.executable, path], env=ex_env, capture_output=True,
            text=True, timeout=3600, cwd=docs,
        )
        if r.returncode:
            print(r.stdout)
            print(r.stderr, file=sys.stderr)
            raise SystemExit(f"{fname} failed")
        src = open(path).read()
        out_md = os.path.join(docs, fname.replace(".py", ".md"))
        with open(out_md, "w") as f:
            f.write(f"# {title}\n\n{blurb}\n\n")
            f.write(f"Source: [`examples/{fname}`](../examples/{fname}) — "
                    "run with `env JAX_PLATFORMS=cpu python "
                    f"examples/{fname}`.\n\n")
            f.write("## Code\n\n```python\n")
            f.write(src.rstrip())
            f.write("\n```\n\n## Executed output\n\n```\n")
            f.write(r.stdout.rstrip())
            f.write("\n```\n")
            if "eta_comptime.png" in r.stdout:
                f.write("\n![update vs naive comptime](eta_comptime.png)\n")
        index.append(f"- [{title}]({fname.replace('.py', '.md')})")
        print(f"wrote {out_md}", flush=True)
    with open(os.path.join(docs, "README.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print("wrote docs/README.md", flush=True)


if __name__ == "__main__":
    main()
