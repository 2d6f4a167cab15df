#!/usr/bin/env python
"""Generate BASELINE_CPU.json: the documented stand-in baseline for
``bench.py``'s ``vs_baseline``.

The reference (PyMC3+Theano) cannot run in this image, so the baseline is
THIS framework on the stock-CPU JAX backend at the reference asv
benchmark's own configuration — ``NUTSInitSuite.track_glm_hierarchical_ess``
(``/root/reference/benchmarks/benchmarks/benchmarks.py:149-169``):
radon hierarchical GLM, 4 chains, 10k draws, jitter+adapt_diag init,
metric = ESS(mu_a) / sampling-seconds.

Run with ``JAX_PLATFORMS=cpu``: the script refuses any other backend.
"""
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402


def main():
    import jax
    import pymc3_tpu as pm
    from bench import build_model

    assert jax.default_backend() == "cpu", jax.default_backend()

    draws = int(os.environ.get("BASE_DRAWS", 10000))
    tune = int(os.environ.get("BASE_TUNE", 500))
    chains = int(os.environ.get("BASE_CHAINS", 4))

    model = build_model(pm)
    t0 = time.time()
    trace = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                      progressbar=False, random_seed=100,
                      init="jitter+adapt_diag",
                      compute_convergence_checks=False)
    wall = time.time() - t0
    ess = float(np.asarray(pm.ess(trace, var_names=["mu_a"])["mu_a"]))

    out = {
        "ess_per_sec": round(ess / wall, 3),
        "config": {
            "model": "radon glm_hierarchical",
            "draws": draws, "tune": tune, "chains": chains,
            "backend": "cpu (stock XLA:CPU jaxlib)",
            "wall_s": round(wall, 2), "ess_mu_a": round(ess, 1),
            "reference_analog":
                "NUTSInitSuite.track_glm_hierarchical_ess "
                "(benchmarks/benchmarks/benchmarks.py:149-169)",
        },
    }
    path = os.path.join(_REPO, "BASELINE_CPU.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
