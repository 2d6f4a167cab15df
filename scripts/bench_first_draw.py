#!/usr/bin/env python
"""Time-to-first-kept-draw at large chain counts.

Measures the wall of a (tune=FIRST_TUNE, draws=1) radon run — i.e. the
first tuning block plus one kept draw — with the Stan-style step-size
probe on (default) or off (PYMC3_TPU_NO_EPS_PROBE=1). The r4 finding:
469 s wall at 8192 chains of which ~15 s was lower+compile; the rest was
untuned max-depth trees while dual averaging recovered from the
0.25 d^-1/4 initial eps.

Prints one JSON line per configuration.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import numpy as np
    import pymc3_tpu as pm
    from pymc3_tpu.config import enable_compilation_cache
    enable_compilation_cache()
    from bench import build_model

    chains = int(os.environ.get("FD_CHAINS", 8192))
    tune = int(os.environ.get("FD_TUNE", 250))
    probe = not os.environ.get("PYMC3_TPU_NO_EPS_PROBE")

    model = build_model(pm)
    from pymc3_tpu.step_methods.hmc.nuts import find_reasonable_eps
    t0 = time.time()
    trace = pm.sample(draws=1, tune=tune, chains=chains, model=model,
                      progressbar=False, random_seed=1,
                      axis_name="chains_local", trace=["mu_a"],
                      record_stats=["diverging"],
                      compute_convergence_checks=False)
    wall = time.time() - t0
    info = dict(trace.report._t_compile or {})
    print(json.dumps({
        "suite": "time_to_first_draw",
        "chains": chains, "tune": tune, "eps_probe": probe,
        "wall_s": round(wall, 2),
        "lower_s": info.get("lower_s"), "compile_s": info.get("compile_s"),
        "block": info.get("block"),
        "backend": jax.default_backend(),
    }), flush=True)


if __name__ == "__main__":
    main()
