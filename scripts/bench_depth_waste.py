#!/usr/bin/env python
"""Lockstep depth-variance waste vs chain count.

All vmapped lanes advance together: each draw's wall is set by the
DEEPEST lane's tree, so utilization = sum(tree_sizes) / (N * sum of
per-draw max tree). E[max over N lanes] grows ~log N — this probe
measures the actual post-tune waste at increasing chain counts on the
radon posterior.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import pymc3_tpu as pm
    from pymc3_tpu.config import enable_compilation_cache
    import jax
    enable_compilation_cache()
    from bench import build_model
    model = build_model(pm)

    draws = int(os.environ.get("WASTE_DRAWS", 200))
    tune = int(os.environ.get("WASTE_TUNE", 300))
    for chains in [int(c) for c in sys.argv[1:]] or [512, 2048, 8192]:
        t0 = time.time()
        tr = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                       progressbar=False, random_seed=3, target_accept=0.9,
                       axis_name="chains_local", trace=["mu_a"],
                       record_stats=["tree_size"],
                       compute_convergence_checks=False)
        wall = time.time() - t0
        # (chains, draws) post-tune tree sizes
        ts = np.asarray(tr.get_sampler_stats("tree_size", combine=False))
        ts = ts.reshape(chains, draws)
        per_draw_max = ts.max(axis=0)
        useful = float(ts.sum())
        padded = float(per_draw_max.sum() * chains)
        print(json.dumps({
            "chains": chains, "draws": draws,
            "utilization": round(useful / padded, 4),
            "waste_factor": round(padded / useful, 3),
            "mean_tree": round(float(ts.mean()), 2),
            "mean_max_tree": round(float(per_draw_max.mean()), 2),
            "wall_s": round(wall, 1),
            "backend": jax.default_backend(),
        }), flush=True)


if __name__ == "__main__":
    main()
