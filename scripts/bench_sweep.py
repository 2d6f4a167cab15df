#!/usr/bin/env python
"""Chain-scaling sweep for the radon NUTS benchmark on the current backend.

Measures steady-state sampling throughput (second run after compile) at a
range of vmapped chain counts to locate the chip's saturation knee
(ESS/sec/chip scales ~linearly with chains until then). Prints one JSON
line per configuration.

Usage: python scripts/bench_sweep.py [chains ...]
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

    chain_counts = [int(c) for c in sys.argv[1:]] or [8, 64, 256, 512, 1024]
    draws = int(os.environ.get("SWEEP_DRAWS", 500))
    tune = int(os.environ.get("SWEEP_TUNE", 500))
    target_accept = float(os.environ.get("SWEEP_TARGET_ACCEPT", 0.9))
    pooled = os.environ.get("SWEEP_POOLED", "1") != "0"
    block_size = os.environ.get("SWEEP_BLOCK")
    block_size = int(block_size) if block_size else None

    model = build_model(pm)

    for chains in chain_counts:
        # subset trace, as in bench.py run_config
        trace_arg = None if os.environ.get("BENCH_FULL_TRACE") else ["mu_a"]

        def run(seed):
            t0 = time.time()
            tr = pm.sample(draws=draws, tune=tune, chains=chains,
                           model=model, progressbar=False, random_seed=seed,
                           target_accept=target_accept,
                           axis_name="chains_local" if pooled else None,
                           block_size=block_size, trace=trace_arg,
                           record_stats=["diverging", "tree_size",
                                         "rescued", "step_size_scale"],
                           compute_convergence_checks=False)
            return tr, time.time() - t0

        tr1, first_wall = run(1)
        ci = dict(tr1.report._t_compile or {})
        trace, wall = run(2)
        ess = float(np.asarray(pm.ess(trace, var_names=["mu_a"])["mu_a"]))
        rhat = float(np.asarray(pm.rhat(trace, var_names=["mu_a"])["mu_a"]))
        n_div = int(np.sum(np.asarray(trace.get_sampler_stats("diverging"))))
        tree = np.asarray(trace.get_sampler_stats("tree_size"), dtype=np.float64)
        leapfrogs = float(tree.sum())
        stat_names = trace.stat_names or set()
        n_rescued = int(np.sum(np.asarray(
            trace.get_sampler_stats("rescued")))) \
            if "rescued" in stat_names else None
        scale = np.asarray(trace.get_sampler_stats("step_size_scale")) \
            if "step_size_scale" in stat_names else None
        min_scale = float(scale.min()) if scale is not None else None
        print(json.dumps({
            "chains": chains, "draws": draws, "tune": tune,
            "wall_s": round(wall, 2),
            # honest compile accounting: lower_s = trace,
            # compile_s = pure XLA compile (persistent-cache hit -> ~0);
            # first_call_wall_s = the old conflated "compile" number
            # (compile + a full warmup/draw run)
            "lower_s": ci.get("lower_s"), "compile_s": ci.get("compile_s"),
            "first_call_wall_s": round(first_wall, 2),
            "ess_mu_a": round(ess, 1),
            "ess_per_sec": round(ess / wall, 2),
            "kept_draws_per_sec": round(draws * chains / wall, 1),
            "post_tune_leapfrogs_per_sec": round(leapfrogs / wall, 0),
            "rhat": round(rhat, 4), "divergences": n_div,
            "div_frac": round(n_div / (draws * chains), 5),
            "rescued": n_rescued,
            "min_eps_scale": min_scale,
            "backend": jax.default_backend(),
        }), flush=True)


if __name__ == "__main__":
    main()
