#!/usr/bin/env python
"""Compile-cost probe: pure XLA compile wall of the blocked radon-NUTS
program vs chain count.

The r3 sweep reported ``compile_wall_s`` = whole first sample() call, which
folds a full warmup+draw run into the "compile" number. This probe uses the
AOT split in ``_device_sample`` (trace = ``lower_s``, pure XLA compile =
``compile_s``) with a tiny draw count so run time is negligible, printing
one JSON line per chain count.

Modes (env):
  COMPILE_CACHE=fresh   — persistent cache off => cold compiles (default)
  COMPILE_CACHE=keep    — the persistent cache => warm-start proof
                          (run the script twice; second process should show
                          compile_s of seconds)
  COMPILE_TUNE/COMPILE_DRAWS — program constants (default 1000/2000 so the
                          cache entry matches bench.py's production config)
  COMPILE_BLOCK         — block size override (must also match production)

Usage: python scripts/bench_compile.py [chains ...]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import pymc3_tpu as pm
    from pymc3_tpu.config import enable_compilation_cache
    import jax

    mode = os.environ.get("COMPILE_CACHE", "fresh")
    if mode == "fresh":
        jax.config.update("jax_enable_compilation_cache", False)
    else:
        enable_compilation_cache()

    from bench import build_model
    model = build_model(pm)

    chain_counts = [int(c) for c in sys.argv[1:]] or [256, 2048, 8192]
    # production program constants: tune/draws are baked into the block
    # program (tune_arr/total_arr closure constants), so a warm start for
    # bench.py requires the SAME tune/draws here
    tune = int(os.environ.get("COMPILE_TUNE", 1000))
    draws = int(os.environ.get("COMPILE_DRAWS", 2000))
    block = os.environ.get("COMPILE_BLOCK")
    block = int(block) if block else None

    for chains in chain_counts:
        t0 = time.time()
        tr = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                       progressbar=False, random_seed=1,
                       target_accept=0.9, axis_name="chains_local",
                       trace=["mu_a"], block_size=block,
                       compute_convergence_checks=False)
        wall = time.time() - t0
        info = dict(tr.report._t_compile or {})
        print(json.dumps({
            "chains": chains, "tune": tune, "draws": draws,
            "cache_mode": mode,
            "lower_s": info.get("lower_s"),
            "compile_s": info.get("compile_s"),
            "block": info.get("block"), "n_blocks": info.get("n_blocks"),
            "total_wall_s": round(wall, 2),
            "backend": jax.default_backend(),
        }), flush=True)


if __name__ == "__main__":
    main()
