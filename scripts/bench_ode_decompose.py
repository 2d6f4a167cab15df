#!/usr/bin/env python
"""ODE-under-NUTS cost decomposition: where the freefall
benchmark's time goes, on the current backend.

Layers:
  1. solve          — one DOPRI5 solve (fwd only), per max_steps bound
  2. logp+grad      — model logp + reverse pass through the bounded scan
  3. vmapped chains — layer 2 at chains in {2, 16, 64, 256}: per-chain
                      cost shows how far the asv 2-chain config
                      underfills the chip
  4. end-to-end     — NUTS ESS/s at the asv config and at 16 chains,
                      with the calibrated vs blanket step bound

Prints one JSON line per measurement.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def timed(fn, *args, reps=20):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def build(pm, max_steps=None):
    def freefall(y, t, p):
        return 2.0 * p[1] - p[0] * y[0]

    times = np.arange(0, 10, 0.5)
    y_obs = np.array([-2.01, 9.49, 15.58, 16.57, 27.58, 32.26, 35.13,
                      38.07, 37.36, 38.83, 44.86, 43.58, 44.59, 42.75,
                      46.9, 49.32, 44.06, 49.86, 46.48, 48.18]).reshape(-1, 1)
    ode = pm.ode.DifferentialEquation(func=freefall, times=times,
                                      n_states=1, n_theta=2, t0=0,
                                      max_steps=max_steps)
    with pm.Model() as model:
        sigma = pm.HalfCauchy("sigma", 1)
        gamma = pm.Lognormal("gamma", 0, 1)
        sol = ode(y0=[0], theta=[gamma, 9.8])
        pm.Normal("Y", mu=sol, sigma=sigma, observed=y_obs)
    return model, ode


def main():
    import jax
    import jax.numpy as jnp
    import pymc3_tpu as pm
    from pymc3_tpu.config import enable_compilation_cache
    enable_compilation_cache()
    backend = jax.default_backend()

    for bound_name, ms in (("blanket_320", 320), ("auto_calibrated", None)):
        model, ode = build(pm, max_steps=ms)
        print(json.dumps({"probe": "bound", "name": bound_name,
                          "max_steps": ode.max_steps}), flush=True)

        # layer 1: forward solve
        solve = jax.jit(lambda th: ode._solve(jnp.zeros(1), th))
        th0 = jnp.asarray([0.5, 9.8])
        t_solve = timed(solve, th0)

        # layer 2: fused logp+grad at one point
        lp = model.make_logp_fn()
        q0 = jnp.asarray(model.dict_to_array(model.test_point))
        vg = jax.jit(jax.value_and_grad(lp))
        t_vg = timed(vg, q0)
        print(json.dumps({
            "probe": "layers", "bound": bound_name,
            "solve_us": round(t_solve * 1e6, 1),
            "logp_grad_us": round(t_vg * 1e6, 1)}), flush=True)

        # layer 3: vmapped chains
        for chains in (2, 16, 64, 256):
            Q = jnp.broadcast_to(q0, (chains,) + q0.shape)
            vgv = jax.jit(jax.vmap(jax.value_and_grad(lp)))
            t = timed(vgv, Q)
            print(json.dumps({
                "probe": "vmap", "bound": bound_name, "chains": chains,
                "total_us": round(t * 1e6, 1),
                "per_chain_us": round(t * 1e6 / chains, 2)}), flush=True)

        # layer 4: end-to-end at the asv config and a larger chain count
        for chains in (2, 16):
            with model:
                pm.sample(draws=500, tune=1000, chains=chains,
                          progressbar=False, random_seed=1,
                          compute_convergence_checks=False)
                t0 = time.time()
                tr = pm.sample(draws=500, tune=1000, chains=chains,
                               progressbar=False, random_seed=2,
                               compute_convergence_checks=False)
                wall = time.time() - t0
            ess_tbl = pm.ess(tr, var_names=["sigma", "gamma"])
            ess = float(min(np.min(np.asarray(ess_tbl[v]))
                            for v in ("sigma", "gamma")))
            print(json.dumps({
                "probe": "end_to_end", "bound": bound_name,
                "chains": chains, "wall_s": round(wall, 2),
                "ess_min": round(ess, 1),
                "ess_per_sec": round(ess / wall, 2),
                "backend": backend}), flush=True)


if __name__ == "__main__":
    main()
