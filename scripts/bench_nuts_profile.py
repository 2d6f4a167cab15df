#!/usr/bin/env python
"""Decompose NUTS step cost on the current backend (SURVEY §7.9 follow-up).

Measures, for the radon model at a given vmapped chain count:
  1. speed-of-light: one vmapped fused logp+grad evaluation (the leapfrog's
     irreducible compute),
  2. a bare vmapped leapfrog chain (scan of K leapfrogs, no NUTS
     bookkeeping),
  3. one full NUTS tree-extension iteration (the production while_loop
     body),
to locate how much of each tree-loop iteration is U-turn/checkpoint
bookkeeping vs model gradient. Informs whether a fused leapfrog kernel
could win (it can only fuse the elementwise kick/drift around the
model-defined grad graph, which XLA already fuses).
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp


def timed(fn, *args, reps=50):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main():
    import pymc3_tpu as pm
    from pymc3_tpu.config import enable_compilation_cache, floatX
    enable_compilation_cache()
    from bench import build_model

    chains = int(os.environ.get("PROF_CHAINS", 256))
    model = build_model(pm)
    logp_fn = model.make_logp_fn()
    dim = model.ndim
    print(f"backend={jax.default_backend()} chains={chains} dim={dim}")

    rng = np.random.RandomState(0)
    q = jnp.asarray(rng.randn(chains, dim).astype(floatX())) * 0.1
    p = jnp.asarray(rng.randn(chains, dim).astype(floatX()))
    eps = jnp.float32(0.02)

    # 1. speed-of-light: one batched fused logp+grad
    vg = jax.jit(jax.vmap(jax.value_and_grad(logp_fn)))
    t_vg = timed(vg, q)
    print(f"logp+grad (batch {chains}):      {t_vg*1e6:9.1f} us "
          f"({chains/t_vg:,.0f} evals/s)")

    # 2. bare leapfrog scan: K kicks/drifts, no tree bookkeeping
    K = 32

    def leapfrog_chain(q0, p0):
        def body(carry, _):
            q, p = carry
            g = jax.vmap(jax.grad(logp_fn))(q)
            p_half = p + 0.5 * eps * g
            q_new = q + eps * p_half
            g_new = jax.vmap(jax.grad(logp_fn))(q_new)
            p_new = p_half + 0.5 * eps * g_new
            return (q_new, p_new), ()
        (qf, pf), _ = jax.lax.scan(body, (q0, p0), None, length=K)
        return qf, pf

    lf = jax.jit(leapfrog_chain)
    t_lf = timed(lf, q, p, reps=10)
    per_lf = t_lf / K
    print(f"bare leapfrog (scan of {K}):     {per_lf*1e6:9.1f} us/leapfrog "
          f"({chains/per_lf:,.0f} leapfrogs/s; {per_lf/ (2*t_vg):4.2f}x "
          f"speed-of-light [2 grads each])")

    # 3. production NUTS: steady-state leapfrogs/s (second run; tuning
    # draws kept so every leapfrog of the run is counted)
    def run(seed):
        t0 = time.time()
        tr = pm.sample(draws=200, tune=200, chains=chains, model=model,
                       progressbar=False, random_seed=seed,
                       target_accept=0.95, axis_name="chains_local",
                       discard_tuned_samples=False,
                       trace=["mu_a"],  # the sampler, not the trace copy
                       compute_convergence_checks=False)
        return tr, time.time() - t0

    run(3)  # compile
    trace, wall = run(4)
    tree = np.asarray(trace.get_sampler_stats("tree_size"), np.float64)
    n_leap = float(tree.sum())
    prod_rate = n_leap / wall
    bare_rate = chains / per_lf
    print(f"NUTS production (steady state): {n_leap:,.0f} leapfrogs "
          f"(tune+draws) in {wall:.1f}s -> {prod_rate:,.0f} leapfrogs/s")
    print(f"production overhead vs bare leapfrog: "
          f"{bare_rate/prod_rate:.2f}x  "
          f"(tree bookkeeping + lockstep depth variance)")
    print(f"bare-leapfrog overhead vs speed-of-light: "
          f"{per_lf/(2*t_vg):.2f}x (2 grads per leapfrog)")


if __name__ == "__main__":
    main()
