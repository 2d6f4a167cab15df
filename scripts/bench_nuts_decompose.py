#!/usr/bin/env python
"""Layer-by-layer decomposition of the NUTS inner loop on the current
backend (follow-up to bench_nuts_profile.py: when production costs much
more per leapfrog than a bare leapfrog scan, this says whether the cost is
in HOW the loop is executed or in the tree algorithm). Times, at a fixed
chain batch, cost per leapfrog of:

  1. scan      — lax.scan of K leapfrogs (the pipelined baseline)
  2. while     — identical K leapfrogs under lax.while_loop (adds the
                 dynamic-trip-count predicate sync per iteration)
  3. subtree   — _build_subtree of K leaves (adds checkpoint/U-turn/RNG
                 bookkeeping per leaf)
  4. nuts_draw — one full tree to depth log2(K) (adds outer doubling)
  5. kernel    — production kernel_step (adds momentum draw, DA/Welford
                 adaptation, stats, decode-free)

Prints one line per layer with us/leapfrog and the ratio to layer 1.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp


def timed(fn, *args, reps=20):
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
    from pymc3_tpu.step_methods.hmc.nuts import _build_subtree, nuts_draw
    from pymc3_tpu.step_methods.hmc.integration import (
        IntegrationState, leapfrog, compute_state)
    from pymc3_tpu.step_methods.arraystep import TuneContext

    chains = int(os.environ.get("DEC_CHAINS", 256))
    K = int(os.environ.get("DEC_LEAVES", 32))
    model = build_model(pm)
    logp_fn = model.make_logp_fn()
    vg = jax.value_and_grad(logp_fn)
    dim = model.ndim
    print(f"backend={jax.default_backend()} chains={chains} dim={dim} K={K}")

    rng = np.random.RandomState(0)
    q = jnp.asarray(rng.randn(chains, dim).astype(floatX())) * 0.1
    p = jnp.asarray(rng.randn(chains, dim).astype(floatX()))
    var = jnp.ones((dim,), floatX())
    eps = jnp.asarray(0.02, floatX())
    keys = jax.random.split(jax.random.PRNGKey(0), chains)

    def start_state(q1, p1):
        return compute_state(vg, var, q1, p1)

    starts = jax.jit(jax.vmap(start_state))(q, p)

    # 1. scan of K leapfrogs
    def scan_chain(st):
        def body(s, _):
            return leapfrog(vg, var, eps, s), ()
        out, _ = jax.lax.scan(body, st, None, length=K)
        return out.q

    f_scan = jax.jit(jax.vmap(scan_chain))
    t = timed(f_scan, starts)
    base = t / K
    print(f"1 scan      {base*1e6:9.1f} us/leapfrog   1.00x")

    # 2. same K leapfrogs under while_loop (dynamic trip count)
    def while_chain(st, k):
        def cond(c):
            return c[0] < k
        def body(c):
            i, s = c
            return i + 1, leapfrog(vg, var, eps, s)
        _, out = jax.lax.while_loop(cond, body,
                                    (jnp.asarray(0, jnp.int32), st))
        return out.q

    f_while = jax.jit(jax.vmap(while_chain, in_axes=(0, None)))
    t = timed(f_while, starts, jnp.asarray(K, jnp.int32))
    print(f"2 while     {t/K*1e6:9.1f} us/leapfrog   {t/K/base:.2f}x")

    # 3. _build_subtree of K leaves
    mtd = int(np.log2(K)) + 2

    def subtree_chain(key, st):
        s = _build_subtree(key, st, eps, jnp.asarray(K, jnp.int32),
                           st.energy, var, vg,
                           jnp.asarray(1000.0, floatX()), mtd)
        return s.prop.q, s.leaf_idx

    f_sub = jax.jit(jax.vmap(subtree_chain))
    qf, nleaf = f_sub(keys, starts)
    n_done = float(np.mean(np.asarray(nleaf)))
    t = timed(f_sub, keys, starts)
    print(f"3 subtree   {t/n_done*1e6:9.1f} us/leapfrog   "
          f"{t/n_done/base:.2f}x   (mean leaves {n_done:.1f}/{K})")

    # 4. one full nuts_draw to depth log2(K) (no adaptation)
    depth_cap = int(np.log2(K))

    def draw_chain(key, st):
        tr = nuts_draw(key, st, st.energy, eps, var, vg,
                       jnp.asarray(depth_cap, jnp.int32),
                       jnp.asarray(1000.0, floatX()), depth_cap)
        return tr.prop.q, tr.n_leapfrog

    f_draw = jax.jit(jax.vmap(draw_chain))
    _, nlf = f_draw(keys, starts)
    n_done = float(np.mean(np.asarray(nlf)))
    t = timed(f_draw, keys, starts)
    print(f"4 nuts_draw {t/n_done*1e6:9.1f} us/leapfrog   "
          f"{t/n_done/base:.2f}x   (mean leapfrogs {n_done:.1f})")

    # 5. production kernel_step (fixed tune ctx, includes DA/Welford)
    step = pm.NUTS(model=model, axis_name="chains_local")
    state0 = jax.jit(jax.vmap(step.kernel_init))(
        jnp.broadcast_to(q[0], (chains, dim)))

    def kstep(keys, qq, st):
        def one(k, q1, s1):
            tctx = TuneContext(jnp.asarray(False), jnp.asarray(500, jnp.int32),
                               500)
            q2, s2, stats = step.kernel_step(k, q1, s1, tctx)
            return q2, stats["tree_size"]
        return jax.vmap(one, axis_name="chains_local")(keys, qq, st)

    f_k = jax.jit(kstep)
    _, tsz = f_k(keys, q, state0)
    n_done = float(np.mean(np.asarray(tsz)))
    t = timed(f_k, keys, q, state0)
    print(f"5 kernel    {t/n_done*1e6:9.1f} us/leapfrog   "
          f"{t/n_done/base:.2f}x   (mean tree {n_done:.1f})")

    # 6. production-shaped program: lax.scan of T kernel_steps with a
    # realistic adapted step size (isolates scan-of-while pathologies from
    # single-call dispatch latency)
    T = int(os.environ.get("DEC_DRAWS", 50))
    eps_real = float(os.environ.get("DEC_EPS", 0.04))
    import dataclasses

    state0 = jax.tree_util.tree_map(lambda x: x, state0)
    da0 = state0.da._replace(
        log_step=jnp.full_like(state0.da.log_step, np.log(eps_real)),
        log_bar_step=jnp.full_like(state0.da.log_bar_step,
                                   np.log(eps_real)))
    state0 = state0._replace(da=da0)
    draw_keys = jax.random.split(jax.random.PRNGKey(7), T * chains)
    draw_keys = draw_keys.reshape(T, chains, 2)

    def kblock(dkeys, qq, st):
        def one(k1, q1, s1):
            tctx = TuneContext(jnp.asarray(False),
                               jnp.asarray(500, jnp.int32), 500)
            q2, s2, stats = step.kernel_step(k1, q1, s1, tctx)
            return q2, s2, stats["tree_size"]

        def body(c, k):
            qc, sc = c
            q2, s2, tsz = jax.vmap(one, axis_name="chains_local")(k, qc, sc)
            return (q2, s2), tsz

        (_, _), tszs = jax.lax.scan(body, (qq, st), dkeys)
        return tszs

    f_b = jax.jit(kblock)
    tszs = f_b(draw_keys, q, state0)
    n_leap = float(np.sum(np.asarray(tszs)))
    t = timed(f_b, draw_keys, q, state0, reps=3)
    per_lane_leaf = t / (n_leap / chains)
    print(f"6 scan({T}) {per_lane_leaf*1e6:9.1f} us/leapfrog   "
          f"{per_lane_leaf/base:.2f}x   (mean tree "
          f"{n_leap/(T*chains):.1f}, eps {eps_real})")


if __name__ == "__main__":
    main()
