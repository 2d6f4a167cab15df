#!/usr/bin/env python
"""Bring-up check: drive the main paths once on one NVIDIA GPU.

    python chip_smoke.py                  # one GPU, full sizes
    python chip_smoke.py --four           # four GPUs: the sharded path only
    JAX_PLATFORMS=cpu python chip_smoke.py --tiny          # CPU rehearsal
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python chip_smoke.py --four --tiny                 # 4 virtual devices

Phases, each of which raises when a check fails (so the exit code is
non-zero and no result line is printed):

1. device: a GPU is required unless ``--tiny``. Prints ``device_kind``, the
   device count, the jax/jaxlib versions, the card's name and power limit
   (``nvidia-smi``), the compile-cache directory and the matmul precision.
2. radon NUTS through ``pm.sample`` on the full data (919 rows, 85 counties,
   175 unconstrained dimensions, float32): 4 chains with the full trace and
   all sampler stats, then 2048 chains with pooled adaptation. Gates:
   R-hat(mu_a), divergence fraction, and the mu_a moment check against
   ``BASELINE_CPU.json``.
3. radon logp at 64 seeded points against a float64 scipy evaluation on the
   host, and its gradient against the same jitted program on the CPU.
4. GP: ``gp.Marginal`` (n=200) through ``pm.sample``; ``stationary_cov`` for
   all five kinds at n=m=4096 against a float64 numpy reference, and its
   custom VJP at n=512 against autodiff of the plain form.
5. SMC evidence against the analytic value; minibatch ADVI loss finite and
   decreasing.

``--four`` runs only radon at 2048 chains sharded over four devices against
the same configuration on one device, and
``__graft_entry__.dryrun_multichip(4)``.

Times printed are bring-up observations, labelled with the card; they are
not benchmark numbers. The last line of stdout is
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np

# Full sizes are the real widths (radon at its full data, GP at n=200, the
# covariance at n=m=4096). --tiny keeps every phase and cuts only sizes
# (and, since short runs cannot meet them, the R-hat and divergence
# limits) so the control flow can be rehearsed on a CPU.
FULL = dict(
    radon_asv=dict(chains=4, tune=1000, draws=2000),
    radon_pooled=dict(chains=2048, tune=500, draws=500),
    rhat_max=1.01, div_frac_max=1e-3, logp_points=64,
    gp=dict(chains=4, tune=500, draws=500),
    cov_n=4096, cov_grad_n=512, smc_draws=4096,
    advi=dict(rows=50000, steps=3000),
)
TINY = dict(
    radon_asv=dict(chains=4, tune=250, draws=250),
    radon_pooled=dict(chains=32, tune=150, draws=150),
    rhat_max=1.1, div_frac_max=0.02, logp_points=8,
    gp=dict(chains=4, tune=100, draws=100),
    cov_n=256, cov_grad_n=64, smc_draws=1024,
    advi=dict(rows=5000, steps=600),
)

_SQRT3, _SQRT5 = np.sqrt(3.0), np.sqrt(5.0)
# float64 k(r) per stationary kind, r = distance in lengthscale units
NP_COV = {
    "expquad": lambda r: np.exp(-0.5 * r ** 2),
    "matern52": lambda r: (1 + _SQRT5 * r + 5.0 / 3.0 * r ** 2)
    * np.exp(-_SQRT5 * r),
    "matern32": lambda r: (1 + _SQRT3 * r) * np.exp(-_SQRT3 * r),
    "matern12": lambda r: np.exp(-r),
    "exponential": lambda r: np.exp(-0.5 * r),
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def report(name, label, **fields):
    print(f"[{name} | {label}] " + json.dumps(fields), flush=True)


# -- phase 1 ------------------------------------------------------------------
def device_phase(args):
    import jax
    import jaxlib

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu" and not args.tiny:
        sys.exit(f"chip_smoke: needs an NVIDIA GPU; JAX found "
                 f"{dev.platform!r} ({dev.device_kind}). Use --tiny to "
                 f"rehearse on the CPU.")
    from bench import card_label
    from pymc3_tpu.config import enable_compilation_cache

    if dev.platform == "gpu":
        card = card_label()
    else:
        card = f"{dev.platform} rehearsal, no GPU"
    print(f"card: {card}")
    print(f"device_kind: {dev.device_kind}  platform: {dev.platform}  "
          f"count: {len(devs)}")
    print(f"jax {jax.__version__}  jaxlib {jaxlib.__version__}")
    print(f"compile cache: {enable_compilation_cache()}")
    print(f"matmul precision: {jax.config.jax_default_matmul_precision}")
    return dev, card


def peak_bytes(dev):
    stats = dev.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


# -- phase 2 ------------------------------------------------------------------
def radon_run(pm, model, cfg, label, name, dev, **kw):
    """One pm.sample call on the radon model; returns its mu_a moments."""
    from bench_suite import posterior_moments

    t0 = time.time()
    trace = pm.sample(model=model, progressbar=False, random_seed=11,
                      target_accept=0.9, **cfg, **kw)
    wall = time.time() - t0
    rhat = float(np.asarray(pm.rhat(trace, var_names=["mu_a"])["mu_a"]))
    ess = float(np.asarray(pm.ess(trace, var_names=["mu_a"])["mu_a"]))
    n_div = int(np.sum(trace.get_sampler_stats("diverging")))
    div_frac = n_div / float(cfg["chains"] * cfg["draws"])
    # tree_size of the kept draws only: tuning leapfrogs are not recorded
    leapfrogs = float(np.sum(trace.get_sampler_stats("tree_size")))
    compile_info = trace.report._t_compile or {}
    report(name, label, **cfg, wall_s=wall,
           lower_s=compile_info.get("lower_s"),
           compile_s=compile_info.get("compile_s"),
           peak_bytes_in_use=peak_bytes(dev), ess_mu_a=ess,
           kept_leapfrogs_per_wall_s=leapfrogs / wall, rhat_mu_a=rhat,
           divergences=n_div)
    return trace, rhat, div_frac, posterior_moments(pm, trace, ["mu_a"])


def radon_phase(pm, sizes, label, dev):
    from bench import build_model
    from bench_suite import moment_check

    with open(os.path.join(ROOT, "BASELINE_CPU.json")) as f:
        ref = json.load(f)["configs"]["radon"]["moments"]
    model = build_model(pm)
    check(model.ndim == 175, f"radon has {model.ndim} dims, expected 175")
    runs = [
        ("radon_4chains_full_trace", sizes["radon_asv"], {}),
        ("radon_pooled", sizes["radon_pooled"],
         dict(axis_name="chains_local", compute_convergence_checks=False)),
    ]
    for name, cfg, kw in runs:
        trace, rhat, div_frac, moments = radon_run(pm, model, cfg, label,
                                                   name, dev, **kw)
        if name == "radon_4chains_full_trace":
            check(set(trace.varnames) >= {"a", "b", "eps", "mu_b"}
                  and len(trace.stat_names) == 13,
                  "4-chain run lost part of the trace or the stats")
        mc = moment_check(moments, ref)
        print(f"  {name} moment check vs BASELINE_CPU.json: {mc}")
        check(rhat < sizes["rhat_max"], f"{name}: R-hat(mu_a) {rhat}")
        check(div_frac < sizes["div_frac_max"],
              f"{name}: divergence fraction {div_frac}")
        check(mc["pass"], f"{name}: mu_a moment check {mc}")
    return model


# -- phase 3 ------------------------------------------------------------------
def radon_logp_np(model, q):
    """float64 scipy density of the radon model at unconstrained ``q``,
    log-transform Jacobians included — independent of the traced logp."""
    from scipy import stats
    from bench import load_radon

    county_idx, floor, log_radon, _ = load_radon()
    pt = {k: np.asarray(v, np.float64)
          for k, v in model.array_to_dict(np.asarray(q, np.float64)).items()}
    lp = 0.0
    for prefix in ("a", "b"):
        lp += stats.norm.logpdf(pt[f"mu_{prefix}"], 0.0, 1e4)
        log_sigma = pt[f"sigma_{prefix}_log__"]
        lp += stats.halfcauchy.logpdf(np.exp(log_sigma), scale=5) + log_sigma
        lp += np.sum(stats.norm.logpdf(pt[prefix]))
    lp += stats.halfcauchy.logpdf(np.exp(pt["eps_log__"]), scale=5) \
        + pt["eps_log__"]
    a = pt["mu_a"] + np.exp(pt["sigma_a_log__"]) * pt["a"]
    b = pt["mu_b"] + np.exp(pt["sigma_b_log__"]) * pt["b"]
    mu = a[county_idx] + b[county_idx] * floor
    lp += np.sum(stats.norm.logpdf(log_radon.astype(np.float64), mu,
                                   np.exp(pt["eps_log__"])))
    return float(np.squeeze(lp))


def logp_phase(model, sizes, label, dev):
    import jax

    rng = np.random.default_rng(5)
    q0 = np.asarray(model.dict_to_array(model.test_point), np.float32)
    Q = (q0 + 0.5 * rng.standard_normal((sizes["logp_points"], q0.size))
         ).astype(np.float32)
    f = jax.jit(jax.vmap(model.make_logp_dlogp_fn()))
    lp_dev, g_dev = (np.asarray(x) for x in f(jax.device_put(Q, dev)))
    cpu = jax.devices("cpu")[0]
    lp_cpu, g_cpu = (np.asarray(x) for x in f(jax.device_put(Q, cpu)))
    lp_ref = np.array([radon_logp_np(model, q) for q in Q])
    rel = np.abs(lp_dev - lp_ref) / np.abs(lp_ref)
    report("radon_logp", label, points=len(Q), max_rel_err_vs_float64=
           float(rel.max()), max_abs_grad_diff_vs_cpu=
           float(np.abs(g_dev - g_cpu).max()), max_abs_grad=
           float(np.abs(g_cpu).max()))
    check(np.all(np.isfinite(lp_dev)) and np.all(np.isfinite(g_dev)),
          "non-finite logp or gradient")
    # float32 logp: relative 1e-5 of |logp| against the float64 reference
    check(rel.max() < 1e-5, f"logp relative error {rel.max()}")
    np.testing.assert_allclose(g_dev, g_cpu, rtol=1e-4, atol=1e-4)


# -- phase 4 ------------------------------------------------------------------
def gp_phase(pm, sizes, label, dev):
    import jax
    import jax.numpy as jnp
    from scipy.spatial.distance import cdist
    from bench_suite import gp_model
    from pymc3_tpu.gp.cov import (STATIONARY_KINDS, _apply_covfn,
                                  _sqdist_exact, stationary_cov)

    model, names = gp_model(pm)
    cfg = sizes["gp"]
    t0 = time.time()
    trace = pm.sample(model=model, progressbar=False, random_seed=21, **cfg)
    wall = time.time() - t0
    rhat = {v: float(np.max(np.asarray(r)))
            for v, r in pm.rhat(trace, var_names=names).items()}
    report("gp_marginal_n200", label, **cfg, wall_s=wall, rhat=rhat,
           peak_bytes_in_use=peak_bytes(dev))
    check(max(rhat.values()) < sizes["rhat_max"], f"GP R-hat {rhat}")

    rng = np.random.default_rng(7)
    n = sizes["cov_n"]
    cov = jax.jit(stationary_cov, static_argnames="kind")
    for d in (1, 4):
        X = rng.standard_normal((n, d)).astype(np.float32)
        Xs = rng.standard_normal((n, d)).astype(np.float32)
        r = cdist(X.astype(np.float64), Xs.astype(np.float64))
        Xd, Xsd = jax.device_put(X, dev), jax.device_put(Xs, dev)
        for kind in STATIONARY_KINDS:
            K = np.asarray(cov(Xd, Xsd, kind=kind))
            ref = NP_COV[kind](r)
            print(f"  stationary_cov {kind} n=m={n} d={d}: max abs err "
                  f"{np.abs(K - ref).max():.3g}")
            np.testing.assert_allclose(K, ref, rtol=1e-5, atol=1e-6)

    m = sizes["cov_grad_n"]
    X = jax.device_put(rng.standard_normal((m, 4)).astype(np.float32), dev)
    Xs = jax.device_put((rng.standard_normal((m, 4)) + 0.5)
                        .astype(np.float32), dev)
    for kind in STATIONARY_KINDS:
        g_op = jax.jit(jax.grad(lambda A, B: jnp.sum(jnp.sin(
            stationary_cov(A, B, kind=kind))), argnums=(0, 1)))(X, Xs)
        g_ref = jax.jit(jax.grad(lambda A, B: jnp.sum(jnp.sin(
            _apply_covfn(kind, _sqdist_exact(A, B)))), argnums=(0, 1)))(X, Xs)
        for a, b in zip(g_op, g_ref):
            a, b = np.asarray(a), np.asarray(b)
            err = np.abs(a - b).max() / np.abs(b).max()
            print(f"  stationary_cov VJP {kind} n={m}: max err / max|grad| "
                  f"{err:.3g}")
            # the closed form regroups sums that autodiff takes pairwise,
            # so compare normwise at float32 accumulation error
            check(err < 2e-4, f"VJP {kind}: relative error {err}")


# -- phase 5 ------------------------------------------------------------------
def smc_advi_phase(pm, sizes, label, dev):
    from scipy.special import betaln
    from pymc3_tpu.examples import minibatch_advi_logistic as logistic

    data = np.repeat([1, 0], [50, 50]).astype(np.int32)
    with pm.Model() as model:
        a = pm.Beta("a", 1.0, 1.0)
        pm.Bernoulli("y", a, observed=data)
    t0 = time.time()
    trace = pm.sample_smc(sizes["smc_draws"], model=model, random_seed=2)
    wall = time.time() - t0
    expected = betaln(51.0, 51.0) - betaln(1.0, 1.0)
    lml = float(trace.report.log_marginal_likelihood)
    report("smc_beta_binomial", label, particles=sizes["smc_draws"],
           wall_s=wall, log_evidence=lml, analytic=expected)
    check(abs(lml - expected) < 0.5, f"SMC log evidence {lml} vs {expected}")

    cfg = sizes["advi"]
    X, y, w_true = logistic.make_data(n=cfg["rows"])
    model = logistic.build_model(X, y)
    t0 = time.time()
    approx = pm.fit(n=cfg["steps"], method="advi", model=model,
                    progressbar=False, random_seed=3,
                    obj_optimizer=pm.variational.updates.adam(
                        learning_rate=0.02))
    wall = time.time() - t0
    hist = np.asarray(approx.hist)
    k = max(1, len(hist) // 10)
    first, last = float(hist[:k].mean()), float(hist[-k:].mean())
    report("advi_minibatch_logistic", label, **cfg, wall_s=wall,
           loss_first_tenth=first, loss_last_tenth=last,
           max_abs_w_err=float(np.abs(approx.mean - w_true).max()))
    check(len(hist) == cfg["steps"] and np.all(np.isfinite(hist)),
          "ADVI loss not finite")
    check(last < first, f"ADVI loss did not decrease ({first} -> {last})")


# -- --four -------------------------------------------------------------------
def four_phase(pm, sizes, label):
    import jax
    from bench import build_model
    from bench_suite import moment_check
    from pymc3_tpu.parallel import CHAIN_AXIS
    import __graft_entry__

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 devices, JAX sees {len(devs)}")
    model = build_model(pm)
    cfg = sizes["radon_pooled"]
    _, rhat4, _, m4 = radon_run(
        pm, model, cfg, label, "radon_sharded_4dev", devs[0],
        devices=devs, axis_name=CHAIN_AXIS, compute_convergence_checks=False)
    peaks = [peak_bytes(d) for d in devs]
    print(f"  peak_bytes_in_use per device after the sharded run: {peaks}")
    if devs[0].platform == "gpu":
        # the one-device runs below use only devs[0]; memory on the other
        # three can only come from the sharded run
        check(all(p for p in peaks), "a device held no chains")
    _, rhat1, _, m1 = radon_run(
        pm, model, cfg, label, "radon_one_device", devs[0],
        axis_name="chains_local", compute_convergence_checks=False)
    mc = moment_check(m4, m1)
    print(f"  sharded vs one-device mu_a moment check: {mc}")
    check(max(rhat4, rhat1) < sizes["rhat_max"],
          f"R-hat sharded {rhat4}, one device {rhat1}")
    check(mc["pass"], f"sharded vs one-device moments {mc}")
    t0 = time.time()
    __graft_entry__.dryrun_multichip(4)
    report("dryrun_multichip_4", label, wall_s=time.time() - t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="tiny sizes; allowed on the CPU (rehearsal)")
    ap.add_argument("--four", action="store_true",
                    help="only the four-device sharded path")
    args = ap.parse_args()
    sizes = TINY if args.tiny else FULL

    dev, card = device_phase(args)
    import jax
    import pymc3_tpu as pm

    label = f"{card}{' | tiny' if args.tiny else ''}"
    if args.four:
        four_phase(pm, sizes, label)
    else:
        model = radon_phase(pm, sizes, label, dev)
        logp_phase(model, sizes, label, dev)
        gp_phase(pm, sizes, label, dev)
        smc_advi_phase(pm, sizes, label, dev)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
