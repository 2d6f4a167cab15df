#!/usr/bin/env python
"""Secondary benchmark suite: the remaining reference asv analogs
(cf. ``/root/reference/benchmarks/benchmarks/benchmarks.py``):

  best      — BEST two-group StudentT drug evaluation (``:99-137``)
  mixture   — 3-component marginal NormalMixture, worst-case ESS (``:171-183``)
  ode       — 1-state 2-param freefall ODE (``:214-263``)

Each prints one JSON line {suite, ess_per_sec, ...}. ``bench.py`` remains
the single metric of record (radon ESS/s/chip).

Usage: python scripts/bench_suite.py [best|mixture|ode ...]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

DRUG = np.array([101, 100, 102, 104, 102, 97, 105, 105, 98, 101,
                 100, 123, 105, 103, 100, 95, 102, 106, 109, 102, 82,
                 102, 100, 102, 102, 101, 102, 102, 103, 103, 97, 97,
                 103, 101, 97, 104, 96, 103, 124, 101, 101, 100, 101,
                 101, 104, 100, 101], dtype=np.float64)
PLACEBO = np.array([99, 101, 100, 101, 102, 100, 97, 101, 104, 101,
                    102, 102, 100, 105, 88, 101, 100, 104, 100, 100,
                    100, 101, 102, 103, 97, 101, 101, 100, 101, 99,
                    101, 100, 100, 101, 100, 99, 101, 100, 102, 99,
                    100, 99], dtype=np.float64)


def best_model(pm):
    """BEST two-group comparison (benchmarks.py:99-137)."""
    y = np.r_[DRUG, PLACEBO]
    y_mean, y_std = y.mean(), y.std() * 2
    with pm.Model() as model:
        g1_mean = pm.Normal("group1_mean", y_mean, sigma=y_std)
        g2_mean = pm.Normal("group2_mean", y_mean, sigma=y_std)
        g1_std = pm.Uniform("group1_std", lower=1, upper=10)
        g2_std = pm.Uniform("group2_std", lower=1, upper=10)
        nu = pm.Exponential("nu_minus_one", 1 / 29.0) + 1
        pm.StudentT("drug", nu=nu, mu=g1_mean, lam=g1_std ** -2,
                    observed=DRUG)
        pm.StudentT("placebo", nu=nu, mu=g2_mean, lam=g2_std ** -2,
                    observed=PLACEBO)
        diff = pm.Deterministic("difference_of_means", g1_mean - g2_mean)
        pm.Deterministic("difference_of_stds", g1_std - g2_std)
        pm.Deterministic(
            "effect_size",
            diff / pm.math.sqrt((g1_std ** 2 + g2_std ** 2) / 2))
    return model, ["difference_of_means"]


def mixture_model(pm):
    """3-component marginal mixture (benchmarks.py:48-72)."""
    rng = np.random.RandomState(1234)
    size = 1000
    w_true = np.array([0.35, 0.4, 0.25])
    mu_true = np.array([0.0, 2.0, 5.0])
    sigma = np.array([0.5, 0.5, 1.0])
    component = rng.choice(mu_true.size, size=size, p=w_true)
    x = rng.normal(mu_true[component], sigma[component], size=size)

    from pymc3_tpu.node import apply as node_apply
    import jax.numpy as jnp

    with pm.Model() as model:
        w = pm.Dirichlet("w", a=np.ones_like(w_true))
        mu = pm.Normal("mu", mu=0.0, sigma=10.0, shape=3,
                       testval=mu_true.copy())
        pm.Potential("enforce_order", node_apply(
            lambda m: jnp.where(m[0] <= m[1], 0.0, -np.inf)
            + jnp.where(m[1] <= m[2], 0.0, -np.inf), mu))
        tau = pm.Gamma("tau", alpha=1.0, beta=1.0, shape=3,
                       testval=1.0 / sigma ** 2)
        pm.NormalMixture("x_obs", w=w, mu=mu, tau=tau, observed=x)
    return model, ["mu"]


def ode_model(pm):
    """1-state 2-param freefall ODE (benchmarks.py:214-263)."""
    def freefall(y, t, p):
        return 2.0 * p[1] - p[0] * y[0]

    times = np.arange(0, 10, 0.5)
    y_obs = np.array([-2.01, 9.49, 15.58, 16.57, 27.58, 32.26, 35.13,
                      38.07, 37.36, 38.83, 44.86, 43.58, 44.59, 42.75,
                      46.9, 49.32, 44.06, 49.86, 46.48, 48.18]).reshape(-1, 1)
    ode = pm.ode.DifferentialEquation(func=freefall, times=times,
                                      n_states=1, n_theta=2, t0=0)
    with pm.Model() as model:
        sigma = pm.HalfCauchy("sigma", 1)
        gamma = pm.Lognormal("gamma", 0, 1)
        sol = ode(y0=[0], theta=[gamma, 9.8])
        pm.Normal("Y", mu=sol, sigma=sigma, observed=y_obs)
    return model, ["sigma", "gamma"]


def gp_model(pm):
    """GP regression with sampled hyperparameters (BASELINE target config
    #4, cf. ``pymc3/gp/gp.py:344``): Marginal GP on n=200 observations,
    NUTS over (lengthscale, amplitude, noise)."""
    rng = np.random.RandomState(21)
    n = 200
    X = np.sort(rng.uniform(0, 4, n))[:, None].astype(np.float32)
    f_true = np.sin(2 * X[:, 0]) + 0.5 * np.cos(5 * X[:, 0])
    y = (f_true + 0.3 * rng.randn(n)).astype(np.float32)
    with pm.Model() as model:
        ls = pm.Gamma("ls", alpha=2, beta=2)
        eta = pm.HalfNormal("eta", sigma=2)
        cov = (eta ** 2) * pm.gp.cov.ExpQuad(1, ls)
        gp = pm.gp.Marginal(cov_func=cov)
        sigma = pm.HalfNormal("sigma", sigma=1)
        gp.marginal_likelihood("y", X=X, y=y, noise=sigma)
    return model, ["ls", "eta", "sigma"]


def schools_model(pm):
    """Eight-schools centered hierarchical Normal (BASELINE target config
    #1, cf. ``pymc3/examples/gelman_schools.py``). Centered is the
    target's parameterization; it needs target_accept 0.95 + 2000 tune to
    traverse the funnel (r4 recorded R-hat 1.18 at 0.8/1000 — not a
    usable number)."""
    y = np.array([28., 8., -3., 7., -1., 1., 18., 12.], dtype=np.float32)
    s = np.array([15., 10., 16., 11., 9., 11., 10., 18.], dtype=np.float32)
    with pm.Model() as model:
        mu = pm.Normal("mu", mu=0, sigma=5)
        tau = pm.HalfCauchy("tau", beta=5)
        theta = pm.Normal("theta", mu=mu, sigma=tau, shape=8)
        pm.Normal("obs", mu=theta, sigma=s, observed=y)
    return model, ["mu", "tau"]


def schools_noncentered_model(pm):
    """Non-centered companion (same posterior over (mu, tau), no funnel
    in the sampled geometry) — the contrast row and the moment-reference
    model for the centered target."""
    y = np.array([28., 8., -3., 7., -1., 1., 18., 12.], dtype=np.float32)
    s = np.array([15., 10., 16., 11., 9., 11., 10., 18.], dtype=np.float32)
    with pm.Model() as model:
        mu = pm.Normal("mu", mu=0, sigma=5)
        tau = pm.HalfCauchy("tau", beta=5)
        eta = pm.Normal("eta", mu=0.0, sigma=1.0, shape=8)
        pm.Normal("obs", mu=mu + tau * eta, sigma=s, observed=y)
    return model, ["mu", "tau"]


SUITES = {
    "schools": (schools_model,
                dict(draws=2000, tune=2000, chains=4, target_accept=0.95)),
    "schools_noncentered": (schools_noncentered_model,
                            dict(draws=2000, tune=1000, chains=4)),
    "best": (best_model, dict(draws=20000, tune=1000, chains=4)),
    "mixture": (mixture_model, dict(draws=2000, tune=1000, chains=4)),
    "ode": (ode_model, dict(draws=500, tune=1000, chains=2)),
    "gp": (gp_model, dict(draws=500, tune=500, chains=4)),
}

# moment-reference model overrides: the centered schools target is
# validated against the non-centered formulation of the SAME posterior
REF_BUILDERS = {"schools": schools_noncentered_model}


def posterior_moments(pm, trace, var_names):
    """Per-element posterior mean/sd/MCSE for the tracked variables."""
    out = {}
    ess_tbl = pm.ess(trace, var_names=var_names)
    for v in var_names:
        # float64 accumulation: a sequential float32 reduce over 1M+
        # draws drifts ~0.2 posterior sds (caught by this file's own
        # z-gate at 512 chains — the "bias" was the benchmark script's)
        vals = np.asarray(trace[v], dtype=np.float64).reshape(
            len(trace[v]), -1)
        mean = vals.mean(axis=0)
        sd = vals.std(axis=0)
        ess = np.atleast_1d(np.asarray(ess_tbl[v], dtype=np.float64)).ravel()
        mcse = sd / np.sqrt(np.maximum(ess, 1.0))
        out[v] = {"mean": mean.tolist(), "sd": sd.tolist(),
                  "mcse": mcse.tolist()}
    return out


def moment_check(bench_m, ref_m, z_max=4.0, sd_rtol=0.2):
    """|Δmean|/MCSE gate (BASELINE.md: 'posterior moments agree within
    Monte-Carlo error') plus a relative sd gate."""
    worst_z, worst_sd = 0.0, 0.0
    for v in bench_m:
        mb, mr = (np.asarray(bench_m[v]["mean"]),
                  np.asarray(ref_m[v]["mean"]))
        eb, er = (np.asarray(bench_m[v]["mcse"]),
                  np.asarray(ref_m[v]["mcse"]))
        z = np.abs(mb - mr) / np.sqrt(eb ** 2 + er ** 2 + 1e-300)
        worst_z = max(worst_z, float(np.max(z)))
        sb, sr = np.asarray(bench_m[v]["sd"]), np.asarray(ref_m[v]["sd"])
        rel = np.abs(sb - sr) / np.maximum(np.abs(sr), 1e-12)
        worst_sd = max(worst_sd, float(np.max(rel)))
    return {"pass": bool(worst_z < z_max and worst_sd < sd_rtol),
            "max_z": round(worst_z, 2), "max_sd_rel": round(worst_sd, 3)}


def main():
    import jax
    import pymc3_tpu as pm
    from pymc3_tpu.config import enable_compilation_cache
    enable_compilation_cache()

    names = sys.argv[1:] or list(SUITES)
    for name in names:
        build, cfg = SUITES[name]
        cfg = dict(cfg)
        chains = int(os.environ.get("SUITE_CHAINS", cfg["chains"]))
        cfg["chains"] = chains
        model, ess_vars = build(pm)
        # above 8 chains, record only the tracked variables and the
        # divergence stat, as bench.py does; asv-size runs keep the full
        # trace
        extra = {}
        if cfg["chains"] > 8:
            extra = dict(trace=list(ess_vars),
                         record_stats=["diverging"])
        with model:
            # compile pass, then the measured pass
            pm.sample(model=model, progressbar=False, random_seed=1,
                      compute_convergence_checks=False, **cfg, **extra)
            t0 = time.time()
            trace = pm.sample(model=model, progressbar=False, random_seed=2,
                              compute_convergence_checks=False, **cfg,
                              **extra)
            wall = time.time() - t0
        ess_tbl = pm.ess(trace, var_names=ess_vars)
        # worst-case (min) ESS across the tracked vars, per reference
        ess = float(min(np.min(np.asarray(ess_tbl[v])) for v in ess_vars))
        rhat_tbl = pm.rhat(trace, var_names=ess_vars)
        rhat = float(max(np.max(np.asarray(rhat_tbl[v])) for v in ess_vars))

        # moment validation (BASELINE.md procedure): an independent
        # longer reference run of the same posterior — 4x draws, deep
        # tune, target_accept 0.95; schools validates centered-vs-
        # non-centered (same posterior, funnel-free geometry)
        ref_build = REF_BUILDERS.get(name, build)
        ref_model, _ = ref_build(pm)
        ref_cfg = dict(draws=min(4 * cfg["draws"], 40000),
                       tune=max(cfg["tune"], 2000), chains=4,
                       target_accept=0.95)
        ref_trace = pm.sample(model=ref_model, progressbar=False,
                              random_seed=7, trace=list(ess_vars),
                              record_stats=["diverging"],
                              compute_convergence_checks=False, **ref_cfg)
        ref_rhat_tbl = pm.rhat(ref_trace, var_names=ess_vars)
        ref_rhat = float(max(np.max(np.asarray(ref_rhat_tbl[v]))
                             for v in ess_vars))
        bench_m = posterior_moments(pm, trace, ess_vars)
        ref_m = posterior_moments(pm, ref_trace, ess_vars)
        check = moment_check(bench_m, ref_m)
        vs_baseline = None
        base_path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "BASELINE_CPU.json")
        if os.path.exists(base_path):
            with open(base_path) as f:
                base_cfg = json.load(f).get("configs", {}).get(name, {})
            if base_cfg.get("ess_per_sec") and \
                    base_cfg.get("chains") == chains and \
                    base_cfg.get("draws") == cfg["draws"] and \
                    base_cfg.get("tune") == cfg["tune"]:
                vs_baseline = round(
                    (ess / wall) / float(base_cfg["ess_per_sec"]), 2)
        print(json.dumps({
            "suite": name, "ess_per_sec": round(ess / wall, 2),
            "ess_min": round(ess, 1), "wall_s": round(wall, 2),
            "rhat_max": round(rhat, 4), **cfg,
            "vs_baseline": vs_baseline,
            "moment_check": "pass" if check["pass"] else "FAIL",
            "moment_max_z": check["max_z"],
            "moment_max_sd_rel": check["max_sd_rel"],
            "moments": {v: {"mean": [round(x, 3) for x in
                                     bench_m[v]["mean"]],
                            "sd": [round(x, 3) for x in bench_m[v]["sd"]]}
                        for v in ess_vars},
            "ref_moments": {v: {"mean": [round(x, 3) for x in
                                         ref_m[v]["mean"]],
                                "sd": [round(x, 3) for x in
                                       ref_m[v]["sd"]]}
                            for v in ess_vars},
            "ref_rhat_max": round(ref_rhat, 4),
            "backend": jax.default_backend(),
        }), flush=True)


if __name__ == "__main__":
    main()
