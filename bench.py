#!/usr/bin/env python
"""Benchmark of record: NUTS effective samples/sec/chip on the radon
hierarchical model (cf. BASELINE.md; reference harness
``benchmarks/benchmarks/benchmarks.py:25-45,160-186`` — the
``glm_hierarchical`` model with county varying intercept+slope,
metric = ESS(mu_a)/second, sampling wall time only).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Configuration: chains are a vmap batch axis (thousands per device),
mass-matrix adaptation is pooled across chains with an exact cross-chain
Welford ``psum`` (``quadpotential.py:welford_merge_psum``), and draws stream
device->host in fixed blocks so device memory stays bounded.

It measures a GPU and nothing else: without one it exits non-zero, and its
JSON names the device (``platform``, ``device_kind``, count) and the card's
power limit as ``nvidia-smi`` reports it.

``vs_baseline``: the reference (Theano, CPU) cannot run in this image, so
the documented stand-in baseline is THIS framework on the true-CPU backend
at the CONFIG-IDENTICAL draws/tune split (2000/1000, 4 chains — the asv
chain count, ``benchmarks.py:160-169``). Generate the per-config table for
ALL FIVE baseline configs with ``python scripts/bench_baseline_cpu_all.py``
(writes BASELINE_CPU.json); vs_baseline = GPU ESS/s / CPU ESS/s.
"""
import csv
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def load_radon():
    """radon.csv columns as arrays: (county_idx, floor, log_radon,
    n_counties) — 919 rows, 85 counties."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "pymc3_tpu", "examples", "data",
                           "radon.csv")) as f:
        rows = list(csv.DictReader(f))
    county_idx = np.array([int(r["county_code"]) for r in rows], np.int32)
    floor = np.array([float(r["floor"]) for r in rows])
    log_radon = np.array([float(r["log_radon"]) for r in rows], np.float32)
    n_counties = len({r["county"] for r in rows})
    return county_idx, floor, log_radon, n_counties


def card_label():
    """``name, power.limit`` of each visible NVIDIA card, from a child
    ``nvidia-smi`` that does not touch JAX; raises if there is none."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


def build_model(pm):
    county_idx, floor, log_radon, n_counties = load_radon()

    # exact reference parameterization (benchmarks.py:25-45): NON-centered
    # county effects (a = mu_a + sigma_a * a_raw)
    with pm.Model() as model:
        mu_a = pm.Normal("mu_a", mu=0.0, sigma=100.0 ** 2)
        sigma_a = pm.HalfCauchy("sigma_a", 5)
        mu_b = pm.Normal("mu_b", mu=0.0, sigma=100.0 ** 2)
        sigma_b = pm.HalfCauchy("sigma_b", 5)
        a_raw = pm.Normal("a", mu=0.0, sigma=1.0, shape=n_counties)
        b_raw = pm.Normal("b", mu=0.0, sigma=1.0, shape=n_counties)
        a = mu_a + sigma_a * a_raw
        b = mu_b + sigma_b * b_raw
        eps = pm.HalfCauchy("eps", 5)
        radon_est = a[county_idx] + b[county_idx] * floor
        pm.Normal("radon_like", mu=radon_est, sigma=eps,
                  observed=log_radon)
    return model


def run_config(pm, model, draws, tune, chains, target_accept, pooled, seed):
    axis_name = "chains_local" if pooled else None
    # Record only the metric variable (reference list-`trace` semantics,
    # `pymc3/sampling.py:268`) and the divergence stat: the metric needs
    # nothing else. What the full trace and all stats add (device->host
    # copy, per-chain trace assembly) has not been measured on the GPU;
    # BENCH_FULL_TRACE=1 runs that configuration.
    trace_arg = None if os.environ.get("BENCH_FULL_TRACE") else ["mu_a"]
    stats_arg = None if os.environ.get("BENCH_FULL_TRACE") else ["diverging"]
    t0 = time.time()
    trace = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                      progressbar=False, random_seed=seed,
                      target_accept=target_accept, axis_name=axis_name,
                      trace=trace_arg, record_stats=stats_arg,
                      compute_convergence_checks=False)
    wall = time.time() - t0
    return trace, wall


def main():
    import pymc3_tpu as pm
    from pymc3_tpu.config import enable_compilation_cache
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {dev.platform!r} "
                 f"({dev.device_kind}) and no GPU")
    card = card_label()
    enable_compilation_cache()

    draws = int(os.environ.get("BENCH_DRAWS", 2000))
    tune = int(os.environ.get("BENCH_TUNE", 1000))
    chains = int(os.environ.get("BENCH_CHAINS", 2048))
    target_accept = float(os.environ.get("BENCH_TARGET_ACCEPT", 0.9))
    pooled = os.environ.get("BENCH_POOLED", "1") != "0"

    model = build_model(pm)

    # first call pays compile; second measures steady-state throughput
    tr1, _ = run_config(pm, model, draws, tune, chains, target_accept,
                        pooled, seed=1)
    compile_info = dict(tr1.report._t_compile or {})
    trace, wall = run_config(pm, model, draws, tune, chains, target_accept,
                             pooled, seed=2)

    ess = float(np.asarray(pm.ess(trace, var_names=["mu_a"])["mu_a"]))
    ess_per_sec = ess / wall
    rhat = float(np.asarray(pm.rhat(trace, var_names=["mu_a"])["mu_a"]))
    n_div = int(np.sum(np.asarray(trace.get_sampler_stats("diverging"))))
    div_frac = n_div / float(draws * chains)

    # posterior-moment cross-check vs the CPU stand-in run (BASELINE.md:
    # "verify posterior moments agree within Monte-Carlo error")
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    from bench_suite import posterior_moments, moment_check
    moments = posterior_moments(pm, trace, ["mu_a"])
    moment_detail = None

    vs_baseline = None
    baseline_detail = None
    base_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "BASELINE_CPU.json")
    if os.path.exists(base_path):
        with open(base_path) as f:
            base = json.load(f)
        # per-config table (scripts/bench_baseline_cpu_all.py) with
        # back-compat for the old radon-only flat schema
        cfg_tbl = base.get("configs", {}).get("radon") or base
        if cfg_tbl.get("moments"):
            check = moment_check(moments, cfg_tbl["moments"])
            moment_detail = {
                "check": "pass" if check["pass"] else "FAIL",
                "max_z": check["max_z"],
                "max_sd_rel": check["max_sd_rel"],
                "mu_a": {k: [round(x, 4) for x in moments["mu_a"][k]]
                             for k in ("mean", "sd")},
                "cpu_mu_a": {k: [round(float(x), 4) for x in
                                 np.atleast_1d(cfg_tbl["moments"]
                                               ["mu_a"][k])]
                             for k in ("mean", "sd")},
            }
        if cfg_tbl.get("ess_per_sec"):
            vs_baseline = round(ess_per_sec / float(cfg_tbl["ess_per_sec"]),
                                1)
            baseline_detail = {
                "cpu_ess_per_sec": cfg_tbl["ess_per_sec"],
                "cpu_config": {k: cfg_tbl.get(k) for k in
                               ("draws", "tune", "chains", "wall_s")},
                "note": "stand-in: this framework on true-CPU backend at the "
                        "reference asv config (Theano reference unavailable "
                        "in this image)"}

    out = {
        "metric": "radon_nuts_ess_per_sec_per_chip",
        "value": round(ess_per_sec, 2),
        "unit": "ess/s",
        "vs_baseline": vs_baseline,
        "detail": {
            "draws": draws, "tune": tune, "chains": chains,
            "target_accept": target_accept, "pooled_adaptation": pooled,
            "wall_s": round(wall, 2), "ess_mu_a": round(ess, 1),
            "rhat_mu_a": round(rhat, 4),
            "divergences": n_div,
            "divergence_frac": round(div_frac, 5),
            # trace + pure-XLA compile walls of the block program (a
            # persistent-cache warm start shows compile_s ~ 0)
            "lower_s": compile_info.get("lower_s"),
            "compile_s": compile_info.get("compile_s"),
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": card,
            "baseline": baseline_detail,
            "moment_check": moment_detail,
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
