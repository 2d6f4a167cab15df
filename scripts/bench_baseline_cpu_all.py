#!/usr/bin/env python
"""Config-identical CPU stand-in baselines for ALL FIVE BASELINE configs.

The reference (PyMC3+Theano) cannot run in this image, so the documented
stand-in baseline is THIS framework on the stock-CPU JAX backend at each
reference asv benchmark's own configuration
(``/root/reference/benchmarks/benchmarks/benchmarks.py:99-263``):

  radon    — NUTSInitSuite.track_glm_hierarchical_ess  (2000/1000, 4 ch)
  best     — ExampleSuite.time_drug_evaluation         (20000/1000, 4 ch)
  mixture  — NUTSInitSuite.track_marginal_mixture_model_ess (2000/1000, 4)
  ode      — DifferentialEquationSuite.track_1var_2par_ode_ess (500/1000, 2)
  advi     — minibatch-ADVI logistic regression steps/s (config #3)
  smc      — bimodal SMC particle-updates/s, 65536 particles (config #5)

Writes BASELINE_CPU.json as a per-config table consumed by bench.py /
bench_suite.py for per-row ``vs_baseline``.

Run with ``JAX_PLATFORMS=cpu``: the script refuses any other backend.
"""
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402


def _ess_config(pm, model, ess_vars, draws, tune, chains,
                target_accept=None):
    """Run compile pass + measured pass; return (ess_min/s, detail)."""
    kw = {} if target_accept is None else dict(target_accept=target_accept)
    with model:
        pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                  progressbar=False, random_seed=1,
                  compute_convergence_checks=False, **kw)
        t0 = time.time()
        trace = pm.sample(draws=draws, tune=tune, chains=chains,
                          model=model, progressbar=False, random_seed=2,
                          compute_convergence_checks=False, **kw)
        wall = time.time() - t0
    ess_tbl = pm.ess(trace, var_names=ess_vars)
    ess = float(min(np.min(np.asarray(ess_tbl[v])) for v in ess_vars))
    # posterior moments for the device run's cross-check (BASELINE.md:
    # "verify posterior moments agree within Monte-Carlo error")
    from bench_suite import posterior_moments
    moments = posterior_moments(pm, trace, ess_vars)
    res = {"ess_per_sec": round(ess / wall, 3), "ess_min": round(ess, 1),
           "wall_s": round(wall, 2), "draws": draws, "tune": tune,
           "chains": chains, "moments": moments}
    if target_accept is not None:
        res["target_accept"] = target_accept
    return res


def main():
    import jax
    assert jax.default_backend() == "cpu", jax.default_backend()
    import pymc3_tpu as pm
    from bench import build_model as radon_model
    from bench_suite import SUITES

    only = sys.argv[1:] or ["radon", "schools", "schools_noncentered",
                            "best", "mixture", "ode", "gp", "advi", "smc"]
    out = {"backend": "cpu (stock XLA:CPU jaxlib)",
           "note": "config-identical stand-in: this framework on true "
                   "CPU at each reference asv config (Theano reference "
                   "unavailable in this image)",
           "configs": {}}
    path = os.path.join(_REPO, "BASELINE_CPU.json")
    # preserve prior runs when measuring a subset
    if os.path.exists(path):
        try:
            with open(path) as f:
                old = json.load(f)
            if "configs" in old:
                out["configs"].update(old["configs"])
        except Exception:
            pass

    if "radon" in only:
        model = radon_model(pm)
        res = _ess_config(pm, model, ["mu_a"], 2000, 1000, 4)
        res["reference_analog"] = ("NUTSInitSuite.track_glm_hierarchical_"
                                   "ess (benchmarks.py:149-169)")
        out["configs"]["radon"] = res
        print(json.dumps({"config": "radon", **res}), flush=True)

    for name in ("schools", "schools_noncentered", "best", "mixture",
                 "ode", "gp"):
        if name not in only:
            continue
        build, cfg = SUITES[name]
        model, ess_vars = build(pm)
        res = _ess_config(pm, model, ess_vars, cfg["draws"], cfg["tune"],
                          cfg["chains"], cfg.get("target_accept"))
        out["configs"][name] = res
        print(json.dumps({"config": name, **res}), flush=True)

    if "advi" in only:
        # identical synthetic logistic-regression config to
        # scripts/bench_advi_minibatch.py (N=50k, d=100, batch=500, 10k
        # fixed ADVI steps; metric = steps/s)
        import subprocess
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO
        env["JAX_PLATFORMS"] = "cpu"
        p = subprocess.run(
            [sys.executable, os.path.join(_REPO, "scripts",
                                          "bench_advi_minibatch.py")],
            env=env, capture_output=True, timeout=3600)
        line = [l for l in p.stdout.decode().splitlines()
                if l.startswith("{")][-1]
        res = json.loads(line)
        out["configs"]["advi"] = {
            "steps_per_sec": res["steps_per_sec"], "wall_s": res["wall_s"],
            "n_steps": res["n_steps"], "N": res["N"], "d": res["d"],
            "batch": res["batch"]}
        print(json.dumps({"config": "advi", **out["configs"]["advi"]}),
              flush=True)

    if "smc" in only:
        import subprocess
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO
        env["JAX_PLATFORMS"] = "cpu"
        env.setdefault("SMC_DRAWS", "65536")
        p = subprocess.run(
            [sys.executable, os.path.join(_REPO, "scripts",
                                          "bench_smc.py")],
            env=env, capture_output=True, timeout=3600)
        line = [l for l in p.stdout.decode().splitlines()
                if l.startswith("{")][-1]
        res = json.loads(line)
        out["configs"]["smc"] = {
            "particle_updates_per_sec": res["particle_updates_per_sec"],
            "particles": res["particles"], "wall_s": res["wall_s"]}
        print(json.dumps({"config": "smc", **out["configs"]["smc"]}),
              flush=True)

    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
