#!/usr/bin/env python
"""Minibatch-ADVI logistic regression benchmark (BASELINE config #3:
``pymc3/glm/linear.py:127`` + ``pymc3/data.py:111`` Minibatch +
``variational/inference.py:323`` ADVI).

Synthetic logistic regression (N=50k, d=100), minibatch 500, fixed ADVI
step budget; the whole optimizer loop is one jitted ``lax.scan`` so the
metric is steady-state ELBO steps/sec plus a posterior-quality check
(coefficient recovery RMSE vs the generating weights). Prints one JSON
line.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import pymc3_tpu as pm
    from pymc3_tpu.config import enable_compilation_cache
    enable_compilation_cache()

    N = int(os.environ.get("ADVI_N", 50_000))
    d = int(os.environ.get("ADVI_D", 100))
    batch = int(os.environ.get("ADVI_BATCH", 500))
    n_steps = int(os.environ.get("ADVI_STEPS", 10_000))

    rng = np.random.RandomState(0)
    X = rng.randn(N, d).astype(np.float32)
    w_true = rng.randn(d).astype(np.float32) * 0.5
    logits = X @ w_true
    y = (rng.uniform(size=N) < 1.0 / (1.0 + np.exp(-logits))).astype(
        np.float32)

    X_mb = pm.Minibatch(X, batch)
    y_mb = pm.Minibatch(y, batch)
    with pm.Model() as model:
        w = pm.Normal("w", 0.0, 1.0, shape=d)
        b = pm.Normal("b", 0.0, 1.0)
        p = pm.math.invlogit(pm.math.dot(X_mb, w) + b)
        pm.Bernoulli("obs", p=p, observed=y_mb, total_size=N)

    # one Inference object: the compiled step is cached across fit()
    # calls, so the second fit measures steady-state device throughput
    # (not re-trace + data-constant re-upload)
    with model:
        inference = pm.ADVI()

    def run(seed):
        inference.state = None
        inference.approx.params = {
            0: inference.approx.groups[0].init_params()}
        t0 = time.time()
        approx = inference.fit(n=n_steps, random_seed=seed,
                               progressbar=False)
        return approx, time.time() - t0

    run(1)  # compile + upload
    approx, wall = run(2)

    means = model.array_to_dict(np.asarray(approx.mean))
    rmse = float(np.sqrt(np.mean((means["w"] - w_true) ** 2)))
    hist = np.asarray(approx.hist)
    print(json.dumps({
        "suite": "advi_minibatch_logistic",
        "steps_per_sec": round(n_steps / wall, 1),
        "wall_s": round(wall, 2),
        "n_steps": n_steps, "N": N, "d": d, "batch": batch,
        "final_elbo": round(float(hist[-100:].mean()), 1),
        "coef_rmse": round(rmse, 4),
        "backend": jax.default_backend(),
    }), flush=True)


if __name__ == "__main__":
    main()
