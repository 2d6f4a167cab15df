#!/usr/bin/env python
"""SMC throughput benchmark (BASELINE config #5 scaled to one chip).

Bimodal 2-D Gaussian-mixture target (the reference's canonical SMC test,
``pymc3/tests/test_smc.py``) at a large particle count with the
device-resident SMC kernel: particle state stays on the device across stages,
between-stage math (β-bisection / systematic resampling / proposal
covariance) runs on device, and the host sees only scalars per stage.

Metric: mutation-leapfrog-equivalents per second =
particles x IMH steps x stages / wall, plus wall for the whole run and
the mode-balance correctness check. Prints one JSON line.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_model(pm):
    import jax.numpy as jnp
    from pymc3_tpu.node import apply as node_apply

    def bimodal_logp(x):
        l1 = -0.5 * jnp.sum(((x - 3.0) / 0.5) ** 2)
        l2 = -0.5 * jnp.sum(((x + 3.0) / 0.5) ** 2)
        return jnp.logaddexp(jnp.log(0.5) + l1, jnp.log(0.5) + l2)

    with pm.Model() as model:
        x = pm.Uniform("x", -8.0, 8.0, shape=2)
        pm.Potential("bimodal", node_apply(bimodal_logp, x))
    return model


def main():
    import jax
    import pymc3_tpu as pm
    from pymc3_tpu.config import enable_compilation_cache
    enable_compilation_cache()

    draws = int(os.environ.get("SMC_DRAWS", 65536))
    n_steps = int(os.environ.get("SMC_NSTEPS", 25))
    # SMC_DEVICES=N shards the particle axis over the first N devices
    # (the scaling leg: 1 -> 8 virtual CPU devices under
    # XLA_FLAGS=--xla_force_host_platform_device_count=8)
    n_devices = int(os.environ.get("SMC_DEVICES", 0))
    devices = jax.devices()[:n_devices] if n_devices else None

    model = build_model(pm)

    stages = {"n": 0, "proposed": 0}

    def run(seed):
        from pymc3_tpu.smc.smc import SMC
        smc = SMC(draws=draws, n_steps=n_steps, model=model,
                  random_seed=seed, devices=devices)
        smc.initialize_population()
        smc.setup_kernel()
        t0 = time.time()
        smc.initialize_logp()
        stages["n"] = 0
        stages["proposed"] = 0
        while smc.beta < 1:
            smc.update_weights_beta()
            smc.resample()
            smc.update_proposal()
            if stages["n"] > 0:
                smc.tune()
            smc.mutate()
            stages["proposed"] += smc.draws * smc.n_steps
            stages["n"] += 1
        jax.block_until_ready(smc.posterior)
        wall = time.time() - t0
        return smc, wall

    run(1)  # compile
    smc, wall = run(2)
    trace = smc.posterior_to_trace()
    x = trace["x"]
    frac_pos = float(np.mean(x[:, 0] > 0))

    print(json.dumps({
        "suite": "smc_bimodal",
        "particle_updates_per_sec": round(stages["proposed"] / wall, 0),
        "particles": draws, "stages": stages["n"],
        "imh_steps_per_stage": n_steps,
        "wall_s": round(wall, 2),
        "mode_balance": round(frac_pos, 3),
        "log_marginal_likelihood": round(smc.log_marginal_likelihood, 3),
        # moment check vs the analytic target: symmetric two-mode mixture
        # at +-3 with sd 0.5 => mean 0, sd sqrt(9.25) per coordinate
        "moments": {"mean": [round(float(m), 3) for m in x.mean(axis=0)],
                    "sd": [round(float(s), 3) for s in x.std(axis=0)]},
        "moments_analytic": {"mean": [0.0, 0.0],
                             "sd": [round(np.sqrt(9.25), 3)] * 2},
        # gate: a 5% mode-balance skew shifts the mean by 0.3, so this
        # bound subsumes the balance check at the moment level
        "moment_check": ("pass" if (np.all(np.abs(x.mean(axis=0)) < 0.3)
                                    and np.all(np.abs(x.std(axis=0)
                                                      - np.sqrt(9.25))
                                               < 0.3))
                         else "FAIL"),
        "devices": n_devices or 1,
        "backend": jax.default_backend(),
    }), flush=True)


if __name__ == "__main__":
    main()
