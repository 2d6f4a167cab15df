#!/usr/bin/env python
"""Stationary GP covariance (``gp.cov.stationary_cov``) against its
bandwidth bound on one GPU.

Times the XLA-compiled op at n=m in {4096, 16384}, d=4, for every kind:
forward (K written once: 4·n·m bytes) and forward+backward through its
custom VJP with an n×m cotangent already in device memory (K written and
the cotangent read once: 8·n·m bytes). Each time is reported as a share of
two bounds: those bytes over a large-copy rate measured in the same
process, and over the published H100 SXM rate of 3.35 TB/s. A low share
is what would justify a hand-written kernel.

Prints one JSON line per measurement, each with the device and the card's
name and power limit. Exits non-zero without a GPU.

Usage: python scripts/bench_gp_cov.py [n ...]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

PUBLISHED_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
REPS = 20


def _time(fn, *args):
    """Median wall of ``fn(*args)`` to completion, after one warm call."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main():
    import jax
    import jax.numpy as jnp
    from bench import card_label
    from pymc3_tpu.config import enable_compilation_cache
    from pymc3_tpu.gp.cov import STATIONARY_KINDS, stationary_cov

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_gp_cov.py measures a GPU; JAX found "
                 f"{dev.platform!r}")
    enable_compilation_cache()
    stamp = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices())},
             "card": card_label()}

    # large copy: read + write 1 GiB
    big = jnp.ones((1 << 28,), jnp.float32)
    t_copy = _time(jax.jit(lambda x: x + 1.0), big)
    copy_rate = 2 * big.nbytes / t_copy
    del big
    print(json.dumps({"op": "copy_1GiB", "s": t_copy,
                      "bytes_per_s": copy_rate, **stamp}), flush=True)

    rng = np.random.default_rng(0)
    for n in [int(a) for a in sys.argv[1:]] or [4096, 16384]:
        X = jnp.asarray(rng.standard_normal((n, 4)), jnp.float32)
        Xs = jnp.asarray(rng.standard_normal((n, 4)), jnp.float32)
        G = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
        for kind in STATIONARY_KINDS:
            fwd = jax.jit(lambda A, B, k=kind: stationary_cov(A, B, kind=k))

            @jax.jit
            def fwd_bwd(A, B, G_, k=kind):
                K, vjp = jax.vjp(
                    lambda A_, B_: stationary_cov(A_, B_, kind=k), A, B)
                return K, vjp(G_)

            for name, fn, args, nbytes in (
                    ("fwd", fwd, (X, Xs), 4 * n * n),
                    ("fwd_bwd", fwd_bwd, (X, Xs, G), 8 * n * n)):
                t = _time(fn, *args)
                print(json.dumps({
                    "op": f"stationary_cov_{name}", "kind": kind, "n": n,
                    "m": n, "d": 4, "s": t, "bound_bytes": nbytes,
                    "share_of_copy_rate": nbytes / t / copy_rate,
                    "share_of_published": nbytes / t / PUBLISHED_BYTES_PER_S,
                    **stamp}), flush=True)
        del G


if __name__ == "__main__":
    main()
