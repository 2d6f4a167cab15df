#!/usr/bin/env python
"""Two-process ``jax.distributed`` simulation of the multi-host path.

The north-star deployment spans >= 2 hosts joined by
``parallel.initialize_distributed`` (SURVEY §5 "Distributed communication
backend"); no real multi-host harness exists in this image, so this script
simulates it: it re-execs itself into two OS processes, each claiming 4
virtual CPU devices, joins them through ``jax.distributed.initialize`` on a
localhost coordinator, builds ONE global 8-device mesh spanning both
processes, and runs the pooled-adaptation NUTS chain block through
``shard_block_fn`` — the exact code path a v4-16 run would use, with the
cross-process psum riding the (here: TCP) collective fabric.

Run directly: ``python scripts/multihost_sim.py`` (parent mode). Exits 0
iff both ranks finish the sharded block with finite results and agree on
the pooled statistic.
"""
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_PROC = int(os.environ.get("MULTIHOST_NPROC", 2))
LOCAL_DEVICES = int(os.environ.get("MULTIHOST_LOCAL_DEVICES", 4))
# if set, that rank raises mid-run (between scan blocks) to exercise the
# failure-detection path (SURVEY §5): the parent must notice the death,
# terminate the surviving workers with patience (cf. terminate_all,
# parallel_sampling.py:322-345), and report the dead rank with its
# traceback
FAIL_RANK = os.environ.get("MULTIHOST_FAIL_RANK")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def parent():
    port = _free_port()
    env_base = dict(os.environ)
    # children stay on the CPU backend, one process per rank
    env_base["PYTHONPATH"] = REPO
    env_base["JAX_PLATFORMS"] = "cpu"
    env_base["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={LOCAL_DEVICES}")
    env_base["MULTIHOST_COORD"] = f"127.0.0.1:{port}"
    procs = []
    for rank in range(N_PROC):
        env = dict(env_base)
        env["MULTIHOST_RANK"] = str(rank)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))

    # supervise: poll workers; the FIRST nonzero exit triggers
    # terminate-with-patience of the rest (a dead rank leaves survivors
    # blocked in the global collective — the parent must not wait out the
    # full deadline; cf. ProcessAdapter.terminate_all,
    # parallel_sampling.py:322-345)
    from pymc3_tpu.parallel import terminate_workers
    deadline = time.time() + 600
    dead_rank = None
    while time.time() < deadline:
        rcs = [p.poll() for p in procs]
        failed = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
        if failed:
            dead_rank = failed[0]
            terminate_workers([p for p in procs if p.poll() is None],
                              patience=5.0)
            break
        if all(rc == 0 for rc in rcs):
            break
        time.sleep(0.2)
    else:
        for p in procs:
            p.kill()
        print("MULTIHOST SIM FAILED (deadline)")
        sys.exit(1)

    outs = []
    for rank, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out.decode(errors="replace"))
    for rank, out in enumerate(outs):
        print(f"--- rank {rank} ---")
        print(out)
    if dead_rank is not None:
        # clean, attributed error naming the dead process
        print(f"MULTIHOST SIM FAILED: worker process rank {dead_rank} "
              f"died (exit {procs[dead_rank].returncode}); surviving "
              f"workers terminated")
        sys.exit(1)
    if any(p.returncode != 0 for p in procs):
        print("MULTIHOST SIM FAILED")
        sys.exit(1)
    print("MULTIHOST SIM OK")


def child():
    import numpy as np
    import jax
    import jax.numpy as jnp

    rank = int(os.environ["MULTIHOST_RANK"])
    import pymc3_tpu as pm
    from pymc3_tpu.parallel import (
        initialize_distributed, make_mesh, shard_block_fn, pooled_axes,
        CHAIN_AXIS)
    from pymc3_tpu.step_methods.arraystep import TuneContext

    # multi-host bring-up (cf. jax.distributed.initialize; the reference's analog
    # is one fork per chain, parallel_sampling.py:107)
    initialize_distributed(coordinator_address=os.environ["MULTIHOST_COORD"],
                           num_processes=N_PROC, process_id=rank)
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    assert n_global == N_PROC * LOCAL_DEVICES, n_global
    assert n_local == LOCAL_DEVICES, n_local
    print(f"rank {rank}: {n_local} local / {n_global} global devices")

    # flagship-structure model, tiny shapes
    rng = np.random.default_rng(0)
    y = rng.normal(size=16).astype(np.float32)
    with pm.Model() as model:
        mu = pm.Normal("mu", 0.0, 5.0)
        sigma = pm.HalfNormal("sigma", 2.0)
        pm.Normal("y", mu=mu, sigma=sigma, observed=y)

    mesh = make_mesh(jax.devices())  # spans BOTH processes
    step = pm.NUTS(model=model, axis_name=CHAIN_AXIS)
    q0 = np.asarray(model.dict_to_array(model.test_point))

    chains = 2 * n_global  # 2 per device, global
    tune, draws = 4, 4

    def chain_block(carry, idxs):
        def one_step(c, idx):
            k, q, st = c
            k, sub = jax.random.split(k)
            tctx = TuneContext(idx < tune, idx, tune)
            q, st, stats = step.kernel_step(sub, q, st, tctx)
            # step_size_bar is the POOLED dual-averaging iterate; the raw
            # step_size additionally carries the per-lane eps_scale
            # fallback (a warmup-diverging lane halves its own eps by
            # design), so the cross-host pooling assertion checks the bar
            return (k, q, st), (q, stats["step_size_bar"])
        return jax.lax.scan(one_step, carry, idxs)

    run = shard_block_fn(chain_block, mesh=mesh)

    # per-process data -> one global sharded array
    from jax.sharding import NamedSharding, PartitionSpec as P
    sharding = NamedSharding(mesh, P(CHAIN_AXIS))
    keys_np = np.asarray(jax.vmap(jax.random.PRNGKey)(np.arange(chains)))
    Q0_np = np.broadcast_to(q0, (chains,) + q0.shape).copy()

    def to_global(arr):
        return jax.make_array_from_process_local_data(
            sharding, arr[rank * (chains // N_PROC):
                          (rank + 1) * (chains // N_PROC)],
            global_shape=arr.shape)

    keys = to_global(keys_np)
    Q0 = to_global(Q0_np)
    state0 = jax.jit(
        jax.vmap(step.kernel_init), out_shardings=sharding)(Q0)

    from pymc3_tpu.parallel import install_worker_excepthook
    install_worker_excepthook(rank)

    carry = (keys, Q0, state0)
    half = (tune + draws) // 2
    idxs1 = jnp.arange(half, dtype=jnp.int32)
    idxs2 = jnp.arange(half, tune + draws, dtype=jnp.int32)
    # two blocks so a failure can be injected MID-RUN, between collectives
    carry, (qs_a, eps_a) = run(carry, idxs1)
    jax.block_until_ready(qs_a)
    if FAIL_RANK is not None and rank == int(FAIL_RANK):
        raise RuntimeError(
            f"injected mid-block failure on rank {rank} (test fixture)")
    carry, (qs_b, eps_b) = run(carry, idxs2)
    qs = jnp.concatenate([qs_a, qs_b], axis=1)
    eps = jnp.concatenate([eps_a, eps_b], axis=1)

    # pull only this process's addressable shards
    local_q = np.concatenate(
        [np.asarray(s.data) for s in qs.addressable_shards], axis=0)
    assert local_q.shape == (chains // N_PROC, tune + draws, q0.shape[0])
    assert np.all(np.isfinite(local_q)), "non-finite draws"
    local_eps = np.concatenate(
        [np.asarray(s.data) for s in eps.addressable_shards], axis=0)
    # pooled dual-averaging => every chain on every host shares the bar
    spread = float(np.ptp(local_eps[:, -1]))
    assert spread < 1e-9, f"eps bar not pooled across hosts: {spread}"
    print(f"rank {rank}: sharded NUTS block ok; pooled eps = "
          f"{float(local_eps[0, -1]):.5f}")
    jax.distributed.shutdown()


if __name__ == "__main__":
    if "MULTIHOST_RANK" in os.environ:
        child()
    else:
        parent()
