"""Multi-device chain parallelism — the "communication backend".

The reference runs one OS process per chain with a Pipe control protocol and
shared-memory sample transport (``pymc3/parallel_sampling.py:98-244``). Here
chains advance in lockstep SPMD: the chain axis is sharded over a 1-D
``jax.sharding.Mesh`` with ``shard_map``, each device vmaps its local block
of chains, and cross-chain reductions (pooled Welford mass-matrix adaptation,
on-device R-hat) are exact ``psum`` collectives, which XLA hands to NCCL on
GPUs — no message protocol exists because there is nothing asynchronous to
coordinate (SURVEY §2.4, §5 "Distributed communication backend").

Multi-host bring-up goes through ``jax.distributed.initialize``; the mesh
then spans all hosts' devices and the same ``shard_map`` program runs
unchanged from one device to many.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

__all__ = ["make_mesh", "shard_chain_fn", "shard_block_fn",
           "initialize_distributed", "CHAIN_AXIS", "LOCAL_CHAIN_AXIS",
           "RemoteWorkerError", "install_worker_excepthook",
           "terminate_workers"]

CHAIN_AXIS = "chains"           # mesh axis: chains sharded across devices
LOCAL_CHAIN_AXIS = "chains_local"  # vmap axis: chains within one device


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None):
    """Multi-host bring-up (cf. the reference's per-process fork at
    ``parallel_sampling.py:107``; here hosts join one SPMD program)."""
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = CHAIN_AXIS) -> Mesh:
    """1-D device mesh over the chain axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def shard_chain_fn(chain_fn: Callable, axis_name: Optional[str] = None,
                   devices: Optional[Sequence] = None,
                   mesh: Optional[Mesh] = None) -> Callable:
    """Lift a per-chain function to a sharded multi-chain program.

    ``chain_fn(key, q0) -> pytree`` (leading output axes are per-chain).
    Returns ``run(keys, q0s)`` where the leading (chain) axis of every input
    and output is sharded over the mesh. Inside, each device vmaps its local
    chains with a named vmap axis so kernels can ``psum`` over
    ``(LOCAL_CHAIN_AXIS, CHAIN_AXIS)`` for exact pooled cross-chain warmup
    statistics (cf. ``_WeightedVariance.add_sample``,
    ``quadpotential.py:336-342``).
    """
    if mesh is None:
        mesh = make_mesh(devices)
    mesh_axis = mesh.axis_names[0]
    n_dev = int(np.prod(mesh.devices.shape))

    local = jax.vmap(chain_fn, axis_name=LOCAL_CHAIN_AXIS)

    sharded = jax.shard_map(
        local, mesh=mesh, in_specs=(P(mesh_axis), P(mesh_axis)),
        out_specs=P(mesh_axis), check_vma=False)

    @jax.jit
    def run(keys, q0s):
        n = q0s.shape[0]
        if n % n_dev != 0:
            raise ValueError(
                f"chains ({n}) must be a multiple of the device count "
                f"({n_dev}); pad the chain count.")
        return sharded(keys, q0s)

    return run


def shard_block_fn(chain_block: Callable, devices: Optional[Sequence] = None,
                   mesh: Optional[Mesh] = None) -> Callable:
    """Lift a per-chain draw-block function to a sharded multi-chain program.

    ``chain_block(carry, idxs) -> (carry, outputs)`` advances ONE chain by
    ``len(idxs)`` draws (a ``lax.scan`` block); ``carry`` is the chain's
    kernel state pytree. The lifted function shards the leading (chain) axis
    of every carry/output leaf over the mesh and vmaps the device-local
    chains with the named axis ``LOCAL_CHAIN_AXIS``, so kernels can ``psum``
    over ``(LOCAL_CHAIN_AXIS, <mesh axis>)`` for exact pooled cross-chain
    warmup statistics. The draw-index vector ``idxs`` is replicated.

    This is the streaming (chunked-scan) counterpart of
    :func:`shard_chain_fn`: the driver calls it once per block, keeping device
    memory bounded (SURVEY §5 "Distributed communication backend").
    """
    if mesh is None:
        mesh = make_mesh(devices)
    mesh_axis = mesh.axis_names[0]
    n_dev = int(np.prod(mesh.devices.shape))

    local = jax.vmap(chain_block, in_axes=(0, None), out_axes=(0, 0),
                     axis_name=LOCAL_CHAIN_AXIS)

    sharded = jax.shard_map(
        local, mesh=mesh, in_specs=(P(mesh_axis), P()),
        out_specs=(P(mesh_axis), P(mesh_axis)), check_vma=False)

    @jax.jit
    def run(carry, idxs):
        n = jax.tree_util.tree_leaves(carry)[0].shape[0]
        if n % n_dev != 0:
            raise ValueError(
                f"chains ({n}) must be a multiple of the device count "
                f"({n_dev}); pad the chain count.")
        return sharded(carry, idxs)

    return run


def pooled_axes(axis_name: Optional[str] = None):
    """Axis names for cross-chain collectives inside kernels.

    In a mesh-sharded run the configured ``axis_name`` is the mesh axis,
    but the device-local chains are additionally vmapped under
    ``LOCAL_CHAIN_AXIS`` — collectives must reduce over BOTH so every chain
    on every device shares the pooled statistic. In a single-device run the
    configured axis IS the vmap axis; return it alone."""
    if axis_name is None:
        return LOCAL_CHAIN_AXIS
    names = axis_name if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)
    out = [LOCAL_CHAIN_AXIS]
    for n in names:
        if n not in out:
            out.append(n)
    return out[0] if len(out) == 1 else tuple(out)


# ---------------------------------------------------------------------------
# Multi-host failure detection (SURVEY §5 "Failure detection")
# ---------------------------------------------------------------------------
class RemoteWorkerError(RuntimeError):
    """A multi-host worker process died (cf. ``ParallelSamplingError`` +
    ``ExceptionWithTraceback``, ``parallel_sampling.py:64,82-95``): carries
    the rank and the worker's formatted traceback so the error surfaces in
    the controller with full attribution."""

    def __init__(self, rank, message):
        super().__init__(f"worker process rank {rank} failed:\n{message}")
        self.rank = rank


def install_worker_excepthook(rank: int):
    """Make uncaught exceptions in a worker process print a
    rank-attributed, fully formatted traceback before the nonzero exit —
    the SPMD analog of the reference pickling tracebacks back through the
    pipe (``parallel_sampling.py:82-95``)."""
    import sys
    import traceback

    def hook(exc_type, exc, tb):
        formatted = "".join(traceback.format_exception(exc_type, exc, tb))
        sys.stderr.write(f"[multihost rank {rank}] worker failed:\n"
                         f"{formatted}")
        sys.stderr.flush()
        # hard exit: jax.distributed registers an atexit shutdown that
        # BARRIERS on the other ranks — a dying worker waiting there while
        # the survivors wait in a collective is a deadlock, so skip atexit
        import os as _os
        _os._exit(1)

    sys.excepthook = hook


def terminate_workers(procs, patience: float = 5.0):
    """Terminate remaining worker processes after one dies (cf.
    ``ProcessAdapter.terminate_all``, ``parallel_sampling.py:322-345``):
    give them ``patience`` seconds to exit on their own, then SIGTERM,
    then SIGKILL stragglers."""
    import time as _time
    deadline = _time.time() + patience
    for p in procs:
        while p.poll() is None and _time.time() < deadline:
            _time.sleep(0.05)
        if p.poll() is None:
            p.terminate()
    deadline = _time.time() + 2.0
    for p in procs:
        while p.poll() is None and _time.time() < deadline:
            _time.sleep(0.05)
        if p.poll() is None:
            p.kill()
