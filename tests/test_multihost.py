"""Multi-host bring-up path (SURVEY §5 "Distributed communication
backend"): a real 2-process ``jax.distributed`` simulation — NOT a mock —
driving ``parallel.initialize_distributed`` + a global-mesh
``shard_block_fn`` NUTS block (cf. the reference's in-process driving of
the real fork/Pipe protocol, ``pymc3/tests/test_parallel_sampling.py``)."""
import os
import subprocess
import sys

import pytest

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "multihost_sim.py")


@pytest.mark.slow
def test_two_process_distributed_sim():
    env = dict(os.environ)
    # the child script sanitizes its own workers; run the parent plain
    proc = subprocess.run([sys.executable, SCRIPT], env=env,
                          capture_output=True, timeout=600)
    out = proc.stdout.decode(errors="replace")
    assert proc.returncode == 0, out + proc.stderr.decode(errors="replace")
    assert "MULTIHOST SIM OK" in out
    assert out.count("sharded NUTS block ok") == 2


@pytest.mark.slow
def test_four_process_distributed_sim():
    """4 hosts x 2 devices: the same SPMD program, wider
    cross-process fan-in."""
    env = dict(os.environ)
    env["MULTIHOST_NPROC"] = "4"
    env["MULTIHOST_LOCAL_DEVICES"] = "2"
    proc = subprocess.run([sys.executable, SCRIPT], env=env,
                          capture_output=True, timeout=600)
    out = proc.stdout.decode(errors="replace")
    assert proc.returncode == 0, out + proc.stderr.decode(errors="replace")
    assert "MULTIHOST SIM OK" in out
    assert out.count("sharded NUTS block ok") == 4


@pytest.mark.slow
def test_worker_failure_mid_block():
    """Kill one worker between collective blocks: the controller must
    detect the death, terminate the survivors with patience, and raise a
    clean error naming the dead process (cf. the reference's
    ``ExceptionWithTraceback`` + ``terminate_all`` courtesy,
    ``parallel_sampling.py:82-95,322-345``)."""
    env = dict(os.environ)
    env["MULTIHOST_FAIL_RANK"] = "1"
    proc = subprocess.run([sys.executable, SCRIPT], env=env,
                          capture_output=True, timeout=600)
    out = proc.stdout.decode(errors="replace")
    assert proc.returncode != 0, out
    # attributed, clean failure — not a hang, not an anonymous crash
    assert "worker process rank 1 died" in out
    assert "injected mid-block failure on rank 1" in out
    assert "surviving workers terminated" in out
