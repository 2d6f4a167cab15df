"""Bring-up surface: the compile-cache location, importing and sampling
without pandas, and ``chip_smoke.py`` / ``bench.py`` refusing to run
without a GPU while ``chip_smoke.py --tiny`` rehearses every phase on the
CPU."""
import json
import os
import subprocess
import sys

import jax
import pytest

from pymc3_tpu.config import enable_compilation_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout, **env):
    full_env = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable] + args, cwd=ROOT, env=full_env,
                          capture_output=True, text=True, timeout=timeout)


def _result(proc):
    """The ``{"ok": ...}`` result line, which must be the last stdout line."""
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] is True
    return out


def test_compilation_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself: no other directory is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compilation_cache_fixed_in_checkout_default(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compilation_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_import_and_sample_without_pandas():
    code = (
        "import sys; sys.modules['pandas'] = None\n"
        "import numpy as np, pymc3_tpu as pm\n"
        "with pm.Model() as m:\n"
        "    pm.Normal('x', 0.0, 1.0, shape=2)\n"
        "t = pm.sample(draws=50, tune=50, chains=2, model=m,\n"
        "              progressbar=False, random_seed=1,\n"
        "              compute_convergence_checks=False)\n"
        "assert np.all(np.isfinite(pm.ess(t)['x']))\n"
        "assert np.all(np.isfinite(pm.rhat(t)['x']))\n"
        "assert sys.modules['pandas'] is None\n"
        "print('ok')\n")
    proc = _run(["-c", code], timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_without_gpu(script):
    proc = _run([script], timeout=300)
    assert proc.returncode != 0
    assert "GPU" in proc.stderr
    assert '"ok"' not in proc.stdout and '"metric"' not in proc.stdout


def test_chip_smoke_tiny_on_cpu():
    out = _result(_run(["chip_smoke.py", "--tiny"], timeout=900))
    assert out["device"]["platform"] == "cpu"


def test_chip_smoke_four_tiny_on_virtual_devices():
    out = _result(_run(
        ["chip_smoke.py", "--four", "--tiny"], timeout=900,
        XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    assert out["device"]["count"] == 4
