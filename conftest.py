"""Root pytest conftest: pin the test suite to an 8-device CPU mesh.

The virtual host devices stand in for a multi-GPU mesh in the sharding
tests (cf. SURVEY §4.4). An explicit ``JAX_PLATFORMS`` wins, so the tests
marked ``gpu`` can run on a card (see ``tests/conftest.py``).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

from pymc3_tpu.config import enable_compilation_cache  # noqa: E402

enable_compilation_cache()
