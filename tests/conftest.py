"""Test fixtures. Environment setup (CPU pin, virtual 8-device mesh,
compilation cache) lives in the repo-root conftest.py."""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running multi-process simulations")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; run on a card with "
        "JAX_PLATFORMS=cuda python -m pytest tests -m gpu")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's default backend is a GPU.
    Decided here, per test, never at import or collection time."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")


@pytest.fixture(scope="function")
def seeded():
    np.random.seed(20090425)
    yield


class SeededTest:
    """Per-method seeding (cf. ``pymc3/tests/helpers.py:23-36``)."""

    random_seed = 20160911

    @classmethod
    def setup_class(cls):
        np.random.seed(cls.random_seed)

    def setup_method(self):
        np.random.seed(self.random_seed)
