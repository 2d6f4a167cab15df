"""Global configuration.

Replaces the reference's Theano global config handling
(``pymc3/theanof.py:445-470`` ``set_theano_conf`` and the ``floatX``/``intX``
casting discipline at ``pymc3/theanof.py:75-101``) with a typed config object
over ``jax.config``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np

__all__ = ["floatX", "intX", "get_config", "set_config", "Config"]


@dataclasses.dataclass
class Config:
    """Typed global configuration.

    Attributes
    ----------
    floatX : str
        Default float dtype for all continuous computation. ``float32`` is the
        default; ``float64`` (set through ``PYMC3_TPU_FLOATX`` or
        ``set_config``) also turns on ``jax_enable_x64``.
    intX : str
        Default integer dtype.
    compute_test_value : str
        'raise' eagerly evaluates test values at model-build time (the JAX
        analog of Theano's ``compute_test_value='raise'``, ``model.py:818``)
        so shape/dtype errors surface at declaration, not at trace time.
    """

    floatX: str = os.environ.get("PYMC3_TPU_FLOATX", "float32")
    intX: str = "int32"
    compute_test_value: str = "raise"
    # Accelerators may run float32 matmuls at reduced input precision (TF32
    # on the GPU, bfloat16 passes elsewhere); for MCMC/GP linear algebra
    # that is catastrophic (indefinite covariances, divergent trajectories).
    # 'highest' keeps full float32 products. Hot matmuls in a PPL are small,
    # so the cost is small; override for large-matmul VI.
    matmul_precision: str = os.environ.get(
        "PYMC3_TPU_MATMUL_PRECISION", "highest")


_config = Config()


def _apply_floatX():
    """Wire the configured float width into jax (the env-var path of the
    reference's FLOATX CI sweep, ``scripts/test.sh:9``): float64 requires
    the x64 flag or every array silently truncates to float32."""
    import jax

    if _config.floatX == "float64":
        jax.config.update("jax_enable_x64", True)
        _config.intX = "int64"
    elif _config.floatX == "float32":
        _config.intX = "int32"


def _apply_matmul_precision():
    import jax

    jax.config.update("jax_default_matmul_precision",
                      _config.matmul_precision)


def get_config() -> Config:
    return _config


def set_config(**kwargs: Any) -> Config:
    """Update global config fields; returns the config object."""
    import jax

    for k, v in kwargs.items():
        if not hasattr(_config, k):
            raise KeyError(f"unknown config field {k!r}")
        setattr(_config, k, v)
    _apply_floatX()
    _apply_matmul_precision()
    return _config


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache at one fixed directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it is (JAX reads
    the variable itself) and no other directory is set. Otherwise the cache
    lives in ``.jax_cache`` beside the package, a fixed path so that one
    process finds what an earlier one compiled. JAX's own cache key
    separates platforms, devices and compile options. Returns the directory.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def floatX(x=None):
    """Cast ``x`` to the configured float dtype, or return the dtype name.

    Mirrors ``pymc3/theanof.py:75`` ``floatX``.
    """
    if x is None:
        return _config.floatX
    if isinstance(x, (list, tuple)):
        return np.asarray(x, dtype=_config.floatX)
    if hasattr(x, "astype"):
        return x.astype(_config.floatX)
    return np.asarray(x, dtype=_config.floatX)


def intX(x=None):
    """Cast ``x`` to the configured int dtype, or return the dtype name.

    Mirrors ``pymc3/theanof.py:92`` ``intX``.
    """
    if x is None:
        return _config.intX
    if hasattr(x, "astype"):
        return x.astype(_config.intX)
    return np.asarray(x, dtype=_config.intX)
