"""GP utilities (cf. ``pymc3/gp/util.py``)."""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..config import floatX
from ..node import Node, apply as node_apply

__all__ = ["stabilize", "kmeans_inducing_points", "conditioned_vars",
           "infer_shape", "plot_gp_dist", "cholesky", "solve_lower",
           "solve_upper"]

JITTER_DEFAULT = 1e-6


def _default_jitter():
    """float32 (the default dtype) needs a larger diagonal jitter for
    stable cholesky of smooth kernels than the reference's float64 1e-6:
    Kss - AᵀA style conditionals accumulate O(1e-4) rounding noise."""
    return 5e-4 if floatX() == "float32" else JITTER_DEFAULT


def infer_shape(X, n_points=None):
    """cf. ``gp/util.py:26``."""
    if n_points is None:
        try:
            n_points = int(np.shape(X if not isinstance(X, Node)
                                    else X.test_value)[0])
        except TypeError:
            raise TypeError("Cannot infer 'shape', provide as an argument")
    return n_points


def stabilize(K, jitter=None):
    """K + jitter*I (cf. ``gp/util.py:34``)."""
    if jitter is None:
        jitter = _default_jitter()
    return node_apply(
        lambda K_: jnp.asarray(K_, floatX()) +
        jitter * jnp.eye(jnp.shape(K_)[0], dtype=floatX()), K)


def cholesky(K):
    return node_apply(lambda K_: jnp.linalg.cholesky(
        jnp.asarray(K_, floatX())), K)


def solve_lower(L, b):
    import jax.scipy.linalg as jsl
    return node_apply(lambda L_, b_: jsl.solve_triangular(
        L_, jnp.asarray(b_, floatX()), lower=True), L, b)


def solve_upper(L, b):
    import jax.scipy.linalg as jsl
    return node_apply(lambda L_, b_: jsl.solve_triangular(
        L_.T, jnp.asarray(b_, floatX()), lower=False), L, b)


def kmeans_inducing_points(num_inducing, X):
    """cf. ``gp/util.py:39`` — scipy kmeans on the inputs."""
    from scipy.cluster.vq import kmeans
    if isinstance(X, Node):
        X = X.test_value
    X = np.asarray(X, dtype=np.float64)
    scaling = np.std(X, 0)
    scaling[scaling == 0] = 1.0
    Xw = X / scaling
    Xu, _ = kmeans(Xw, int(num_inducing))
    return Xu * scaling


def conditioned_vars(varnames):
    """Decorator lending the given/conditioning-variable protocol to GP
    implementations (cf. ``gp/util.py:58``)."""
    def gp_wrapper(cls):
        def make_getter(name):
            def getter(self):
                value = getattr(self, name, None)
                if value is None:
                    raise AttributeError(
                        f"'{name}' not set.  Provide as argument to "
                        "conditional, or call 'prior' first")
                else:
                    return value
            getter.__doc__ = f"The instance variable {name}"
            return getter

        def make_setter(name):
            def setter(self, val):
                setattr(self, name, val)
            return setter

        for name in varnames:
            getter = make_getter("_" + name)
            setter = make_setter("_" + name)
            setattr(cls, name, property(getter, setter))
        return cls
    return gp_wrapper


def plot_gp_dist(ax, samples, x, plot_samples=True, palette="Reds",
                 fill_alpha=0.8, samples_alpha=0.1, fill_kwargs=None,
                 samples_kwargs=None):
    """Plot percentile ribbons of GP samples (cf. ``gp/util.py:86``)."""
    import matplotlib.pyplot as plt
    if fill_kwargs is None:
        fill_kwargs = {}
    if samples_kwargs is None:
        samples_kwargs = {}

    cmap = plt.get_cmap(palette)
    percs = np.linspace(51, 99, 40)
    colors = (percs - np.min(percs)) / (np.max(percs) - np.min(percs))
    samples = np.asarray(samples).T
    x = np.asarray(x).flatten()
    for i, p in enumerate(percs[::-1]):
        upper = np.percentile(samples, p, axis=1)
        lower = np.percentile(samples, 100 - p, axis=1)
        color_val = colors[i]
        ax.fill_between(x, upper, lower, color=cmap(color_val),
                        alpha=fill_alpha, **fill_kwargs)
    if plot_samples:
        idx = np.random.permutation(samples.shape[1])[:30]
        ax.plot(x, samples[:, idx], color=cmap(0.9), lw=1,
                alpha=samples_alpha, **samples_kwargs)
    return ax
