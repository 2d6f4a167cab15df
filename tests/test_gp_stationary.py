"""Fused stationary-covariance op (``gp.cov.stationary_cov``): forward
against a float64 numpy pairwise-distance reference, the closed-form
custom VJP against autodiff of the plain form, and the gp.cov dispatch
seam (cf. reference ``pymc3/gp/cov.py:262-440``; SURVEY §7.9)."""
import numpy as np
import pytest
from scipy.spatial.distance import cdist

import jax
import jax.numpy as jnp

import pymc3_tpu as pm
from pymc3_tpu.gp.cov import (
    STATIONARY_KINDS, _apply_covfn, _sqdist_exact, stationary_cov)

_SQRT3, _SQRT5 = np.sqrt(3.0), np.sqrt(5.0)
# k(r) in float64, r = distance in lengthscale units
_NP_COV = {
    "expquad": lambda r: np.exp(-0.5 * r ** 2),
    "matern52": lambda r: (1 + _SQRT5 * r + 5.0 / 3.0 * r ** 2)
    * np.exp(-_SQRT5 * r),
    "matern32": lambda r: (1 + _SQRT3 * r) * np.exp(-_SQRT3 * r),
    "matern12": lambda r: np.exp(-r),
    "exponential": lambda r: np.exp(-0.5 * r),
}


def _np_cov(kind, X, Xs):
    return _NP_COV[kind](cdist(np.asarray(X, np.float64),
                               np.asarray(Xs, np.float64)))


def _inputs(n=40, m=200, d=3, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    Xs = rng.randn(m, d).astype(np.float32)
    return X, Xs


@pytest.mark.parametrize("kind", STATIONARY_KINDS)
def test_stationary_cov_matches_numpy_forward(kind):
    X, Xs = _inputs()
    K = stationary_cov(X, Xs, kind=kind)
    np.testing.assert_allclose(np.asarray(K), _np_cov(kind, X, Xs),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("kind", STATIONARY_KINDS)
def test_custom_vjp_matches_autodiff(kind):
    """The closed-form two-matmul backward pass == autodiff through the
    plain fused forward."""
    X, Xs = _inputs(n=12, m=9, d=2, seed=1)
    # keep points apart: matern gradients are steep near r=0
    X, Xs = 2.0 * X, 2.0 * X[:9] + 3.0

    def loss_op(X_, Xs_):
        return jnp.sum(jnp.sin(stationary_cov(X_, Xs_, kind=kind)))

    def loss_ref(X_, Xs_):
        return jnp.sum(jnp.sin(_apply_covfn(kind, _sqdist_exact(X_, Xs_))))

    gx, gxs = jax.grad(loss_op, argnums=(0, 1))(jnp.asarray(X),
                                                jnp.asarray(Xs))
    rx, rxs = jax.grad(loss_ref, argnums=(0, 1))(jnp.asarray(X),
                                                 jnp.asarray(Xs))
    np.testing.assert_allclose(np.asarray(gx), np.asarray(rx),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(gxs), np.asarray(rxs),
                               rtol=2e-4, atol=2e-5)


def test_stationary_cov_odd_shape():
    """Shapes that are not a multiple of any tile size, and Xs=None."""
    X, Xs = _inputs(n=130, m=5, d=2, seed=2)
    K = stationary_cov(X, Xs, kind="expquad")
    assert K.shape == (130, 5)
    np.testing.assert_allclose(np.asarray(K), _np_cov("expquad", X, Xs),
                               rtol=2e-5, atol=2e-6)
    K_self = stationary_cov(X, kind="expquad")
    assert K_self.shape == (130, 130)
    np.testing.assert_allclose(np.asarray(K_self), _np_cov("expquad", X, X),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("cov_cls,kind", [
    (pm.gp.cov.ExpQuad, "expquad"),
    (pm.gp.cov.Matern52, "matern52"),
    (pm.gp.cov.Matern32, "matern32"),
    (pm.gp.cov.Matern12, "matern12"),
    (pm.gp.cov.Exponential, "exponential"),
])
def test_gp_cov_dispatches_fused(cov_cls, kind):
    """gp.cov stationary kernels route full() through the fused op and
    agree with the direct distance-space formula (incl. ls scaling)."""
    assert cov_cls._fused_kind == kind
    X = np.random.RandomState(3).randn(25, 2).astype(np.float32)
    ls = np.array([0.7, 1.3], np.float32)
    cov = cov_cls(2, ls=ls)
    K = np.asarray(cov.full(X).eval())
    np.testing.assert_allclose(K, _np_cov(kind, X / ls, X / ls),
                               rtol=2e-5, atol=2e-6)
    # symmetric PSD-ish sanity
    np.testing.assert_allclose(K, K.T, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.diag(K), 1.0, rtol=1e-5)


def test_gp_marginal_likelihood_gradient_through_fused():
    """End-to-end: d logp/d ls of a GP marginal likelihood flows through
    the custom-VJP op without error and matches finite differences."""
    rng = np.random.RandomState(4)
    X = rng.randn(30, 1).astype(np.float32)
    y = np.sin(X[:, 0]) + 0.1 * rng.randn(30).astype(np.float32)

    def mll(ls):
        K = stationary_cov(X / ls, None, kind="expquad")
        K = K + 0.1 * jnp.eye(30)
        L = jnp.linalg.cholesky(K)
        a = jax.scipy.linalg.cho_solve((L, True), y)
        return -0.5 * y @ a - jnp.sum(jnp.log(jnp.diag(L)))

    g = float(jax.grad(mll)(jnp.float32(1.2)))
    eps = 1e-2
    fd = (float(mll(jnp.float32(1.2 + eps)))
          - float(mll(jnp.float32(1.2 - eps)))) / (2 * eps)
    assert abs(g - fd) < 5e-2 * max(1.0, abs(fd)), (g, fd)


@pytest.mark.gpu
def test_stationary_cov_on_gpu_matches_numpy():
    """On a card, at a real width: every kind at n=m=4096, d=4, against the
    float64 reference (float32 kernel math; matmul precision "highest")."""
    rng = np.random.RandomState(5)
    X = rng.randn(4096, 4).astype(np.float32)
    Xs = rng.randn(4096, 4).astype(np.float32)
    cov = jax.jit(stationary_cov, static_argnames="kind")
    for kind in STATIONARY_KINDS:
        np.testing.assert_allclose(np.asarray(cov(X, Xs, kind=kind)),
                                   _np_cov(kind, X, Xs),
                                   rtol=1e-5, atol=1e-6)
