"""Numeric kernels for distribution log-densities.

Mirrors ``pymc3/distributions/dist_math.py`` but as pure jnp functions: the
reference's hand-rolled ``scan`` loops for the incomplete beta
(``dist_math.py:367-503``) collapse onto ``jax.scipy.special.betainc`` (an XLA
intrinsic with gradients), the Bessel ``i0e/i1e`` Ops (``dist_math.py:288``)
onto ``jss.i0e/i1e``, and the ``MvNormalLogp`` OpFromGraph with a hand-written
cholesky gradient (``dist_math.py:185-248``) onto XLA ``cholesky`` +
``triangular_solve`` which autodiff correctly.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
import jax.scipy.special as jss
import jax.scipy.linalg as jsl

from ..config import floatX

__all__ = [
    "bound", "alltrue_elemwise", "alltrue_scalar", "logpow", "factln",
    "betaln", "binomln", "std_cdf", "normal_lcdf", "normal_lccdf",
    "log_diff_normal_cdf", "sigma2rho", "rho2sigma", "log_normal",
    "MvNormal_logp", "SplineWrapper", "i0e", "i1e", "incomplete_beta",
    "random_choice", "zvalue", "clipped_beta_rvs",
]

f = floatX


def alltrue_elemwise(conditions):
    """Elementwise AND over a list of boolean conditions (broadcasting)."""
    ret = True
    for c in conditions:
        ret = jnp.logical_and(ret, c)
    return ret


def alltrue_scalar(conditions):
    return jnp.all(jnp.stack([jnp.all(c) for c in conditions]))


def bound(logp, *conditions, broadcast_conditions=True):
    """Return ``logp`` where all conditions hold, ``-inf`` elsewhere.

    cf. ``pymc3/dist_math.py:38``. With ``broadcast_conditions=False`` the
    conditions are reduced to a scalar gate (used by multivariate logps).
    """
    if broadcast_conditions:
        cond = alltrue_elemwise(conditions)
    else:
        cond = alltrue_scalar(conditions)
    return jnp.where(cond, logp, -jnp.inf)


def logpow(x, m):
    """Safe m * log(x) with 0**0 = 1 (cf. ``dist_math.py:78``)."""
    return jnp.where(jnp.equal(x, 0), jnp.where(jnp.equal(m, 0), 0.0, -jnp.inf),
                     m * jnp.log(jnp.where(jnp.equal(x, 0), 1.0, x)))


def factln(n):
    return jss.gammaln(n + 1.0)


def betaln(x, y):
    return jss.gammaln(x) + jss.gammaln(y) - jss.gammaln(x + y)


def binomln(n, k):
    return factln(n) - factln(k) - factln(n - k)


def std_cdf(x):
    """Standard normal CDF (cf. ``dist_math.py:98``)."""
    return jss.ndtr(x)


def zvalue(value, mu=0.0, sigma=1.0):
    return (value - mu) / sigma


def normal_lcdf(mu, sigma, x):
    """log Phi((x-mu)/sigma), stable in both tails (cf. ``dist_math.py:105``).

    XLA's ``log_ndtr`` implements the same asymptotic switching the reference
    hand-codes with erfcx.
    """
    return jss.log_ndtr((x - mu) / sigma)


def normal_lccdf(mu, sigma, x):
    """log(1 - Phi((x-mu)/sigma)) (cf. ``dist_math.py:114``)."""
    return jss.log_ndtr(-(x - mu) / sigma)


def log_diff_normal_cdf(mu, sigma, x, y):
    """log(Phi((x-mu)/s) - Phi((y-mu)/s)), x > y (cf. ``dist_math.py:124``)."""
    x_z = (x - mu) / sigma
    y_z = (y - mu) / sigma
    # logsumexp-style stable difference
    a = normal_lcdf(mu, sigma, x)
    b = normal_lcdf(mu, sigma, y)
    upper = jnp.maximum(a, b)
    return jnp.where(
        (x_z > 0) & (y_z > 0),
        # work in the right tail with lccdf for stability
        _logdiffexp(normal_lccdf(mu, sigma, y), normal_lccdf(mu, sigma, x)),
        _logdiffexp(a, b),
    )


def _logdiffexp(a, b):
    return a + jnp.log1p(-jnp.exp(jnp.minimum(b - a, -1e-12)))


def sigma2rho(sigma):
    """sigma -> softplus-inverse rho (cf. ``dist_math.py:155``)."""
    return jnp.log(jnp.expm1(jnp.abs(sigma)))


def rho2sigma(rho):
    """rho -> softplus sigma (cf. ``dist_math.py:164``)."""
    return jax.nn.softplus(rho)


rho2sd = rho2sigma
sd2rho = sigma2rho


def log_normal(x, mean, **kwargs):
    """Normal log-density parameterized by sd/tau/w/rho (cf. ``dist_math.py:140``)."""
    sigma = kwargs.get("sigma", kwargs.get("sd"))
    w = kwargs.get("w")
    rho = kwargs.get("rho")
    tau = kwargs.get("tau")
    eps = kwargs.get("eps", 0.0)
    check = sum(x is not None for x in [sigma, w, rho, tau])
    if check > 1:
        raise ValueError("more than one required kwarg is passed")
    if check == 0:
        raise ValueError("none of required kwarg is passed")
    if sigma is not None:
        std = sigma
    elif w is not None:
        std = jnp.exp(w)
    elif rho is not None:
        std = rho2sigma(rho)
    else:
        std = tau ** (-0.5)
    std = std + f(eps)
    return f(-0.5) * ((x - mean) / std) ** 2 - jnp.log(std) - f(0.5 * np.log(2.0 * np.pi))


def MvNormal_logp(cov, delta):
    """Batched MvNormal log-density given covariance and residuals.

    Replaces ``MvNormalLogp`` (``dist_math.py:185-248``): XLA's ``cholesky`` +
    ``triangular_solve`` run on the device and autodiff gives exactly the
    hand-derived gradient the reference codes by hand.

    cov : (k, k), delta : (..., k)
    """
    k = cov.shape[-1]
    chol = jsl.cholesky(cov, lower=True)
    diag = jnp.diagonal(chol, axis1=-2, axis2=-1)
    ok = jnp.all(diag > 0) & jnp.all(jnp.isfinite(diag))
    safe_chol = jnp.where(ok, chol, jnp.eye(k, dtype=cov.dtype))
    # triangular_solve wants matching batch ranks: solve against delta^T
    # (k, batch) once instead of broadcasting the (k, k) factor
    d2 = jnp.atleast_2d(delta)
    sol = jsl.solve_triangular(safe_chol, d2.reshape(-1, k).T, lower=True)
    quad = jnp.sum(sol ** 2, axis=0).reshape(d2.shape[:-1])
    quad = quad if delta.ndim > 1 else quad[0]
    logdet = jnp.sum(jnp.log(jnp.diagonal(safe_chol, axis1=-2, axis2=-1)))
    out = -0.5 * (k * jnp.log(2.0 * jnp.pi) + quad) - logdet
    return jnp.where(ok, out, -jnp.inf)


class SplineWrapper:
    """Differentiable wrapper around a fixed scipy spline.

    The reference wraps ``scipy.interpolate`` splines as a Theano Op with a
    derivative spline (``dist_math.py:251-285``). Here we sample the spline
    densely once at construction (host side) and evaluate with
    ``jnp.interp`` — pure XLA, differentiable, device-resident.
    """

    def __init__(self, spline, x_lo=None, x_hi=None, n=4096):
        self.spline = spline
        knots = getattr(spline, "get_knots", lambda: None)()
        if x_lo is None:
            x_lo = float(knots[0]) if knots is not None else 0.0
        if x_hi is None:
            x_hi = float(knots[-1]) if knots is not None else 1.0
        self.x_grid = np.linspace(x_lo, x_hi, n)
        self.y_grid = f(np.asarray(spline(self.x_grid)))
        self.x_grid = f(self.x_grid)

    def __call__(self, x):
        return jnp.interp(x, self.x_grid, self.y_grid)


def i0e(x):
    """Exp-scaled modified Bessel I0 (cf. ``dist_math.py:288``)."""
    return jss.i0e(x)


def i1e(x):
    return jss.i1e(x)


def incomplete_beta(a, b, value):
    """Regularized incomplete beta I_x(a, b).

    The reference implements this with continued-fraction/power-series
    ``scan`` loops (``dist_math.py:367-503``); XLA ships it as ``betainc``.
    """
    return jss.betainc(a, b, value)


def random_choice(p, size=None, rng=None):
    """Categorical draws from (batched) probability vectors.

    Host-side numpy version for forward sampling (cf. ``dist_math.py:321``).
    """
    rng = rng or np.random
    p = np.asarray(p, dtype=np.float64)
    k = p.shape[-1]
    if p.ndim > 1:
        # batched probability rows: one independent draw per target position
        # via inverse-CDF on uniforms (vectorized, no python loop per draw)
        target = (tuple(np.atleast_1d(size)) if size is not None
                  else p.shape[:-1])
        pb = np.broadcast_to(p, target + (k,))
        cdf = np.cumsum(pb, axis=-1)
        cdf /= cdf[..., -1:]
        u = rng.uniform(size=target + (1,))
        return (u > cdf).sum(axis=-1)
    return rng.choice(k, p=p / p.sum(), size=size)


def clipped_beta_rvs(a, b, size=None, rng=None, dtype=None):
    """Beta draws clipped away from 0/1 at float ulp (cf. ``dist_math.py:553``)."""
    rng = rng or np.random
    dtype = dtype or floatX()
    out = np.asarray(rng.beta(a, b, size=size), dtype=dtype)
    eps = np.finfo(dtype).eps
    return np.clip(out, eps, 1.0 - eps)
