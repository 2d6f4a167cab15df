"""GP covariance kernels (cf. ``pymc3/gp/cov.py``).

Each kernel is callable as ``K(X) / K(X, Xs) / K(X, diag=True)`` and returns
a symbolic :class:`~pymc3_tpu.node.Node` when any operand (input matrix or a
hyperparameter like the lengthscale RV) is symbolic — the kernel matrix then
traces into the model's XLA logp program, which fuses the distance / Gram
work. Combination algebra ``Add``/``Prod`` (cf. ``cov.py:120-173``) and
the full kernel zoo: ExpQuad (``cov.py:331``), Matern52 (``:367``), Matern32
(``:386``), Periodic (``:308``), RatQuad (``:346``), Exponential (``:415``),
Cosine (``:429``), Linear (``:442``), Polynomial (``:472``), WarpedInput
(``:494``), Gibbs (``:533``), ScaledCov (``:600``), Coregion (``:645``),
Kron (``:175``), WhiteNoise (``:237``), Constant (``:214``).
"""
from __future__ import annotations

import functools
import operator
from numbers import Number
from typing import Optional, Sequence, Union

import numpy as np
import jax
import jax.numpy as jnp

from ..config import floatX
from ..node import Node, apply as node_apply, as_node

__all__ = [
    "Constant", "WhiteNoise", "ExpQuad", "RatQuad", "Exponential",
    "Matern52", "Matern32", "Matern12", "Linear", "Polynomial", "Cosine",
    "Periodic", "WarpedInput", "Gibbs", "Coregion", "ScaledCov", "Kron",
    "Covariance", "Combination", "Add", "Prod",
]


class Covariance:
    """Base class for kernels (cf. ``cov.py:34``).

    Parameters
    ----------
    input_dim : int
        Number of input columns.
    active_dims : list of int, optional
        Columns of X this kernel acts on.
    """

    def __init__(self, input_dim, active_dims=None):
        self.input_dim = int(input_dim)
        if active_dims is None:
            self.active_dims = np.arange(input_dim)
        else:
            self.active_dims = np.asarray(active_dims, int)

    def __call__(self, X, Xs=None, diag=False):
        if diag:
            return self.diag(X)
        return self.full(X, Xs)

    def diag(self, X):
        return node_apply(lambda K: jnp.diag(K), self.full(X, None))

    def full(self, X, Xs=None):
        raise NotImplementedError

    def _slice(self, X, Xs=None):
        idx = self.active_dims

        def slc(M):
            M = jnp.asarray(M, floatX())
            if M.ndim == 1:
                M = M[:, None]
            return M[:, idx]
        X = node_apply(slc, X) if isinstance(X, Node) else slc(X)
        if Xs is not None:
            Xs = node_apply(slc, Xs) if isinstance(Xs, Node) else slc(Xs)
        return X, Xs

    # combination algebra (cf. cov.py:96-119)
    def __add__(self, other):
        return Add([self, other])

    def __radd__(self, other):
        return Add([other, self])

    def __mul__(self, other):
        return Prod([self, other])

    def __rmul__(self, other):
        return Prod([other, self])

    def __pow__(self, other):
        return Exponentiated(self, other)

    def __array_wrap__(self, result):
        # keep numpy scalars from consuming `np_scalar * cov`
        return result


class Combination(Covariance):
    """cf. ``cov.py:120``."""

    def __init__(self, factor_list):
        input_dim = max(factor.input_dim for factor in factor_list
                        if isinstance(factor, Covariance))
        super().__init__(input_dim=input_dim)
        self.factor_list = []
        for factor in factor_list:
            if isinstance(factor, self.__class__):
                self.factor_list.extend(factor.factor_list)
            else:
                self.factor_list.append(factor)

    def merge_factors(self, X, Xs=None, diag=False):
        factor_list = []
        for factor in self.factor_list:
            if isinstance(factor, Covariance):
                factor_list.append(factor(X, Xs, diag))
            else:
                factor_list.append(factor)
        return factor_list


class Add(Combination):
    def __call__(self, X, Xs=None, diag=False):
        return functools.reduce(operator.add,
                                self.merge_factors(X, Xs, diag))

    full = __call__


class Prod(Combination):
    def __call__(self, X, Xs=None, diag=False):
        return functools.reduce(operator.mul,
                                self.merge_factors(X, Xs, diag))

    full = __call__


class Exponentiated(Covariance):
    """cf. ``cov.py:142`` Kernel ** p."""

    def __init__(self, kernel, power):
        self.kernel = kernel
        self.power = power
        super().__init__(input_dim=kernel.input_dim,
                         active_dims=kernel.active_dims)

    def __call__(self, X, Xs=None, diag=False):
        return self.kernel(X, Xs, diag) ** self.power

    full = __call__


class Kron(Covariance):
    """Kronecker product of kernels over column blocks (cf. ``cov.py:175``)."""

    def __init__(self, factor_list):
        self.input_dims = [factor.input_dim for factor in factor_list]
        input_dim = sum(self.input_dims)
        super().__init__(input_dim=input_dim)
        self.factor_list = factor_list

    def _split(self, X, Xs):
        indices = np.cumsum(self.input_dims)
        starts = np.concatenate([[0], indices[:-1]])
        Xp, Xsp = [], []
        for s, d in zip(starts, self.input_dims):
            slc = lambda M, s=s, d=d: jnp.asarray(M, floatX())[:, s:s + d]
            Xp.append(node_apply(slc, X) if isinstance(X, Node) else slc(X))
            if Xs is not None:
                Xsp.append(node_apply(slc, Xs) if isinstance(Xs, Node)
                           else slc(Xs))
            else:
                Xsp.append(None)
        return Xp, Xsp

    def full(self, X, Xs=None):
        """Inputs live on the product grid: each row of X concatenates one
        coordinate per factor, so the Kronecker structure is an ELEMENTWISE
        product of the per-block kernels (cf. ``cov.py:202-212``)."""
        Xp, Xsp = self._split(X, Xs)
        pieces = [f.full(xp, xsp)
                  for f, xp, xsp in zip(self.factor_list, Xp, Xsp)]
        return functools.reduce(operator.mul, pieces)


class Constant(Covariance):
    """cf. ``cov.py:214``."""

    def __init__(self, c):
        super().__init__(1, None)
        self.c = c

    def diag(self, X):
        return node_apply(
            lambda X_, c: jnp.full(jnp.shape(X_)[0], c, floatX()),
            X, self.c)

    def full(self, X, Xs=None):
        if Xs is None:
            return node_apply(
                lambda X_, c: jnp.full((jnp.shape(X_)[0],) * 2, c, floatX()),
                X, self.c)
        return node_apply(
            lambda X_, Xs_, c: jnp.full(
                (jnp.shape(X_)[0], jnp.shape(Xs_)[0]), c, floatX()),
            X, Xs, self.c)


class WhiteNoise(Covariance):
    """cf. ``cov.py:237``."""

    def __init__(self, sigma):
        super().__init__(1, None)
        self.sigma = sigma

    def diag(self, X):
        return node_apply(
            lambda X_, s: jnp.full(jnp.shape(X_)[0], s ** 2, floatX()),
            X, self.sigma)

    def full(self, X, Xs=None):
        if Xs is None:
            return node_apply(
                lambda X_, s: jnp.eye(jnp.shape(X_)[0], dtype=floatX())
                * s ** 2, X, self.sigma)
        return node_apply(
            lambda X_, Xs_, s: jnp.zeros(
                (jnp.shape(X_)[0], jnp.shape(Xs_)[0]), floatX()),
            X, Xs, self.sigma)


# --------------------------------------------------------------------------
# Fused stationary covariance: K = f(pairwise squared distance)
# --------------------------------------------------------------------------
# kind -> f(d2); d2 is the squared distance in lengthscale units
STATIONARY_KINDS = ("expquad", "matern52", "matern32", "matern12",
                    "exponential")

_EPS = 1e-12


def _apply_covfn(kind, d2):
    """K = f(d²) for one of ``STATIONARY_KINDS``."""
    if kind == "expquad":
        return jnp.exp(-0.5 * d2)
    if kind == "matern52":
        t = jnp.sqrt(5.0 * d2 + _EPS)
        return (1.0 + t + (t * t) / 3.0) * jnp.exp(-t)
    if kind == "matern32":
        t = jnp.sqrt(3.0 * d2 + _EPS)
        return (1.0 + t) * jnp.exp(-t)
    if kind == "matern12":
        return jnp.exp(-jnp.sqrt(d2 + _EPS))
    if kind == "exponential":
        # k = exp(-r/2) — matches Exponential (reference cov.py:415)
        return jnp.exp(-0.5 * jnp.sqrt(d2 + _EPS))
    raise ValueError(f"unknown stationary kind: {kind}")


def _dcov_dd2(kind, d2):
    """dK/d(d²) in closed form, for the custom VJP below."""
    if kind == "expquad":
        return -0.5 * jnp.exp(-0.5 * d2)
    if kind == "matern52":
        t = jnp.sqrt(5.0 * d2 + _EPS)
        return -(5.0 / 6.0) * (1.0 + t) * jnp.exp(-t)
    if kind == "matern32":
        return -1.5 * jnp.exp(-jnp.sqrt(3.0 * d2 + _EPS))
    if kind == "matern12":
        r = jnp.sqrt(d2 + _EPS)
        return jnp.exp(-r) * (-0.5 / r)
    if kind == "exponential":
        r = jnp.sqrt(d2 + _EPS)
        return jnp.exp(-0.5 * r) * (-0.25 / r)
    raise ValueError(f"unknown stationary kind: {kind}")


def _sqdist_exact(X, Xs):
    """Float32-safe pairwise squared distance.

    Low-dim inputs (the usual GP case) take the exact pairwise-difference
    form: the x²+x'²-2xx' matmul trick cancels catastrophically in float32
    (O(1e-4) error on nearby points → indefinite K). Above 32 features the
    (n, m, d) intermediate would dominate memory, so the matmul form is
    used there."""
    if X.shape[-1] <= 32:
        d2 = jnp.sum((X[:, None, :] - Xs[None, :, :]) ** 2, axis=-1)
    else:
        d2 = (jnp.sum(X ** 2, axis=-1)[:, None]
              + jnp.sum(Xs ** 2, axis=-1)[None, :] - 2 * X @ Xs.T)
    return jnp.clip(d2, 0.0, jnp.inf)


@functools.lru_cache(maxsize=None)
def _stationary_op(kind):
    @jax.custom_vjp
    def cov(X, Xs):
        return _apply_covfn(kind, _sqdist_exact(X, Xs))

    def fwd(X, Xs):
        return cov(X, Xs), (X, Xs)

    def bwd(res, g):
        X, Xs = res
        # w = g * dK/dd²; then dX = 2(rowsum(w)·X − w@Xs): two matmuls on
        # a recomputed d², instead of autodiff saving (n, m, d) residuals
        d2 = _sqdist_exact(X, Xs)
        w = g * _dcov_dd2(kind, d2)
        dX = 2.0 * (jnp.sum(w, axis=1, keepdims=True) * X - w @ Xs)
        dXs = 2.0 * (jnp.sum(w, axis=0)[:, None] * Xs - w.T @ X)
        return dX, dXs

    cov.defvjp(fwd, bwd)
    return cov


def stationary_cov(X, Xs=None, kind="expquad"):
    """K = f(pairwise squared distance) for lengthscale-scaled inputs.

    Parameters
    ----------
    X : (n, d) array.  Xs : (m, d) array or None (=> Xs = X).
    kind : one of ``STATIONARY_KINDS``.
    """
    if kind not in STATIONARY_KINDS:
        raise ValueError(f"kind must be one of {STATIONARY_KINDS}")
    X = jnp.asarray(X)
    Xs = X if Xs is None else jnp.asarray(Xs)
    if X.ndim != 2 or Xs.ndim != 2:
        raise ValueError("X and Xs must be rank-2 (n, d)")
    return _stationary_op(kind)(X, Xs)


class Stationary(Covariance):
    """Base for stationary kernels (cf. ``cov.py:262``).

    Parameters: ``ls`` (lengthscale) or ``ls_inv``.
    """

    def __init__(self, input_dim, ls=None, ls_inv=None, active_dims=None):
        super().__init__(input_dim, active_dims)
        if (ls is None and ls_inv is None) or \
                (ls is not None and ls_inv is not None):
            raise ValueError("Specify one of ls or ls_inv")
        if ls_inv is not None:
            if isinstance(ls_inv, (list, tuple)):
                ls = 1.0 / np.asarray(ls_inv)
            elif isinstance(ls_inv, Node):
                ls = node_apply(lambda v: 1.0 / v, ls_inv)
            else:
                ls = 1.0 / ls_inv
        # ARD lengthscales arrive as python lists in the reference API
        # (e.g. ExpQuad(3, [0.1, 0.2, 0.3]), ``test_gp.py:700``)
        if isinstance(ls, (list, tuple)):
            ls = np.asarray(ls)
        self.ls = ls

    @staticmethod
    def _sqdist(X, Xs, ls):
        X = jnp.asarray(X, floatX()) / ls
        Xs = X if Xs is None else jnp.asarray(Xs, floatX()) / ls
        # Mean-centering is distance-invariant and shrinks the magnitudes
        # entering either formula, which matters in float32 (the default).
        c = jnp.mean(X, axis=0)
        return _sqdist_exact(X - c, Xs - c)

    def square_dist(self, X, Xs=None):
        X, Xs = self._slice(X, Xs)
        if Xs is None:
            return node_apply(lambda X_, ls: self._sqdist(X_, None, ls),
                              X, self.ls)
        return node_apply(lambda X_, Xs_, ls: self._sqdist(X_, Xs_, ls),
                          X, Xs, self.ls)

    def euclidean_dist(self, X, Xs=None):
        return node_apply(lambda d2: jnp.sqrt(d2 + 1e-12),
                          self.square_dist(X, Xs))

    def diag(self, X):
        return node_apply(
            lambda X_: jnp.ones(jnp.shape(X_)[0], floatX()), X)

    def full(self, X, Xs=None):
        raise NotImplementedError

    # kernels whose k = f(d²) is one of STATIONARY_KINDS set this and route
    # full() through _fused_full
    _fused_kind = None

    def _fused_full(self, X, Xs=None):
        """K via ``stationary_cov``: one fused distance+covariance program
        with a closed-form VJP."""
        kind = self._fused_kind

        def f(X_, Xs_, ls):
            Xl = jnp.asarray(X_, floatX()) / ls
            Xsl = Xl if Xs_ is None else jnp.asarray(Xs_, floatX()) / ls
            # mean-centering: distance-invariant float32 safety, as in
            # _sqdist above
            c = jnp.mean(Xl, axis=0)
            return stationary_cov(Xl - c, Xsl - c, kind=kind)

        X, Xs = self._slice(X, Xs)
        if Xs is None:
            return node_apply(lambda X_, ls: f(X_, None, ls), X, self.ls)
        return node_apply(f, X, Xs, self.ls)


class ExpQuad(Stationary):
    r"""k(x,x') = exp(-|x-x'|^2 / (2 l^2)) (cf. ``cov.py:331``)."""

    _fused_kind = "expquad"
    full = Stationary._fused_full


class RatQuad(Stationary):
    r"""Rational quadratic (cf. ``cov.py:346``)."""

    def __init__(self, input_dim, alpha, ls=None, ls_inv=None,
                 active_dims=None):
        super().__init__(input_dim, ls, ls_inv, active_dims)
        self.alpha = alpha

    def full(self, X, Xs=None):
        return node_apply(
            lambda d2, a: jnp.power(1.0 + 0.5 * d2 / a, -a),
            self.square_dist(X, Xs), self.alpha)


class Matern52(Stationary):
    r"""cf. ``cov.py:367``."""

    _fused_kind = "matern52"
    full = Stationary._fused_full


class Matern32(Stationary):
    r"""cf. ``cov.py:386``."""

    _fused_kind = "matern32"
    full = Stationary._fused_full


class Matern12(Stationary):
    r"""cf. ``cov.py`` Matern12 (=Exponential in distance form)."""

    _fused_kind = "matern12"
    full = Stationary._fused_full


class Exponential(Stationary):
    r"""k = exp(-|x-x'| / (2l)) (cf. ``cov.py:415``)."""

    _fused_kind = "exponential"
    full = Stationary._fused_full


class Cosine(Stationary):
    r"""cf. ``cov.py:429``."""

    def full(self, X, Xs=None):
        return node_apply(lambda r: jnp.cos(2 * np.pi * r),
                          self.euclidean_dist(X, Xs))


class Periodic(Stationary):
    r"""Periodic kernel (cf. ``cov.py:308``)."""

    def __init__(self, input_dim, period, ls=None, ls_inv=None,
                 active_dims=None):
        super().__init__(input_dim, ls, ls_inv, active_dims)
        self.period = period

    def full(self, X, Xs=None):
        X, Xs = self._slice(X, Xs)

        def k(X_, Xs_, per, ls):
            X_ = jnp.asarray(X_, floatX())
            Xs_ = X_ if Xs_ is None else jnp.asarray(Xs_, floatX())
            d = X_[:, None, :] - Xs_[None, :, :]
            s = jnp.sin(np.pi * d / per) / ls
            return jnp.exp(-2.0 * jnp.sum(s ** 2, axis=-1))
        if Xs is None:
            return node_apply(lambda X_, p, l: k(X_, None, p, l),
                              X, self.period, self.ls)
        return node_apply(k, X, Xs, self.period, self.ls)


class Linear(Covariance):
    r"""k = (x-c)(x'-c) (cf. ``cov.py:442``)."""

    def __init__(self, input_dim, c, active_dims=None):
        super().__init__(input_dim, active_dims)
        self.c = c

    def _common(self, X, Xs=None):
        X, Xs = self._slice(X, Xs)

        def k(X_, Xs_, c):
            Xc = jnp.asarray(X_, floatX()) - c
            Xsc = Xc if Xs_ is None else jnp.asarray(Xs_, floatX()) - c
            return Xc @ Xsc.T
        if Xs is None:
            return node_apply(lambda X_, c: k(X_, None, c), X, self.c)
        return node_apply(k, X, Xs, self.c)

    def full(self, X, Xs=None):
        return self._common(X, Xs)

    def diag(self, X):
        X, _ = self._slice(X, None)
        return node_apply(
            lambda X_, c: jnp.sum((jnp.asarray(X_, floatX()) - c) ** 2,
                                  axis=-1), X, self.c)


class Polynomial(Linear):
    r"""cf. ``cov.py:472``."""

    def __init__(self, input_dim, c, d, offset, active_dims=None):
        super().__init__(input_dim, c, active_dims)
        self.d = d
        self.offset = offset

    def full(self, X, Xs=None):
        lin = self._common(X, Xs)
        return node_apply(lambda L, o, d: jnp.power(L + o, d),
                          lin, self.offset, self.d)

    def diag(self, X):
        lin = super().diag(X)
        return node_apply(lambda L, o, d: jnp.power(L + o, d),
                          lin, self.offset, self.d)


class WarpedInput(Covariance):
    r"""Kernel on warped inputs k(w(x), w(x')) (cf. ``cov.py:494``)."""

    def __init__(self, input_dim, cov_func, warp_func, args=None,
                 active_dims=None):
        super().__init__(input_dim, active_dims)
        if not callable(warp_func):
            raise TypeError("warp_func must be callable")
        if not isinstance(cov_func, Covariance):
            raise TypeError("Must be or inherit from the Covariance class")
        self.w = lambda x, args: warp_func(x, *args) if args is not None \
            else warp_func(x)
        self.args = args
        self.cov_func = cov_func

    def full(self, X, Xs=None):
        X, Xs = self._slice(X, Xs)
        Xw = node_apply(lambda x: self.w(x, self.args), as_node(X)) \
            if isinstance(X, Node) else self.w(X, self.args)
        if Xs is None:
            return self.cov_func.full(Xw, None)
        Xsw = node_apply(lambda x: self.w(x, self.args), as_node(Xs)) \
            if isinstance(Xs, Node) else self.w(Xs, self.args)
        return self.cov_func.full(Xw, Xsw)

    def diag(self, X):
        X, _ = self._slice(X, None)
        Xw = self.w(X, self.args)
        return self.cov_func.diag(Xw)


class Gibbs(Covariance):
    r"""Non-stationary Gibbs kernel with input-dependent lengthscale
    (cf. ``cov.py:533``)."""

    def __init__(self, input_dim, lengthscale_func, args=None,
                 active_dims=None):
        super().__init__(input_dim, active_dims)
        if active_dims is not None:
            if len(np.atleast_1d(active_dims)) > 1:
                raise NotImplementedError("Higher dimensional inputs are "
                                          "untested")
        if not callable(lengthscale_func):
            raise TypeError("lengthscale_func must be callable")
        self.lfunc = lengthscale_func
        self.args = args

    def _ls(self, x):
        if self.args is not None:
            return self.lfunc(x, *self.args)
        return self.lfunc(x)

    def full(self, X, Xs=None):
        X, Xs = self._slice(X, Xs)

        def k(X_, Xs_):
            X_ = jnp.asarray(X_, floatX())
            rx = self._ls(X_.ravel())
            Xs__ = X_ if Xs_ is None else jnp.asarray(Xs_, floatX())
            rz = self._ls(Xs__.ravel())
            x = X_.ravel()
            z = Xs__.ravel()
            rx2 = rx ** 2
            rz2 = rz ** 2
            d2 = (x[:, None] - z[None, :]) ** 2
            denom = rx2[:, None] + rz2[None, :]
            return jnp.sqrt(2.0 * jnp.outer(rx, rz) / denom) * \
                jnp.exp(-d2 / denom)
        if Xs is None:
            return node_apply(lambda X_: k(X_, None), X)
        return node_apply(k, X, Xs)

    def diag(self, X):
        X, _ = self._slice(X, None)
        return node_apply(
            lambda X_: jnp.ones(jnp.shape(X_)[0], floatX()), X)


class ScaledCov(Covariance):
    r"""cov scaled by an input-dependent function (cf. ``cov.py:600``)."""

    def __init__(self, input_dim, cov_func, scaling_func, args=None,
                 active_dims=None):
        super().__init__(input_dim, active_dims)
        if not callable(scaling_func):
            raise TypeError("scaling_func must be callable")
        if not isinstance(cov_func, Covariance):
            raise TypeError("Must be or inherit from the Covariance class")
        self.cov_func = cov_func
        self.scaling_func = scaling_func
        self.args = args

    def _scf(self, x):
        if self.args is not None:
            return self.scaling_func(x, *self.args)
        return self.scaling_func(x)

    def full(self, X, Xs=None):
        X, Xs = self._slice(X, Xs)
        K = self.cov_func.full(X, Xs)

        def scale(K_, X_, Xs_):
            sx = jnp.ravel(self._scf(jnp.asarray(X_, floatX())))
            sz = sx if Xs_ is None else jnp.ravel(
                self._scf(jnp.asarray(Xs_, floatX())))
            return jnp.outer(sx, sz) * K_
        if Xs is None:
            return node_apply(lambda K_, X_: scale(K_, X_, None), K, X)
        return node_apply(scale, K, X, Xs)

    def diag(self, X):
        X, _ = self._slice(X, None)
        d = self.cov_func.diag(X)
        return node_apply(
            lambda d_, X_: jnp.ravel(
                self._scf(jnp.asarray(X_, floatX()))) ** 2 * d_, d, X)


class Coregion(Covariance):
    r"""Coregionalization kernel B[i,j] over integer task indices
    (cf. ``cov.py:645``)."""

    def __init__(self, input_dim, W=None, kappa=None, B=None,
                 active_dims=None):
        super().__init__(input_dim, active_dims)
        if len(np.atleast_1d(self.active_dims)) != 1:
            raise ValueError("Coregion requires exactly one dimension to be "
                             "active")
        make_B = W is not None or kappa is not None
        if make_B and B is not None:
            raise ValueError("Exactly one of (W, kappa) and B must be "
                             "provided to Coregion")
        if make_B:
            self.W = W
            self.kappa = kappa
            self.B = node_apply(
                lambda W_, k_: jnp.asarray(W_, floatX()) @
                jnp.asarray(W_, floatX()).T + jnp.diag(
                    jnp.asarray(k_, floatX())), W, kappa)
        elif B is not None:
            self.B = as_node(B)
        else:
            raise ValueError("Exactly one of (W, kappa) and B must be "
                             "provided to Coregion")

    def full(self, X, Xs=None):
        X, Xs = self._slice(X, Xs)

        def k(B, X_, Xs_):
            ix = jnp.asarray(X_).ravel().astype(jnp.int32)
            iz = ix if Xs_ is None else \
                jnp.asarray(Xs_).ravel().astype(jnp.int32)
            return B[jnp.ix_(ix, iz)]
        if Xs is None:
            return node_apply(lambda B, X_: k(B, X_, None), self.B, X)
        return node_apply(k, self.B, X, Xs)

    def diag(self, X):
        X, _ = self._slice(X, None)
        return node_apply(
            lambda B, X_: jnp.diag(B)[
                jnp.asarray(X_).ravel().astype(jnp.int32)], self.B, X)
