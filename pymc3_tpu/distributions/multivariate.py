"""Multivariate distributions, mirroring
``pymc3/distributions/multivariate.py`` (1920 LoC).

All dense linear algebra (cholesky, triangular solve, eigh) lowers to XLA
intrinsics (cuSOLVER/cuBLAS on the GPU); the reference's hand-written cholesky
gradients (``MvNormalLogp``, ``dist_math.py:185``) are unnecessary — XLA
autodiff produces them.
"""
from __future__ import annotations

import numpy as np
import scipy.stats as st
import scipy.linalg
import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import jax.scipy.special as jss

from ..config import floatX, intX
from ..node import Node, as_node, apply, evaluate
from ..math import kron_dot, kron_diag
from . import transforms
from .dist_math import bound, factln, logpow
from .special import multigammaln, gammaln
from .continuous import get_tau_sigma, Normal, ChiSquared
from .distribution import (
    Continuous, Discrete, Distribution, draw_values, generate_samples,
)
from .shape_utils import to_tuple

__all__ = [
    "MvNormal", "MvStudentT", "Dirichlet", "Multinomial", "Wishart",
    "WishartBartlett", "LKJCorr", "LKJCholeskyCov", "MatrixNormal",
    "KroneckerNormal",
]


def _an(x):
    return x if isinstance(x, Node) else as_node(floatX(np.asarray(x)))


def _norm(env, memo):
    return (env or {}), ({} if memo is None else memo)


class _QuadFormBase(Continuous):
    """Shared chol/cov/tau quadratic-form machinery
    (cf. ``multivariate.py:49``)."""

    def __init__(self, mu=None, cov=None, chol=None, tau=None, lower=True,
                 *args, **kwargs):
        if len([i for i in [tau, cov, chol] if i is not None]) != 1:
            raise ValueError(
                "Incompatible parameterization. Specify exactly one of "
                "tau, cov, or chol.")
        self.mu = _an(mu if mu is not None else 0.0)
        self._cov_param = "cov" if cov is not None else (
            "chol" if chol is not None else "tau")
        if cov is not None:
            self.cov = _an(cov)
        elif chol is not None:
            chol_node = _an(chol)
            if not lower:
                chol_node = apply(lambda c: jnp.swapaxes(c, -1, -2), chol_node)
            self.chol_cov = chol_node
        else:
            self.tau = _an(tau)
        super().__init__(*args, **kwargs)

    def _chol(self, env, memo):
        """Lower cholesky of the covariance + ok flag (traceable)."""
        if self._cov_param == "cov":
            cov = evaluate(self.cov, env, memo)
            chol = jsl.cholesky(cov, lower=True)
        elif self._cov_param == "chol":
            chol = evaluate(self.chol_cov, env, memo)
        else:
            tau = evaluate(self.tau, env, memo)
            # chol(cov) from chol(tau): cov = inv(tau)
            chol_tau = jsl.cholesky(tau, lower=True)
            k = chol_tau.shape[-1]
            inv = jsl.solve_triangular(chol_tau, jnp.eye(k, dtype=chol_tau.dtype),
                                       lower=True)
            chol = jsl.cholesky(inv.T @ inv, lower=True)
        diag = jnp.diagonal(chol, axis1=-2, axis2=-1)
        ok = jnp.all(jnp.isfinite(diag)) & jnp.all(diag > 0)
        safe_chol = jnp.where(ok, chol,
                              jnp.eye(chol.shape[-1], dtype=chol.dtype))
        return safe_chol, ok

    def _quaddist(self, value, env, memo):
        """Return (squared Mahalanobis distance, logdet, ok)."""
        mu = evaluate(self.mu, env, memo)
        chol, ok = self._chol(env, memo)
        delta = jnp.asarray(value) - mu
        if delta.ndim == 1:
            delta = delta[None, :]
            squeeze = True
        else:
            squeeze = False
        sol = jsl.solve_triangular(chol, delta.T, lower=True).T
        quaddist = jnp.sum(sol ** 2, axis=-1)
        logdet = jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)))
        if squeeze:
            quaddist = quaddist[0]
        return quaddist, logdet, ok

    def _cov_value(self, point=None):
        if self._cov_param == "cov":
            cov, = draw_values([self.cov], point=point)
        elif self._cov_param == "chol":
            chol, = draw_values([self.chol_cov], point=point)
            cov = np.asarray(chol) @ np.asarray(chol).T
        else:
            tau, = draw_values([self.tau], point=point)
            cov = np.linalg.inv(tau)
        return cov


class MvNormal(_QuadFormBase):
    r"""Multivariate normal (cf. ``multivariate.py:167``)."""

    def __init__(self, mu, cov=None, tau=None, chol=None, lower=True,
                 *args, **kwargs):
        if kwargs.get("shape") is None:
            mu_shape = np.shape(np.asarray(as_node(mu).test_value
                                           if isinstance(mu, Node) else mu))
            kwargs["shape"] = kwargs.pop("shape", None) or mu_shape
        super().__init__(mu=mu, cov=cov, tau=tau, chol=chol, lower=lower,
                         *args, **kwargs)
        self.mean = self.median = self.mode = self.mu

    def logp(self, value, env=None, memo=None):
        env, memo = _norm(env, memo)
        quaddist, logdet, ok = self._quaddist(value, env, memo)
        k = jnp.asarray(value).shape[-1]
        out = -0.5 * (k * jnp.log(2.0 * np.pi) + quaddist) - logdet
        return jnp.where(ok, out, -jnp.inf)

    def random(self, point=None, size=None):
        mu, = draw_values([self.mu], point=point, size=size)
        cov = self._cov_value(point)
        if np.ndim(mu) == 1:
            return generate_samples(
                lambda mu, size: np.random.multivariate_normal(
                    np.asarray(mu), cov, size=size[:-1] if size else None),
                mu, dist_shape=self.shape, size=size,
                broadcast_shape=np.shape(mu))
        return _batched_mvn(mu, cov, size)


def _batched_mvn(mu, cov, size):
    mu = np.asarray(mu)
    flat = mu.reshape(-1, mu.shape[-1])
    L = np.linalg.cholesky(cov)
    out_shape = (size if isinstance(size, tuple) else
                 ((size,) if size else ())) + mu.shape
    z = np.random.standard_normal(out_shape)
    return mu + z @ L.T


class MvStudentT(_QuadFormBase):
    r"""Multivariate Student's t (cf. ``multivariate.py:344``)."""

    def __init__(self, nu, Sigma=None, mu=None, cov=None, tau=None, chol=None,
                 lower=True, *args, **kwargs):
        if Sigma is not None:
            if cov is not None:
                raise ValueError("Specify only one of cov and Sigma")
            cov = Sigma
        self.nu = _an(nu)
        if kwargs.get("shape") is None:
            mu_shape = np.shape(np.asarray(as_node(mu).test_value
                                           if isinstance(mu, Node) else mu))
            kwargs["shape"] = kwargs.pop("shape", None) or mu_shape
        super().__init__(mu=mu, cov=cov, tau=tau, chol=chol, lower=lower,
                         *args, **kwargs)
        self.mean = self.median = self.mode = self.mu

    def logp(self, value, env=None, memo=None):
        env, memo = _norm(env, memo)
        nu = evaluate(self.nu, env, memo)
        quaddist, logdet, ok = self._quaddist(value, env, memo)
        k = jnp.asarray(value).shape[-1]
        norm = (gammaln((nu + k) / 2.0) - gammaln(nu / 2.0)
                - 0.5 * k * jnp.log(nu * np.pi))
        inner = -(nu + k) / 2.0 * jnp.log1p(quaddist / nu)
        return jnp.where(ok, norm + inner - logdet, -jnp.inf)

    def random(self, point=None, size=None):
        nu, mu = draw_values([self.nu, self.mu], point=point, size=size)
        cov = self._cov_value(point)
        d = cov.shape[-1]

        def _rvs(nu, mu, size):
            # size arrives as batch + (d,); the event dim is produced by the
            # multivariate draw itself
            batch = size[:-1] if size else None
            chi2 = np.asarray(np.random.chisquare(nu, size=batch)) / nu
            z = np.random.multivariate_normal(np.zeros(d), cov, size=batch)
            return np.asarray(mu) + z / np.sqrt(chi2)[..., None]
        return generate_samples(_rvs, nu, mu, dist_shape=self.shape,
                                size=size, broadcast_shape=np.shape(mu))


class Dirichlet(Continuous):
    r"""Dirichlet over the simplex (cf. ``multivariate.py:465``)."""

    def __init__(self, a, transform=transforms.stick_breaking,
                 *args, **kwargs):
        self.a = _an(a)
        if kwargs.get("shape") is None:
            kwargs["shape"] = tuple(np.shape(self.a.test_value))
        self.mean = apply(lambda a: a / jnp.sum(a, axis=-1, keepdims=True),
                          self.a)
        self.mode = apply(
            lambda a: jnp.where(jnp.all(a > 1),
                                (a - 1.0) / jnp.sum(a - 1.0, axis=-1,
                                                    keepdims=True),
                                jnp.nan), self.a)
        kwargs.setdefault("transform", transform)
        super().__init__(defaults=("mean",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        env, memo = _norm(env, memo)
        a, = self._ev_params(("a",), env, memo)
        value = jnp.asarray(value)
        safe = jnp.where(value > 0, value, 1.0)
        lp = jnp.sum(logpow(value, a - 1.0)
                     - gammaln(a), axis=-1) + gammaln(jnp.sum(a, axis=-1))
        return bound(lp,
                     jnp.all(value >= 0, axis=-1),
                     jnp.all(value <= 1, axis=-1),
                     jnp.all(a > 0, axis=-1),
                     broadcast_conditions=False)

    def random(self, point=None, size=None):
        """size + dist_shape draws via normalized gammas (handles batched
        concentration uniformly; cf. reference ``Dirichlet.random``,
        ``multivariate.py:522``)."""
        a, = draw_values([self.a], point=point, size=size)
        a = np.asarray(a)
        shape = tuple(np.atleast_1d(self.shape).astype(int)) \
            if np.size(self.shape) else a.shape
        a_full = np.broadcast_to(a, shape)
        size_t = (tuple(size) if isinstance(size, (tuple, list))
                  else ((int(size),) if size is not None else ()))
        g = np.random.standard_gamma(a_full, size=size_t + shape)
        return g / g.sum(axis=-1, keepdims=True)


class Multinomial(Discrete):
    r"""Multinomial (cf. ``multivariate.py:582``)."""

    def __init__(self, n, p, *args, **kwargs):
        self.n = _an(n)
        self.p = apply(lambda p: p / jnp.sum(p, axis=-1, keepdims=True),
                       _an(p))
        if kwargs.get("shape") is None:
            kwargs["shape"] = tuple(np.broadcast_shapes(
                np.shape(self.p.test_value),
                np.shape(self.n.test_value) + (np.shape(self.p.test_value)[-1],)))
        self.mean = apply(lambda n, p: jnp.asarray(n)[..., None] * p
                          if jnp.ndim(n) else n * p, self.n, self.p)
        self.mode = apply(
            lambda n, p: jnp.asarray(
                jnp.floor(jnp.asarray(n)[..., None] * p
                          if jnp.ndim(n) else n * p), dtype=intX()),
            self.n, self.p)
        super().__init__(*args, **kwargs)

    def logp(self, value, env=None, memo=None):
        env, memo = _norm(env, memo)
        n, p = self._ev_params(("n", "p"), env, memo)
        value = jnp.asarray(value)
        lp = factln(n) + jnp.sum(-factln(value) + logpow(p, value), axis=-1)
        return bound(lp,
                     jnp.all(value >= 0, axis=-1),
                     jnp.equal(jnp.sum(value, axis=-1), n),
                     jnp.all(p <= 1, axis=-1),
                     jnp.abs(jnp.sum(p, axis=-1) - 1.0) < 1e-4,
                     broadcast_conditions=False)

    def random(self, point=None, size=None):
        """size + dist_shape draws (cf. reference ``Multinomial.random``,
        ``multivariate.py:702``)."""
        n, p = draw_values([self.n, self.p], point=point, size=size)
        n = np.asarray(n)
        p = np.asarray(p, dtype=np.float64)
        shape = tuple(np.atleast_1d(self.shape).astype(int)) \
            if np.size(self.shape) else p.shape
        size_t = (tuple(size) if isinstance(size, (tuple, list))
                  else ((int(size),) if size is not None else ()))
        if p.ndim == 1 and n.ndim == 0 and shape == p.shape:
            s = size_t + shape[:-1]
            return np.random.multinomial(int(n), p / p.sum(),
                                         size=s if s else None)
        # batched parameters: one multinomial per leading position
        out_shape = size_t + shape
        flatp = np.broadcast_to(p, out_shape).reshape(-1, shape[-1])
        flatn = np.broadcast_to(n, out_shape[:-1]).reshape(-1)
        draws = np.stack([np.random.multinomial(int(ni), pi / pi.sum())
                          for ni, pi in zip(flatn, flatp)])
        return draws.reshape(out_shape)


def posdef(matrix):
    """True if matrix is positive definite (host-side, cf. the
    ``PosDefMatrix`` Op at ``multivariate.py:747``)."""
    try:
        np.linalg.cholesky(np.asarray(matrix))
        return True
    except np.linalg.LinAlgError:
        return False


class Wishart(Continuous):
    r"""Wishart on covariance matrices (cf. ``multivariate.py:788``).

    As in the reference, direct sampling of a Wishart prior is discouraged —
    use :func:`LKJCholeskyCov` or :func:`WishartBartlett`.
    """

    def __init__(self, nu, V, *args, **kwargs):
        import warnings
        warnings.warn(
            "The Wishart distribution can currently not be used for MCMC "
            "sampling. Use LKJCholeskyCov or WishartBartlett instead.",
            UserWarning)
        self.nu = _an(nu)
        self.V = _an(V)
        self.p = p = int(np.shape(self.V.test_value)[-1])
        if kwargs.get("shape") is None:
            kwargs["shape"] = (p, p)
        self.mean = apply(lambda nu, V: nu * V, self.nu, self.V)
        self.mode = apply(
            lambda nu, V: jnp.where(nu >= p + 1, (nu - p - 1) * V, jnp.nan),
            self.nu, self.V)
        super().__init__(defaults=("mean",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        env, memo = _norm(env, memo)
        nu, V = self._ev_params(("nu", "V"), env, memo)
        p = self.p
        X = jnp.asarray(value)
        sign_x, logdet_x = jnp.linalg.slogdet(X)
        sign_v, logdet_v = jnp.linalg.slogdet(V)
        trace = jnp.trace(jnp.linalg.solve(V, X))
        lp = ((nu - p - 1.0) / 2.0 * logdet_x
              - 0.5 * trace
              - nu * p / 2.0 * jnp.log(2.0)
              - nu / 2.0 * logdet_v
              - multigammaln(nu / 2.0, p))
        return bound(lp, sign_x > 0, nu > p - 1,
                     broadcast_conditions=False)

    def random(self, point=None, size=None):
        nu, V = draw_values([self.nu, self.V], point=point, size=size)
        V = np.asarray(V)
        p = V.shape[-1]
        size_t = to_tuple(size) if size is not None else ()
        # scipy's wishart size is the batch count; the (p, p) event shape is
        # implicit — flatten the batch, then restore (size + (p, p))
        n_batch = int(np.prod(size_t, dtype=int)) if size_t else 1
        out = st.wishart.rvs(int(np.asarray(nu)), V, size=n_batch)
        return np.asarray(out).reshape(size_t + (p, p))


def WishartBartlett(name, S, nu, is_cholesky=False, return_cholesky=False,
                    testval=None, model=None):
    """Bartlett-decomposed Wishart prior (cf. ``multivariate.py:873``):
    diagonal chi-squared and off-diagonal normal free RVs composed into a
    Wishart draw, which *is* MCMC-safe."""
    from ..model import modelcontext, Deterministic
    from ..math import expand_packed_triangular

    model = modelcontext(model)
    S = np.asarray(S)
    nu_val = int(np.asarray(nu))
    n = S.shape[0]
    L = np.linalg.cholesky(S) if not is_cholesky else S

    diag_testval = None
    tril_testval = None
    if testval is not None:
        diag_testval = np.sqrt(np.diagonal(testval))
        tril_testval = testval[np.tril_indices(n, -1)]

    c = ChiSquared("%s_c" % name,
                   nu=nu_val - np.arange(2, 2 + n) + 2,
                   shape=n, testval=diag_testval)
    z = Normal("%s_z" % name, 0.0, 1.0, shape=(n * (n - 1) // 2,),
               testval=tril_testval)
    rows, cols = np.tril_indices(n, -1)

    def _assemble(c, z):
        A = jnp.zeros((n, n), dtype=c.dtype)
        A = A.at[jnp.arange(n), jnp.arange(n)].set(jnp.sqrt(c))
        A = A.at[rows, cols].set(z)
        LA = jnp.asarray(L, dtype=c.dtype) @ A
        return LA if return_cholesky else LA @ LA.T

    node = apply(_assemble, c, z)
    return Deterministic(name, node, model=model)


def _lkj_normalizing_constant(eta, n):
    """log c_n(eta) of the normalized LKJ density
    p(R) = c_n(eta) * det(R)^(eta-1), host-side (eta and n are static).

    The closed-form expression below (cf. ``multivariate.py:985``) computes
    log Z = log \\int det(R)^(eta-1) dR, i.e. -log c; the reference *adds*
    that to logp, leaving its LKJ densities off by 2*log Z — invisible to
    MCMC (eta, n are fixed hyperparameters) but wrong for exact densities
    and SMC evidence.  We return -log Z so call sites add a genuinely
    normalizing constant; verified against the n=2 Beta(eta, eta) identity,
    the n=3 elliptope volume pi^2/2, and numerical integration of the n=2
    LKJCholeskyCov density (tests/test_multivariate_matrix.py)."""
    from scipy.special import gammaln as sgammaln
    eta = float(eta)
    n = int(n)
    if eta == 1:
        log_z = float(np.sum(sgammaln(2.0 * np.arange(1, (n - 1) // 2 + 1))))
        if n % 2 == 1:
            log_z += (0.25 * (n ** 2 - 1) * np.log(np.pi)
                      - 0.25 * (n - 1) ** 2 * np.log(2.0)
                      - (n - 1) * sgammaln((n + 1) / 2))
        else:
            log_z += (0.25 * n * (n - 2) * np.log(np.pi)
                      + 0.25 * (3 * n ** 2 - 4 * n) * np.log(2.0)
                      + n * sgammaln(n / 2) - (n - 1) * sgammaln(n))
    else:
        log_z = -(n - 1) * sgammaln(eta + 0.5 * (n - 1))
        k = np.arange(1, n)
        log_z += float(np.sum(0.5 * k * np.log(np.pi)
                              + sgammaln(eta + 0.5 * (n - 1 - k))))
    return -log_z


class LKJCholeskyCov(Continuous):
    r"""Packed cholesky of a covariance with LKJ correlation prior and
    user-specified prior on the standard deviations
    (cf. ``_LKJCholeskyCov``, ``multivariate.py:1004``).

    The free variable is the packed lower-triangular cholesky L of the
    covariance (row-major, length n(n+1)/2), with log-transformed diagonal.
    """

    def __init__(self, eta, n, sd_dist, *args, **kwargs):
        self.n = int(n)
        self.eta = float(eta)
        if not isinstance(sd_dist, Distribution):
            raise TypeError("sd_dist must be a Distribution instance "
                            "(use .dist())")
        self.sd_dist = sd_dist
        self.diag_idxs = np.arange(1, self.n + 1).cumsum() - 1
        kwargs["shape"] = (self.n * (self.n + 1) // 2,)
        kwargs.setdefault("transform",
                          transforms.CholeskyCovPacked(self.n))
        super().__init__(*args, **kwargs)
        # testval: identity cholesky
        tv = np.zeros(self.n * (self.n + 1) // 2, dtype=floatX())
        tv[self.diag_idxs] = 1.0
        self.testval = tv
        self._norm_const = _lkj_normalizing_constant(self.eta, self.n)

    def logp(self, value, env=None, memo=None):
        env, memo = _norm(env, memo)
        x = jnp.asarray(value)
        n = self.n
        eta = self.eta
        diag_idxs = self.diag_idxs
        cumsum = jnp.cumsum(x ** 2, axis=-1)
        # variance_i = sum of squares of row i of L
        var = jnp.concatenate(
            [cumsum[..., diag_idxs[:1]],
             cumsum[..., diag_idxs[1:]] - cumsum[..., diag_idxs[:-1]]],
            axis=-1)
        sd_vals = jnp.sqrt(var)
        logp_sd = jnp.sum(self.sd_dist.logp(sd_vals, env, memo))
        corr_diag = x[..., diag_idxs] / sd_vals
        # LKJ cholesky density exponents per row
        idx = jnp.arange(n, dtype=x.dtype)
        logp_lkj = jnp.sum((2.0 * eta - 3.0 + n - idx)
                           * jnp.log(corr_diag))
        # log|J| of (sd, corr-chol) -> cov-chol
        det_invjac = jnp.sum(jnp.log(corr_diag) - idx * jnp.log(sd_vals))
        return self._norm_const + logp_lkj + logp_sd + det_invjac

    def random(self, point=None, size=None):
        # sample correlation cholesky via the cvine method, scale by sds
        n = self.n

        def _one():
            eta = self.eta
            beta0 = eta - 1.0 + n / 2.0
            r12 = 2.0 * st.beta.rvs(beta0, beta0) - 1.0
            P = np.eye(n)
            P[0, 1] = r12
            P[1, 1] = np.sqrt(1.0 - r12 ** 2)
            for mp1 in range(2, n):
                beta0 -= 0.5
                y = st.beta.rvs(mp1 / 2.0, beta0)
                u = np.random.normal(size=mp1)
                u /= np.linalg.norm(u)
                w = np.sqrt(y) * u
                P[:mp1, mp1] = w
                P[mp1, mp1] = np.sqrt(1.0 - y)
            C = P.T  # lower cholesky of correlation
            sds = np.atleast_1d(np.asarray(self.sd_dist.random(size=n)))
            sds = sds.reshape(-1)[:n]
            L = sds[:, None] * C
            return L[np.tril_indices(n)]

        if size is None:
            return _one()
        size_t = (size,) if isinstance(size, int) else tuple(size)
        flat = [_one() for _ in range(int(np.prod(size_t)))]
        return np.asarray(flat).reshape(size_t + (n * (n + 1) // 2,))


class LKJCorr(Continuous):
    r"""LKJ prior over correlation matrices, stored as the flattened strict
    upper triangle (cf. ``multivariate.py:1282``)."""

    def __init__(self, eta=None, n=None, p=None, transform="interval",
                 *args, **kwargs):
        if (p is not None) and (n is not None) and (eta is None):
            eta, n = n, p  # legacy (n, p) argument order
        self.n = int(n)
        self.eta = float(eta)
        n_elem = self.n * (self.n - 1) // 2
        self.mean = as_node(floatX(np.zeros(n_elem)))
        self.tri_index = np.zeros((self.n, self.n), dtype=int)
        self.tri_index[np.triu_indices(self.n, k=1)] = np.arange(n_elem)
        self.tri_index[np.triu_indices(self.n, k=1)[::-1]] = np.arange(n_elem)
        kwargs["shape"] = (n_elem,)
        if transform == "interval":
            transform = transforms.interval(-1.0, 1.0)
        kwargs.setdefault("transform", transform)
        super().__init__(defaults=("mean",), *args, **kwargs)
        self._norm_const = _lkj_normalizing_constant(self.eta, self.n)

    def _to_matrix(self, x):
        X = x[..., self.tri_index]
        eye = jnp.eye(self.n, dtype=x.dtype)
        return X * (1.0 - eye) + eye

    def logp(self, value, env=None, memo=None):
        env, memo = _norm(env, memo)
        X = self._to_matrix(jnp.asarray(value))
        eigs = jnp.linalg.eigvalsh(X)
        ok = jnp.all(eigs > 0)
        safe = jnp.where(ok, X, jnp.eye(self.n, dtype=X.dtype))
        _, logdet = jnp.linalg.slogdet(safe)
        lp = self._norm_const + (self.eta - 1.0) * logdet
        return bound(lp, ok, jnp.all(jnp.abs(value) <= 1),
                     broadcast_conditions=False)

    def random(self, point=None, size=None):
        n = self.n

        def _one():
            eta = self.eta
            beta0 = eta - 1.0 + n / 2.0
            r12 = 2.0 * st.beta.rvs(beta0, beta0) - 1.0
            P = np.eye(n)
            P[0, 1] = r12
            P[1, 1] = np.sqrt(1.0 - r12 ** 2)
            for mp1 in range(2, n):
                beta0 -= 0.5
                y = st.beta.rvs(mp1 / 2.0, beta0)
                u = np.random.normal(size=mp1)
                u /= np.linalg.norm(u)
                P[:mp1, mp1] = np.sqrt(y) * u
                P[mp1, mp1] = np.sqrt(1.0 - y)
            C = P.T @ P
            return C[np.triu_indices(n, k=1)]

        if size is None:
            return _one()
        size_t = (size,) if isinstance(size, int) else tuple(size)
        flat = [_one() for _ in range(int(np.prod(size_t)))]
        return np.asarray(flat).reshape(size_t + (n * (n - 1) // 2,))


class MatrixNormal(Continuous):
    r"""Matrix-variate normal with Kronecker-structured covariance
    (cf. ``multivariate.py:1428``)."""

    def __init__(self, mu=0, rowcov=None, rowchol=None, rowtau=None,
                 colcov=None, colchol=None, coltau=None, shape=None,
                 *args, **kwargs):
        self.mu = _an(mu)
        self._row = self._setup_side(rowcov, rowchol, rowtau, "row")
        self._col = self._setup_side(colcov, colchol, coltau, "col")
        if shape is None:
            shape = np.shape(self.mu.test_value)
        kwargs["shape"] = shape
        self.m, self.n_ = int(shape[-2]), int(shape[-1])
        super().__init__(*args, **kwargs)
        self.mean = self.median = self.mode = self.mu

    @staticmethod
    def _setup_side(cov, chol, tau, label):
        given = [i for i in (cov, chol, tau) if i is not None]
        if len(given) != 1:
            raise ValueError(
                f"Specify exactly one of {label}cov, {label}chol, {label}tau.")
        if cov is not None:
            return ("cov", _an(cov))
        if chol is not None:
            return ("chol", _an(chol))
        return ("tau", _an(tau))

    @staticmethod
    def _side_chol(spec, env, memo):
        kind, node = spec
        val = evaluate(node, env, memo)
        if kind == "chol":
            return val
        if kind == "cov":
            return jsl.cholesky(val, lower=True)
        k = val.shape[-1]
        chol_tau = jsl.cholesky(val, lower=True)
        inv = jsl.solve_triangular(chol_tau, jnp.eye(k, dtype=val.dtype),
                                   lower=True)
        return jsl.cholesky(inv.T @ inv, lower=True)

    def logp(self, value, env=None, memo=None):
        env, memo = _norm(env, memo)
        mu = evaluate(self.mu, env, memo)
        chol_r = self._side_chol(self._row, env, memo)
        chol_c = self._side_chol(self._col, env, memo)
        delta = jnp.asarray(value) - mu
        # solve U^-1 delta V^-T via triangular solves
        a = jsl.solve_triangular(chol_r, delta, lower=True)
        b = jsl.solve_triangular(chol_c, a.T, lower=True)
        quad = jnp.sum(b ** 2)
        logdet_r = jnp.sum(jnp.log(jnp.diagonal(chol_r)))
        logdet_c = jnp.sum(jnp.log(jnp.diagonal(chol_c)))
        m, n = self.m, self.n_
        return (-0.5 * m * n * jnp.log(2.0 * np.pi) - n * logdet_r
                - m * logdet_c - 0.5 * quad)

    def random(self, point=None, size=None):
        mu, = draw_values([self.mu], point=point, size=size)
        env = dict(point or {})
        chol_r = np.asarray(self._side_chol(self._row, env, {}))
        chol_c = np.asarray(self._side_chol(self._col, env, {}))
        size_t = () if size is None else (
            (size,) if isinstance(size, int) else tuple(size))
        z = np.random.standard_normal(size_t + (self.m, self.n_))
        samp = np.asarray(mu) + chol_r @ z @ chol_c.T
        return samp


class KroneckerNormal(Continuous):
    r"""MvNormal with covariance kron(K_1, ..., K_D) + sigma^2 I
    (cf. ``multivariate.py:1677``). Uses per-factor eigendecompositions so the
    full Kronecker product is never materialized."""

    def __init__(self, mu, covs=None, chols=None, evds=None, sigma=None,
                 *args, **kwargs):
        self.mu = _an(mu)
        if covs is not None:
            self.covs = [_an(c) for c in covs]
        elif chols is not None:
            self.covs = [apply(lambda L: L @ jnp.swapaxes(L, -1, -2), _an(L))
                         for L in chols]
        elif evds is not None:
            raise NotImplementedError("pass covs or chols")
        else:
            raise ValueError("Specify covs or chols")
        self.sigma = None if sigma is None else _an(sigma)
        self.sizes = [int(np.shape(c.test_value)[-1]) for c in self.covs]
        self.N = int(np.prod(self.sizes))
        if kwargs.get("shape") is None:
            kwargs["shape"] = (self.N,)
        super().__init__(*args, **kwargs)
        self.mean = self.median = self.mode = self.mu

    def logp(self, value, env=None, memo=None):
        env, memo = _norm(env, memo)
        mu = evaluate(self.mu, env, memo)
        covs = [evaluate(c, env, memo) for c in self.covs]
        delta = jnp.asarray(value) - mu
        eigs = []
        QTs = []
        for C in covs:
            w, Q = jnp.linalg.eigh(C)
            eigs.append(w)
            QTs.append(Q.T)
        # eigenvalues of the kron product
        lam = eigs[0]
        for w in eigs[1:]:
            lam = (lam[:, None] * w[None, :]).ravel()
        if self.sigma is not None:
            sigma = evaluate(self.sigma, env, memo)
            lam = lam + sigma ** 2
        # rotate delta by kron(Q_i^T) without materializing the product
        d = delta if delta.ndim > 1 else delta[None, :]
        rotated = _kron_rotate(QTs, d)
        quad = jnp.sum(rotated ** 2 / lam, axis=-1)
        logdet = jnp.sum(jnp.log(lam))
        out = -0.5 * (self.N * jnp.log(2.0 * np.pi) + logdet + quad)
        return out[0] if delta.ndim == 1 else out

    def random(self, point=None, size=None):
        mu, = draw_values([self.mu], point=point, size=size)
        covs = [np.asarray(evaluate(c, dict(point or {}), {}))
                for c in self.covs]
        K = covs[0]
        for C in covs[1:]:
            K = np.kron(K, C)
        if self.sigma is not None:
            sigma = np.asarray(evaluate(self.sigma, dict(point or {}), {}))
            K = K + sigma ** 2 * np.eye(K.shape[0])
        return generate_samples(
            lambda mu, size: np.random.multivariate_normal(
                np.broadcast_to(mu, (self.N,)), K,
                size=size[:-1] if size else None),
            mu, dist_shape=self.shape, size=size,
            broadcast_shape=(self.N,))


def _kron_rotate(QTs, x):
    """Apply kron(Q_1^T, ..., Q_D^T) to rows of x (batch, N)."""
    batch, n = x.shape
    res = x
    for QT in QTs:
        kn = QT.shape[0]
        r = res.reshape(batch, kn, n // kn)
        r = jnp.einsum("ij,bjk->bik", QT, r)
        res = jnp.moveaxis(r, 1, 2).reshape(batch, n)
    return res
