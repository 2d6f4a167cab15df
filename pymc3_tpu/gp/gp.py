"""Gaussian process implementations (cf. ``pymc3/gp/gp.py``).

``Latent`` (``gp.py:65``), ``Marginal`` (``gp.py:344``), ``TP`` (``gp.py:226``),
``MarginalSparse`` (``gp.py:572``, FITC/VFE/DTC), ``LatentKron``
(``gp.py:813``), ``MarginalKron`` (``gp.py:965``). All conditional algebra is
symbolic node math lowering to XLA ``cholesky``/``triangular_solve``
(replacing the reference's Theano ``cholesky``/``solve_lower`` graphs at
``gp.py:459``).
"""
from __future__ import annotations

import functools
import warnings

import numpy as np
import jax.numpy as jnp

from ..config import floatX
from ..node import Node, apply as node_apply, as_node
from .cov import Constant, Covariance
from .mean import Zero
from .util import (
    cholesky, conditioned_vars, infer_shape, solve_lower, solve_upper,
    stabilize, _default_jitter as _jitter,
)

__all__ = ["Latent", "Marginal", "TP", "MarginalSparse", "LatentKron",
           "MarginalKron"]


class Base:
    """Base class for GP objects (cf. ``gp.py:34``)."""

    def __init__(self, mean_func=None, cov_func=None):
        self.mean_func = mean_func if mean_func is not None else Zero()
        self.cov_func = cov_func if cov_func is not None else Constant(0.0)

    def __add__(self, other):
        same_attrs = set(self.__dict__.keys()) == set(other.__dict__.keys())
        if not isinstance(self, type(other)) or not same_attrs:
            raise TypeError("Cannot add different GP types")
        mean_total = self.mean_func + other.mean_func
        cov_total = self.cov_func + other.cov_func
        return self.__class__(mean_total, cov_total)

    def prior(self, name, X, *args, **kwargs):
        raise NotImplementedError

    def marginal_likelihood(self, name, X, *args, **kwargs):
        raise NotImplementedError

    def conditional(self, name, Xnew, *args, **kwargs):
        raise NotImplementedError

    def predict(self, Xnew, point=None, given=None, diag=False):
        raise NotImplementedError


@conditioned_vars(["X", "f"])
class Latent(Base):
    r"""Latent (non-conjugate) GP (cf. ``gp.py:65``): ``prior`` places a
    rotated-whitened MvNormal over f, ``conditional`` extends to new
    inputs."""

    def __init__(self, mean_func=None, cov_func=None):
        super().__init__(mean_func, cov_func)

    def _build_prior(self, name, X, reparameterize=True, **kwargs):
        from .. import distributions as dist
        from ..model import Deterministic
        X = as_node(X)
        mu = self.mean_func(X)
        cov = stabilize(self.cov_func(X))
        shape = infer_shape(X, kwargs.pop("shape", None))
        if reparameterize:
            v = dist.Normal(name + "_rotated_", mu=0.0, sigma=1.0,
                            shape=shape, **kwargs)
            f = Deterministic(name, mu + node_apply(
                lambda m_chol, v_: m_chol @ v_, cholesky(cov), v))
        else:
            f = dist.MvNormal(name, mu=mu, cov=cov, shape=shape, **kwargs)
        return f

    def prior(self, name, X, reparameterize=True, **kwargs):
        f = self._build_prior(name, X, reparameterize, **kwargs)
        self.X = as_node(X)
        self.f = f
        return f

    def _get_given_vals(self, given):
        if given is None:
            given = {}
        if "gp" in given:
            cov_total = given["gp"].cov_func
            mean_total = given["gp"].mean_func
        else:
            cov_total = self.cov_func
            mean_total = self.mean_func
        if all(val in given for val in ["X", "f"]):
            X, f = as_node(given["X"]), given["f"]
        else:
            X, f = self.X, self.f
        return X, f, cov_total, mean_total

    def _build_conditional(self, Xnew, X, f, cov_total, mean_total):
        Kxx = cov_total(X)
        Kxs = self.cov_func(X, Xnew)
        L = cholesky(stabilize(Kxx))
        A = solve_lower(L, Kxs)
        v = solve_lower(L, f - mean_total(X))
        mu = self.mean_func(Xnew) + node_apply(
            lambda A_, v_: A_.T @ v_, A, v)
        Kss = self.cov_func(Xnew)
        cov = node_apply(lambda Kss_, A_: Kss_ - A_.T @ A_, Kss, A)
        return mu, cov

    def conditional(self, name, Xnew, given=None, **kwargs):
        from .. import distributions as dist
        givens = self._get_given_vals(given)
        mu, cov = self._build_conditional(as_node(Xnew), *givens)
        shape = infer_shape(Xnew, kwargs.pop("shape", None))
        return dist.MvNormal(name, mu=mu, cov=stabilize(cov), shape=shape,
                             **kwargs)


@conditioned_vars(["X", "f", "nu"])
class TP(Latent):
    r"""Student-T process (cf. ``gp.py:226``)."""

    def __init__(self, mean_func=None, cov_func=None, nu=None):
        if nu is None:
            raise ValueError("Student's T process requires a degrees of "
                             "freedom parameter, 'nu'")
        self.nu = nu
        super().__init__(mean_func, cov_func)

    def __add__(self, other):
        raise TypeError("Student's T processes aren't additive")

    def _build_prior(self, name, X, reparameterize=True, **kwargs):
        from .. import distributions as dist
        from ..model import Deterministic
        X = as_node(X)
        mu = self.mean_func(X)
        cov = stabilize(self.cov_func(X))
        shape = infer_shape(X, kwargs.pop("shape", None))
        if reparameterize:
            chi2 = dist.ChiSquared(name + "_chi2_", self.nu)
            v = dist.Normal(name + "_rotated_", mu=0.0, sigma=1.0,
                            shape=shape, **kwargs)
            f = Deterministic(name, mu + node_apply(
                lambda nu_, chi2_, m_chol, v_:
                (jnp.sqrt(nu_) / jnp.sqrt(chi2_)) * (m_chol @ v_),
                self.nu, chi2, cholesky(cov), v))
        else:
            f = dist.MvStudentT(name, nu=self.nu, mu=mu, cov=cov,
                                shape=shape, **kwargs)
        return f

    def prior(self, name, X, reparameterize=True, **kwargs):
        f = self._build_prior(name, X, reparameterize, **kwargs)
        self.X = as_node(X)
        self.f = f
        return f

    def _build_conditional(self, Xnew, X, f):
        Kxx = self.cov_func(X)
        Kxs = self.cov_func(X, Xnew)
        Kss = self.cov_func(Xnew)
        L = cholesky(stabilize(Kxx))
        A = solve_lower(L, Kxs)
        cov = node_apply(lambda Kss_, A_: Kss_ - A_.T @ A_, Kss, A)
        v = solve_lower(L, f - self.mean_func(X))
        mu = self.mean_func(Xnew) + node_apply(
            lambda A_, v_: A_.T @ v_, A, v)
        beta = node_apply(lambda v_: v_ @ v_, v)
        nu2 = node_apply(
            lambda nu_, b_, X_: nu_ + jnp.shape(X_)[0],
            self.nu, beta, X)
        covT = node_apply(
            lambda nu_, b_, X_, cov_:
            (nu_ + b_ - 2) / (nu_ + jnp.shape(X_)[0] - 2) * cov_,
            self.nu, beta, X, cov)
        return nu2, mu, covT

    def conditional(self, name, Xnew, **kwargs):
        from .. import distributions as dist
        X = self.X
        f = self.f
        nu2, mu, cov = self._build_conditional(as_node(Xnew), X, f)
        shape = infer_shape(Xnew, kwargs.pop("shape", None))
        return dist.MvStudentT(name, nu=nu2, mu=mu, cov=stabilize(cov),
                               shape=shape, **kwargs)


@conditioned_vars(["X", "y", "noise"])
class Marginal(Base):
    r"""Conjugate marginal GP regression (cf. ``gp.py:344``)."""

    def _build_marginal_likelihood(self, X, noise):
        mu = self.mean_func(X)
        Kxx = self.cov_func(X)
        Knx = noise(X)
        cov = Kxx + Knx
        return mu, cov

    def marginal_likelihood(self, name, X, y, noise, is_observed=True,
                            **kwargs):
        """Observed MvNormal with K(X)+Σ_noise (cf. ``gp.py:396``)."""
        from .. import distributions as dist
        X = as_node(X)
        if not isinstance(noise, Covariance):
            from .cov import WhiteNoise
            noise = WhiteNoise(noise)
        mu, cov = self._build_marginal_likelihood(X, noise)
        self.X = X
        self.y = as_node(y) if not isinstance(y, Node) else y
        self.noise = noise
        if is_observed:
            return dist.MvNormal(name, mu=mu, cov=cov, observed=y, **kwargs)
        else:
            shape = infer_shape(X, kwargs.pop("shape", None))
            return dist.MvNormal(name, mu=mu, cov=cov, shape=shape, **kwargs)

    def _get_given_vals(self, given):
        if given is None:
            given = {}
        if "gp" in given:
            cov_total = given["gp"].cov_func
            mean_total = given["gp"].mean_func
        else:
            cov_total = self.cov_func
            mean_total = self.mean_func
        if all(val in given for val in ["X", "y", "noise"]):
            X, y, noise = as_node(given["X"]), given["y"], given["noise"]
            if not isinstance(noise, Covariance):
                from .cov import WhiteNoise
                noise = WhiteNoise(noise)
        else:
            X, y, noise = self.X, self.y, self.noise
        return X, y, noise, cov_total, mean_total

    def _build_conditional(self, Xnew, pred_noise, diag, X, y, noise,
                           cov_total, mean_total):
        """cf. ``gp.py:459`` — the conditional math."""
        Kxx = cov_total(X)
        Kxs = self.cov_func(X, Xnew)
        Knx = noise(X)
        rxx = y - mean_total(X)
        L = cholesky(stabilize(Kxx) + Knx)
        A = solve_lower(L, Kxs)
        v = solve_lower(L, rxx)
        mu = self.mean_func(Xnew) + node_apply(
            lambda A_, v_: A_.T @ v_, A, v)
        if diag:
            Kss = self.cov_func(Xnew, diag=True)
            var = node_apply(
                lambda Kss_, A_: Kss_ - jnp.sum(A_ ** 2, axis=0), Kss, A)
            if pred_noise:
                var = var + noise(Xnew, diag=True)
            return mu, var
        Kss = self.cov_func(Xnew)
        cov = node_apply(lambda Kss_, A_: Kss_ - A_.T @ A_, Kss, A)
        if pred_noise:
            cov = cov + noise(Xnew)
        return mu, cov if pred_noise else stabilize(cov)

    def conditional(self, name, Xnew, pred_noise=False, given=None,
                    **kwargs):
        givens = self._get_given_vals(given)
        mu, cov = self._build_conditional(as_node(Xnew), pred_noise, False,
                                          *givens)
        from .. import distributions as dist
        shape = infer_shape(Xnew, kwargs.pop("shape", None))
        return dist.MvNormal(name, mu=mu, cov=cov, shape=shape, **kwargs)

    def predict(self, Xnew, point=None, diag=False, pred_noise=False,
                given=None):
        """Numpy predictive mean/variance at a Point (cf. ``gp.py:506``)."""
        if given is None:
            given = {}
        mu, cov = self.predictt(Xnew, diag, pred_noise, given)
        from ..model import modelcontext
        model = modelcontext(None)
        fn = model.makefn([mu, cov])
        m, c = fn(point if point is not None else model.test_point)
        return np.asarray(m), np.asarray(c)

    def predictt(self, Xnew, diag=False, pred_noise=False, given=None):
        """Symbolic predictive mean/variance (cf. ``gp.py:545``)."""
        givens = self._get_given_vals(given)
        mu, cov = self._build_conditional(as_node(Xnew), pred_noise, diag,
                                          *givens)
        return mu, cov


@conditioned_vars(["X", "Xu", "y", "sigma"])
class MarginalSparse(Marginal):
    r"""Sparse approximate marginal GP (cf. ``gp.py:572``):
    FITC / VFE / DTC inducing-point approximations."""

    _available_approx = ("FITC", "VFE", "DTC")

    def __init__(self, mean_func=None, cov_func=None, approx="FITC"):
        if approx not in self._available_approx:
            raise NotImplementedError(approx)
        self.approx = approx
        super().__init__(mean_func, cov_func)

    def __add__(self, other):
        new_gp = super().__add__(other)
        if not self.approx == other.approx:
            raise TypeError("Cannot add GPs with different approximations")
        new_gp.approx = self.approx
        return new_gp

    def _build_marginal_logp(self, X, Xu, y, sigma):
        """Approximate log-marginal-likelihood node
        (cf. ``gp.py:633-680``)."""
        approx = self.approx
        mean_func = self.mean_func
        cov_func = self.cov_func

        def logp(X_, Xu_, y_, sigma_, mu_):
            X_ = jnp.asarray(X_, floatX())
            Xu_ = jnp.asarray(Xu_, floatX())
            y_ = jnp.asarray(y_, floatX())
            sigma2 = sigma_ ** 2
            Kuu = jnp.asarray(_eval_cov(cov_func, Xu_), floatX())
            Kuf = jnp.asarray(_eval_cov(cov_func, Xu_, X_), floatX())
            Luu = jnp.linalg.cholesky(
                Kuu + _jitter() * jnp.eye(Kuu.shape[0], dtype=floatX()))
            import jax.scipy.linalg as jsl
            A = jsl.solve_triangular(Luu, Kuf, lower=True)
            Qffd = jnp.sum(A * A, axis=0)
            if approx == "FITC":
                Kffd = _eval_cov_diag(cov_func, X_)
                Lamd = jnp.clip(Kffd - Qffd, 0, jnp.inf) + sigma2
                trace = 0.0
            elif approx == "VFE":
                Lamd = jnp.ones_like(Qffd) * sigma2
                Kffd = _eval_cov_diag(cov_func, X_)
                trace = (-0.5 / sigma2) * \
                    (jnp.sum(Kffd) - jnp.sum(Qffd))
            else:  # DTC
                Lamd = jnp.ones_like(Qffd) * sigma2
                trace = 0.0
            A_l = A / Lamd
            L_B = jnp.linalg.cholesky(
                jnp.eye(Xu_.shape[0], dtype=floatX()) + A_l @ A.T)
            r = y_ - mu_
            r_l = r / Lamd
            c = jsl.solve_triangular(L_B, A @ r_l, lower=True)
            n = X_.shape[0]
            constant = 0.5 * n * jnp.log(2.0 * jnp.pi)
            logdet = 0.5 * jnp.sum(jnp.log(Lamd)) + \
                jnp.sum(jnp.log(jnp.diag(L_B)))
            quadratic = 0.5 * (jnp.dot(r, r_l) - jnp.dot(c, c))
            return -1.0 * (constant + logdet + quadratic) + trace
        return node_apply(logp, X, Xu, y, sigma, mean_func(X))

    def marginal_likelihood(self, name, X, Xu, y, noise=None, sigma=None,
                            is_observed=True, **kwargs):
        """cf. ``gp.py:682``."""
        from ..model import Potential
        if sigma is None and noise is None:
            raise ValueError("Must provide a value or prior for the noise "
                             "standard deviation")
        if sigma is None:
            sigma = noise
        self.X = as_node(X)
        self.Xu = as_node(Xu)
        self.y = as_node(y) if not isinstance(y, Node) else y
        self.sigma = sigma
        logp_node = self._build_marginal_logp(self.X, self.Xu, self.y, sigma)
        return Potential(name, logp_node)

    def _build_conditional(self, Xnew, pred_noise, diag, X, Xu, y, sigma,
                           cov_total, mean_total):
        """cf. ``gp.py:720``."""
        approx = self.approx
        cov_func = self.cov_func
        mean_func = self.mean_func

        def cond(X_, Xu_, y_, sigma_, mu_, ms_, Xs_):
            import jax.scipy.linalg as jsl
            X_ = jnp.asarray(X_, floatX())
            Xu_ = jnp.asarray(Xu_, floatX())
            Xs_ = jnp.asarray(Xs_, floatX())
            y_ = jnp.asarray(y_, floatX())
            sigma2 = sigma_ ** 2
            Kuu = _eval_cov(cov_func, Xu_)
            Kuf = _eval_cov(cov_func, Xu_, X_)
            Luu = jnp.linalg.cholesky(
                Kuu + _jitter() * jnp.eye(Kuu.shape[0], dtype=floatX()))
            A = jsl.solve_triangular(Luu, Kuf, lower=True)
            Qffd = jnp.sum(A * A, axis=0)
            if approx == "FITC":
                Kffd = _eval_cov_diag(cov_func, X_)
                Lamd = jnp.clip(Kffd - Qffd, 0, jnp.inf) + sigma2
            else:
                Lamd = jnp.ones_like(Qffd) * sigma2
            A_l = A / Lamd
            L_B = jnp.linalg.cholesky(
                jnp.eye(Xu_.shape[0], dtype=floatX()) + A_l @ A.T)
            r = y_ - mu_
            r_l = r / Lamd
            c = jsl.solve_triangular(L_B, A @ r_l, lower=True)
            Kus = _eval_cov(cov_func, Xu_, Xs_)
            As = jsl.solve_triangular(Luu, Kus, lower=True)
            # conditional mean includes the mean function at Xnew
            # (cf. ``gp.py:746``) — r was centered by mu_ above
            mus = jnp.asarray(ms_, floatX()) + \
                As.T @ jsl.solve_triangular(L_B.T, c, lower=False)
            C = jsl.solve_triangular(L_B, As, lower=True)
            if diag:
                Kss = _eval_cov_diag(cov_func, Xs_)
                var = Kss - jnp.sum(As ** 2, axis=0) + jnp.sum(C ** 2,
                                                               axis=0)
                if pred_noise:
                    var = var + sigma2
                return mus, var
            Kss = _eval_cov(cov_func, Xs_)
            cov_ = Kss - As.T @ As + C.T @ C
            if pred_noise:
                cov_ = cov_ + sigma2 * jnp.eye(cov_.shape[0], dtype=floatX())
            return mus, cov_

        mu_node = mean_total(X)
        ms_node = mean_total(Xnew)
        out = node_apply(
            lambda X_, Xu_, y_, s_, m_, ms_, Xs_:
            cond(X_, Xu_, y_, s_, m_, ms_, Xs_),
            X, Xu, y, sigma, mu_node, ms_node, Xnew)
        # split the tuple node into mean/cov nodes
        mu = node_apply(lambda t: t[0], out)
        cov = node_apply(lambda t: t[1], out)
        return mu, cov

    def _get_given_vals(self, given):
        if given is None:
            given = {}
        if "gp" in given:
            cov_total = given["gp"].cov_func
            mean_total = given["gp"].mean_func
        else:
            cov_total = self.cov_func
            mean_total = self.mean_func
        if all(val in given for val in ["X", "Xu", "y", "sigma"]):
            X, Xu = as_node(given["X"]), as_node(given["Xu"])
            y, sigma = given["y"], given["sigma"]
        else:
            X, Xu, y, sigma = self.X, self.Xu, self.y, self.sigma
        return X, Xu, y, sigma, cov_total, mean_total

    def conditional(self, name, Xnew, pred_noise=False, given=None,
                    **kwargs):
        from .. import distributions as dist
        givens = self._get_given_vals(given)
        mu, cov = self._build_conditional(as_node(Xnew), pred_noise, False,
                                          *givens)
        shape = infer_shape(Xnew, kwargs.pop("shape", None))
        return dist.MvNormal(name, mu=mu, cov=stabilize(cov), shape=shape,
                             **kwargs)


def _eval_cov(cov_func, X, Xs=None):
    out = cov_func(X) if Xs is None else cov_func(X, Xs)
    if isinstance(out, Node):
        from ..node import evaluate
        return evaluate(out, {})
    return out


def _eval_cov_diag(cov_func, X):
    out = cov_func(X, diag=True)
    if isinstance(out, Node):
        from ..node import evaluate
        return evaluate(out, {})
    return out


@conditioned_vars(["Xs", "f"])
class LatentKron(Base):
    r"""Latent GP on a Cartesian-product grid with Kronecker-structured
    covariance (cf. ``gp.py:813``)."""

    def __init__(self, mean_func=None, cov_funcs=(Constant(0.0),)):
        try:
            self.cov_funcs = list(cov_funcs)
        except TypeError:
            self.cov_funcs = [cov_funcs]
        from .cov import Kron
        cov_func = Kron(self.cov_funcs)
        super().__init__(mean_func, cov_func)

    def __add__(self, other):
        raise TypeError("Additive, Kronecker-structured processes not "
                        "implemented")

    def _build_prior(self, name, Xs, **kwargs):
        from .. import distributions as dist
        from ..model import Deterministic
        self.N = int(np.prod([np.shape(np.asarray(
            X if not isinstance(X, Node) else X.test_value))[0]
            for X in Xs]))
        mu = self.mean_func(_cartesian(Xs))
        chols = [cholesky(stabilize(f(as_node(X))))
                 for f, X in zip(self.cov_funcs, Xs)]
        v = dist.Normal(name + "_rotated_", mu=0.0, sigma=1.0,
                        shape=self.N, **kwargs)

        def kron_dot_vec(v_, *Ls):
            out = v_
            N = out.shape[0]
            for L in reversed(Ls):
                m = L.shape[0]
                out = out.reshape(-1, m) @ L.T
                out = out.T.reshape(-1)
            return out
        f = Deterministic(name, mu + node_apply(kron_dot_vec, v, *chols))
        return f

    def prior(self, name, Xs, **kwargs):
        """cf. ``gp.py:869``."""
        if len(Xs) != len(self.cov_funcs):
            raise ValueError("Must provide a covariance function for each X")
        f = self._build_prior(name, Xs, **kwargs)
        self.Xs = [as_node(X) for X in Xs]
        self.f = f
        return f

    def _build_conditional(self, Xnew):
        Xs, f = self.Xs, self.f
        X = _cartesian([x.test_value for x in Xs])
        delta = f - self.mean_func(as_node(X))
        covs = [stabilize(func(as_node(x.test_value)))
                for func, x in zip(self.cov_funcs, Xs)]

        def cond(delta_, ms_, Xnew_, *Ks):
            import jax.scipy.linalg as jsl
            K = Ks[0]
            for Kk in Ks[1:]:
                K = jnp.kron(K, Kk)
            L = jnp.linalg.cholesky(K)
            Kxs = _eval_cov(self.cov_func, X, np.asarray(Xnew_))
            A = jsl.solve_triangular(L, Kxs, lower=True)
            v_ = jsl.solve_triangular(L, delta_, lower=True)
            # conditional mean includes the mean function at Xnew
            # (cf. ``gp.py:930``) — delta was centered at the grid
            mu_ = jnp.asarray(ms_, floatX()) + A.T @ v_
            Kss = _eval_cov(self.cov_func, np.asarray(Xnew_))
            return mu_, Kss - A.T @ A
        out = node_apply(cond, delta, self.mean_func(as_node(Xnew)),
                         as_node(Xnew), *covs)
        mu = node_apply(lambda t: t[0], out)
        cov = node_apply(lambda t: t[1], out)
        return mu, cov

    def conditional(self, name, Xnew, **kwargs):
        """cf. ``gp.py:908``."""
        from .. import distributions as dist
        mu, cov = self._build_conditional(Xnew)
        shape = infer_shape(Xnew, kwargs.pop("shape", None))
        return dist.MvNormal(name, mu=mu, cov=stabilize(cov), shape=shape,
                             **kwargs)

    def conditional_mean_cov(self, Xnew):
        return self._build_conditional(Xnew)


@conditioned_vars(["Xs", "y", "sigma"])
class MarginalKron(Base):
    r"""Marginal GP on a Cartesian grid with Kronecker algebra
    (cf. ``gp.py:965``): eigendecomposition-based exact marginal."""

    def __init__(self, mean_func=None, cov_funcs=(Constant(0.0),)):
        try:
            self.cov_funcs = list(cov_funcs)
        except TypeError:
            self.cov_funcs = [cov_funcs]
        from .cov import Kron
        cov_func = Kron(self.cov_funcs)
        super().__init__(mean_func, cov_func)

    def __add__(self, other):
        raise TypeError("Additive, Kronecker-structured processes not "
                        "implemented")

    def _build_marginal_likelihood_logp(self, y, Xs, sigma):
        """Eigen-decomposed Kronecker marginal logp
        (cf. ``gp.py:1015-1064``)."""
        covs = [stabilize(f(as_node(X))) for f, X in zip(self.cov_funcs, Xs)]
        mu = self.mean_func(_cartesian(
            [x if not isinstance(x, Node) else x.test_value for x in Xs]))

        def logp(y_, sigma_, mu_, *Ks):
            eigs_sep, Qs = [], []
            for K in Ks:
                w, Q = jnp.linalg.eigh(K)
                eigs_sep.append(w)
                Qs.append(Q)
            eigs = eigs_sep[0]
            for w in eigs_sep[1:]:
                eigs = jnp.kron(eigs, w)
            sigma2 = sigma_ ** 2
            d = eigs + sigma2
            r = jnp.asarray(y_, floatX()) - mu_
            # alpha = QT r (kron mat-vec)
            out = r
            for Q in reversed(Qs):
                m = Q.shape[0]
                out = (out.reshape(-1, m) @ Q).T.reshape(-1)
            alpha = out
            N = r.shape[0]
            return -0.5 * (N * jnp.log(2 * jnp.pi) + jnp.sum(jnp.log(d)) +
                           jnp.sum(alpha ** 2 / d))
        return node_apply(logp, y, sigma, mu, *covs)

    def marginal_likelihood(self, name, Xs, y, sigma, is_observed=True,
                            **kwargs):
        """cf. ``gp.py:1067``."""
        from ..model import Potential
        self.Xs = [as_node(X) for X in Xs]
        self.y = as_node(y) if not isinstance(y, Node) else y
        self.sigma = sigma
        logp_node = self._build_marginal_likelihood_logp(self.y, Xs, sigma)
        return Potential(name, logp_node)

    def _build_conditional(self, Xnew, pred_noise, diag):
        Xs, y, sigma = self.Xs, self.y, self.sigma
        X = _cartesian([x.test_value for x in Xs])
        covs = [stabilize(f(as_node(x.test_value)))
                for f, x in zip(self.cov_funcs, Xs)]
        mu_node = self.mean_func(as_node(X))

        def cond(y_, sigma_, mu_, ms_, Xnew_, *Ks):
            import jax.scipy.linalg as jsl
            K = Ks[0]
            for Kk in Ks[1:]:
                K = jnp.kron(K, Kk)
            sigma2 = sigma_ ** 2
            Ky = K + sigma2 * jnp.eye(K.shape[0], dtype=floatX())
            L = jnp.linalg.cholesky(Ky)
            r = jnp.asarray(y_, floatX()) - mu_
            Kxs = _eval_cov(self.cov_func, X, np.asarray(Xnew_))
            A = jsl.solve_triangular(L, Kxs, lower=True)
            v_ = jsl.solve_triangular(L, r, lower=True)
            # conditional mean includes the mean function at Xnew
            # (cf. ``gp.py:1105``)
            mus = jnp.asarray(ms_, floatX()) + A.T @ v_
            Kss = _eval_cov(self.cov_func, np.asarray(Xnew_))
            cov_ = Kss - A.T @ A
            if pred_noise:
                cov_ = cov_ + sigma2 * jnp.eye(cov_.shape[0],
                                               dtype=floatX())
            return mus, cov_
        out = node_apply(cond, y, sigma, mu_node,
                         self.mean_func(as_node(Xnew)), as_node(Xnew),
                         *covs)
        mu = node_apply(lambda t: t[0], out)
        cov = node_apply(lambda t: t[1], out)
        return mu, cov

    def conditional(self, name, Xnew, pred_noise=False, **kwargs):
        from .. import distributions as dist
        mu, cov = self._build_conditional(Xnew, pred_noise, False)
        shape = infer_shape(Xnew, kwargs.pop("shape", None))
        return dist.MvNormal(name, mu=mu, cov=stabilize(cov), shape=shape,
                             **kwargs)

    def predict(self, Xnew, point=None, diag=False, pred_noise=False):
        mu, cov = self._build_conditional(Xnew, pred_noise, diag)
        from ..model import modelcontext
        model = modelcontext(None)
        fn = model.makefn([mu, cov])
        m, c = fn(point if point is not None else model.test_point)
        return np.asarray(m), np.asarray(c)


def _cartesian(Xs):
    """Cartesian product of grid vectors (cf. ``math.cartesian``)."""
    arrs = [np.atleast_2d(np.asarray(
        X if not isinstance(X, Node) else X.test_value)) for X in Xs]
    arrs = [a.reshape(a.shape[0], -1) if a.ndim > 1 else a[:, None]
            for a in arrs]
    out = arrs[0]
    for a in arrs[1:]:
        n1, d1 = out.shape
        n2, d2 = a.shape
        left = np.repeat(out, n2, axis=0)
        right = np.tile(a, (n1, 1))
        out = np.concatenate([left, right], axis=1)
    return out.astype(floatX())
