"""Exact-math tests: logp/logcdf pointwise vs scipy, following the pattern of
``pymc3/tests/test_distributions.py`` (Domain cartesian products with
precision-dependent tolerances)."""
import itertools

import numpy as np
import pytest
import scipy.stats as st
import scipy.special as sp

import pymc3_tpu as pm

TOL = 1e-3  # float32 build (cf. select_by_precision(float32=3), tests/helpers.py:100)


def check_logp(dist_cls, params, value_grid, scipy_logpdf, tol=TOL,
               dist_kwargs=None):
    d = dist_cls.dist(**params, **(dist_kwargs or {}))
    grid = np.asarray(value_grid, dtype=np.float32)
    got = np.asarray(d.logp(grid))
    want = np.array([scipy_logpdf(v, **params) for v in value_grid])
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=tol, atol=tol,
                               err_msg=f"{dist_cls.__name__} logp params {params}")
    assert np.all(~np.isfinite(got[~finite]) | (got[~finite] < -1e6))


def check_logcdf(dist_cls, params, value_grid, scipy_logcdf, tol=TOL):
    d = dist_cls.dist(**params)
    grid = np.asarray(value_grid, dtype=np.float32)
    got = np.asarray(d.logcdf(grid))
    want = np.array([scipy_logcdf(v, **params) for v in value_grid])
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=tol, atol=tol,
                               err_msg=f"{dist_cls.__name__} logcdf params {params}")


# all grids share length 8 so XLA compiles each elementwise op exactly once
R = [-2.5, -1.0, -0.1, 0.0, 0.5, 1.0, 2.5, 3.3]
Rplus = [0.1, 0.5, 1.0, 2.5, 10.0, 0.25, 4.0, 7.5]
Unit = [0.05, 0.25, 0.5, 0.75, 0.95, 0.35, 0.65, 0.85]


class TestContinuousLogp:
    def test_uniform(self):
        check_logp(pm.Uniform, dict(lower=-1.0, upper=2.0), [-0.5, 0.0, 1.5, 0.3, 0.7, 1.1, -0.9, 1.9],
                   lambda v, lower, upper: st.uniform.logpdf(v, lower, upper - lower))
        check_logcdf(pm.Uniform, dict(lower=-1.0, upper=2.0), [-0.5, 0.0, 1.5, 0.3, 0.7, 1.1, -0.9, 1.9],
                     lambda v, lower, upper: st.uniform.logcdf(v, lower, upper - lower))

    def test_normal(self):
        for mu, sigma in itertools.product([-1.0, 0.0, 2.0], [0.5, 1.0, 2.5]):
            check_logp(pm.Normal, dict(mu=mu, sigma=sigma), R,
                       lambda v, mu, sigma: st.norm.logpdf(v, mu, sigma))
            check_logcdf(pm.Normal, dict(mu=mu, sigma=sigma), R,
                         lambda v, mu, sigma: st.norm.logcdf(v, mu, sigma))

    def test_halfnormal(self):
        check_logp(pm.HalfNormal, dict(sigma=1.5), Rplus,
                   lambda v, sigma: st.halfnorm.logpdf(v, scale=sigma))
        check_logcdf(pm.HalfNormal, dict(sigma=1.5), Rplus,
                     lambda v, sigma: st.halfnorm.logcdf(v, scale=sigma))

    def test_truncated_normal(self):
        check_logp(pm.TruncatedNormal, dict(mu=0.5, sigma=1.0, lower=-1.0, upper=2.0),
                   [-0.5, 0.0, 1.5, 0.3, 0.7, 1.1, -0.9, 1.9],
                   lambda v, mu, sigma, lower, upper: st.truncnorm.logpdf(
                       v, (lower - mu) / sigma, (upper - mu) / sigma, mu, sigma))

    def test_beta(self):
        for a, b in [(0.5, 0.5), (2.0, 5.0), (1.0, 1.0)]:
            check_logp(pm.Beta, dict(alpha=a, beta=b), Unit,
                       lambda v, alpha, beta: st.beta.logpdf(v, alpha, beta))

    def test_kumaraswamy(self):
        a, b = 2.0, 3.0
        d = pm.Kumaraswamy.dist(a=a, b=b)
        v = np.asarray(Unit, dtype=np.float32)
        want = np.log(a * b) + (a - 1) * np.log(v) + (b - 1) * np.log1p(-v ** a)
        np.testing.assert_allclose(np.asarray(d.logp(v)), want, rtol=TOL)

    def test_exponential(self):
        check_logp(pm.Exponential, dict(lam=2.0), Rplus,
                   lambda v, lam: st.expon.logpdf(v, scale=1 / lam))
        check_logcdf(pm.Exponential, dict(lam=2.0), Rplus,
                     lambda v, lam: st.expon.logcdf(v, scale=1 / lam))

    def test_laplace(self):
        check_logp(pm.Laplace, dict(mu=0.5, b=2.0), R,
                   lambda v, mu, b: st.laplace.logpdf(v, mu, b))
        check_logcdf(pm.Laplace, dict(mu=0.5, b=2.0), R,
                     lambda v, mu, b: st.laplace.logcdf(v, mu, b))

    def test_lognormal(self):
        check_logp(pm.Lognormal, dict(mu=0.2, sigma=0.8), Rplus,
                   lambda v, mu, sigma: st.lognorm.logpdf(v, sigma, 0, np.exp(mu)))
        check_logcdf(pm.Lognormal, dict(mu=0.2, sigma=0.8), Rplus,
                     lambda v, mu, sigma: st.lognorm.logcdf(v, sigma, 0, np.exp(mu)))

    def test_studentt(self):
        check_logp(pm.StudentT, dict(nu=4.0, mu=0.5, sigma=2.0), R,
                   lambda v, nu, mu, sigma: st.t.logpdf(v, nu, mu, sigma))
        check_logcdf(pm.StudentT, dict(nu=4.0, mu=0.5, sigma=2.0), R,
                     lambda v, nu, mu, sigma: st.t.logcdf(v, nu, mu, sigma))

    def test_pareto(self):
        check_logp(pm.Pareto, dict(alpha=3.0, m=1.5), [2.0, 3.0, 10.0, 1.6, 2.5, 4.0, 5.5, 8.0],
                   lambda v, alpha, m: st.pareto.logpdf(v, alpha, scale=m))

    def test_cauchy(self):
        check_logp(pm.Cauchy, dict(alpha=0.5, beta=2.0), R,
                   lambda v, alpha, beta: st.cauchy.logpdf(v, alpha, beta))
        check_logcdf(pm.Cauchy, dict(alpha=0.5, beta=2.0), R,
                     lambda v, alpha, beta: st.cauchy.logcdf(v, alpha, beta))

    def test_halfcauchy(self):
        check_logp(pm.HalfCauchy, dict(beta=2.0), Rplus,
                   lambda v, beta: st.halfcauchy.logpdf(v, scale=beta))

    def test_gamma(self):
        check_logp(pm.Gamma, dict(alpha=2.0, beta=3.0), Rplus,
                   lambda v, alpha, beta: st.gamma.logpdf(v, alpha, scale=1 / beta))
        check_logcdf(pm.Gamma, dict(alpha=2.0, beta=3.0), Rplus,
                     lambda v, alpha, beta: st.gamma.logcdf(v, alpha, scale=1 / beta))

    def test_inversegamma(self):
        check_logp(pm.InverseGamma, dict(alpha=3.0, beta=2.0), Rplus,
                   lambda v, alpha, beta: st.invgamma.logpdf(v, alpha, scale=beta))

    def test_chisquared(self):
        check_logp(pm.ChiSquared, dict(nu=3.0), Rplus,
                   lambda v, nu: st.chi2.logpdf(v, nu))

    def test_weibull(self):
        check_logp(pm.Weibull, dict(alpha=1.5, beta=2.0), Rplus,
                   lambda v, alpha, beta: st.weibull_min.logpdf(v, alpha, scale=beta))

    def test_halfstudentt(self):
        d = pm.HalfStudentT.dist(nu=4.0, sigma=2.0)
        v = np.asarray(Rplus, dtype=np.float32)
        want = np.log(2) + st.t.logpdf(v, 4.0, 0, 2.0)
        np.testing.assert_allclose(np.asarray(d.logp(v)), want, rtol=TOL)

    def test_exgaussian(self):
        check_logp(pm.ExGaussian, dict(mu=0.5, sigma=1.0, nu=2.0), R,
                   lambda v, mu, sigma, nu: st.exponnorm.logpdf(
                       v, nu / sigma, mu, sigma))

    def test_vonmises(self):
        check_logp(pm.VonMises, dict(mu=0.5, kappa=2.0),
                   [-3.0, -1.0, 0.0, 1.0, 3.0, -2.0, 2.0, 0.5],
                   lambda v, mu, kappa: st.vonmises.logpdf(v, kappa, mu))

    def test_skewnormal(self):
        check_logp(pm.SkewNormal, dict(mu=0.5, sigma=1.5, alpha=2.0), R,
                   lambda v, mu, sigma, alpha: st.skewnorm.logpdf(v, alpha, mu, sigma))

    def test_triangular(self):
        check_logp(pm.Triangular, dict(lower=-1.0, c=0.5, upper=2.0),
                   [-0.5, 0.0, 0.9, 1.5, 0.2, 0.6, 1.1, 1.8],
                   lambda v, lower, c, upper: st.triang.logpdf(
                       v, (c - lower) / (upper - lower), lower, upper - lower))

    def test_gumbel(self):
        check_logp(pm.Gumbel, dict(mu=0.5, beta=2.0), R,
                   lambda v, mu, beta: st.gumbel_r.logpdf(v, mu, beta))
        check_logcdf(pm.Gumbel, dict(mu=0.5, beta=2.0), R,
                     lambda v, mu, beta: st.gumbel_r.logcdf(v, mu, beta))

    def test_rice(self):
        check_logp(pm.Rice, dict(nu=2.0, sigma=1.5), Rplus,
                   lambda v, nu, sigma: st.rice.logpdf(v, nu / sigma, scale=sigma))

    def test_logistic(self):
        check_logp(pm.Logistic, dict(mu=0.5, s=2.0), R,
                   lambda v, mu, s: st.logistic.logpdf(v, mu, s))

    def test_logitnormal(self):
        d = pm.LogitNormal.dist(mu=0.3, sigma=1.2)
        v = np.asarray(Unit, dtype=np.float32)
        want = st.norm.logpdf(sp.logit(v), 0.3, 1.2) - np.log(v * (1 - v))
        np.testing.assert_allclose(np.asarray(d.logp(v)), want, rtol=TOL,
                                   atol=TOL)

    def test_wald(self):
        check_logp(pm.Wald, dict(mu=1.5, lam=2.0), Rplus,
                   lambda v, mu, lam: st.invgauss.logpdf(v, mu / lam, scale=lam))

    def test_flat(self):
        d = pm.Flat.dist()
        assert float(d.logp(3.0)) == 0.0
        d = pm.HalfFlat.dist()
        assert float(d.logp(3.0)) == 0.0
        assert float(d.logp(-3.0)) == -np.inf

    def test_interpolated(self):
        x = np.linspace(-5, 5, 200)
        pdf = st.norm.pdf(x)
        d = pm.Interpolated.dist(x_points=x, pdf_points=pdf)
        v = np.asarray([-2.0, 0.0, 1.5], dtype=np.float32)
        np.testing.assert_allclose(np.asarray(d.logp(v)),
                                   st.norm.logpdf(v), atol=1e-3)

    def test_outside_support(self):
        assert float(pm.HalfNormal.dist(sigma=1.0).logp(-1.0)) == -np.inf
        assert float(pm.Beta.dist(alpha=2.0, beta=2.0).logp(1.5)) == -np.inf
        assert float(pm.Exponential.dist(lam=1.0).logp(-0.1)) == -np.inf
        assert float(pm.Pareto.dist(alpha=1.0, m=1.0).logp(0.5)) == -np.inf


class TestRVParams:
    def test_rv_params(self):
        """RV-valued parameters resolve through the env."""
        import jax.numpy as jnp
        with pm.Model() as m:
            x = pm.Normal('x', 0., 1.)
            y = pm.Normal('y', mu=x, sigma=1.0)
        lp = m.logp({'x': 1.0, 'y': 1.5})
        want = st.norm.logpdf(1.0) + st.norm.logpdf(1.5, 1.0, 1.0)
        np.testing.assert_allclose(lp, want, rtol=TOL)

    def test_deterministic_param(self):
        with pm.Model() as m:
            x = pm.Normal('x', 0., 1.)
            d = pm.Deterministic('d', pm.math.exp(x))
            y = pm.Normal('y', mu=d, sigma=1.0)
        lp = m.logp({'x': 0.5, 'y': 2.0})
        want = st.norm.logpdf(0.5) + st.norm.logpdf(2.0, np.exp(0.5), 1.0)
        np.testing.assert_allclose(lp, want, rtol=TOL)

    def test_observed_rv_param(self):
        data = np.array([1.0, 2.0, 3.0])
        with pm.Model() as m:
            lam = pm.Gamma('lam', 2.0, 2.0)
            pm.Exponential('obs', lam=lam, observed=data)
        lam_v = 1.3
        lp = m.logp({'lam_log__': np.log(lam_v)})
        want = (st.gamma.logpdf(lam_v, 2.0, scale=0.5)
                + np.log(lam_v)  # jacobian
                + st.expon.logpdf(data, scale=1 / lam_v).sum())
        np.testing.assert_allclose(lp, want, rtol=TOL)


class TestTransforms:
    def test_roundtrip(self):
        import jax.numpy as jnp
        from pymc3_tpu.distributions import transforms as tr
        for t, x in [
            (tr.log, np.array([0.5, 2.0])),
            (tr.logodds, np.array([0.2, 0.8])),
            (tr.interval(-1.0, 2.0), np.array([0.0, 1.5])),
            (tr.lowerbound(1.0), np.array([1.5, 3.0])),
            (tr.upperbound(1.0), np.array([0.5, -3.0])),
            (tr.log_exp_m1, np.array([0.5, 2.0])),
            (tr.ordered, np.array([0.1, 0.5, 2.0])),
            (tr.stick_breaking, np.array([0.2, 0.3, 0.5])),
            (tr.sum_to_1, np.array([0.2, 0.3, 0.5])),
        ]:
            z = np.asarray(t.forward(jnp.asarray(x)))
            x2 = np.asarray(t.backward(jnp.asarray(z)))
            np.testing.assert_allclose(x, x2, rtol=1e-4, atol=1e-5)

    def test_jacobian_vs_numeric(self):
        import jax, jax.numpy as jnp
        from pymc3_tpu.distributions import transforms as tr
        for t, z in [
            (tr.log, np.array([0.3])),
            (tr.logodds, np.array([-0.5])),
            (tr.interval(-1.0, 2.0), np.array([0.7])),
            (tr.log_exp_m1, np.array([0.2])),
        ]:
            jac = jax.jacobian(lambda s: t.backward(s))(jnp.asarray(z, dtype=jnp.float32))
            want = np.log(np.abs(np.linalg.det(np.atleast_2d(np.asarray(jac)))))
            got = float(np.sum(np.asarray(t.jacobian_det(jnp.asarray(z, dtype=jnp.float32)))))
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)

    def test_stickbreaking_jacobian(self):
        import jax, jax.numpy as jnp
        from pymc3_tpu.distributions import transforms as tr
        t = tr.stick_breaking
        z = jnp.asarray(np.array([0.3, -0.2, 0.5]), dtype=jnp.float32)
        # numeric jacobian of backward restricted to first n-1 coords
        J = jax.jacobian(lambda s: t.backward(s)[:-1])(z)
        want = np.log(np.abs(np.linalg.det(np.asarray(J))))
        got = float(np.asarray(t.jacobian_det(z)))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


class TestModelCore:
    def test_missing_data_imputation(self):
        import warnings
        data = np.array([1.0, np.nan, 3.0])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pm.Model() as m:
                mu = pm.Normal('mu', 0., 10.)
                pm.Normal('obs', mu=mu, sigma=1.0, observed=data)
        assert any(v.name == 'obs_missing' for v in m.free_RVs)
        lp = m.logp({'mu': 0.0, 'obs_missing': np.array([2.0])})
        want = st.norm.logpdf(0, 0, 10) + st.norm.logpdf([1.0, 2.0, 3.0]).sum()
        np.testing.assert_allclose(lp, want, rtol=TOL)

    def test_potential(self):
        with pm.Model() as m:
            x = pm.Normal('x', 0., 1.)
            pm.Potential('pot', x * 2.0)
        lp = m.logp({'x': 1.0})
        np.testing.assert_allclose(lp, st.norm.logpdf(1.0) + 2.0, rtol=TOL)

    def test_total_size_scaling(self):
        data = np.ones(10)
        with pm.Model() as m:
            mu = pm.Normal('mu', 0., 1.)
            pm.Normal('obs', mu=mu, sigma=1.0, observed=data, total_size=100)
        lp = m.logp({'mu': 0.0})
        want = st.norm.logpdf(0.0) + 10.0 * st.norm.logpdf(1.0) * 10
        np.testing.assert_allclose(lp, want, rtol=TOL)

    def test_nested_model_prefix(self):
        with pm.Model() as outer:
            x = pm.Normal('x', 0., 1.)
            with pm.Model(name='sub') as inner:
                y = pm.Normal('y', 0., 1.)
        assert 'sub_y' in outer.named_vars
        assert len(outer.free_RVs) == 2

    def test_value_grad_function(self):
        with pm.Model() as m:
            x = pm.Normal('x', 0., 1., shape=3)
        f = m.logp_dlogp_function()
        q = np.array([0.5, -0.5, 1.0], dtype=np.float32)
        lp, g = f(q)
        np.testing.assert_allclose(lp, st.norm.logpdf(q).sum(), rtol=TOL)
        np.testing.assert_allclose(g, -q, rtol=TOL)


class TestLogcdfCompleteness:
    """logcdf vs scipy for the families the round-2 suite left untested
    Grids share length 8 (one XLA compile per
    elementwise op)."""

    def test_beta(self):
        check_logcdf(pm.Beta, dict(alpha=2.0, beta=3.0), Unit,
                     lambda v, alpha, beta: st.beta.logcdf(v, alpha, beta))

    def test_halfcauchy(self):
        check_logcdf(pm.HalfCauchy, dict(beta=2.0), Rplus,
                     lambda v, beta: st.halfcauchy.logcdf(v, scale=beta))

    def test_inverse_gamma(self):
        check_logcdf(pm.InverseGamma, dict(alpha=3.0, beta=2.0), Rplus,
                     lambda v, alpha, beta: st.invgamma.logcdf(
                         v, alpha, scale=beta))

    def test_logistic(self):
        check_logcdf(pm.Logistic, dict(mu=0.5, s=2.0), R,
                     lambda v, mu, s: st.logistic.logcdf(v, mu, s))

    def test_pareto(self):
        check_logcdf(pm.Pareto, dict(alpha=3.0, m=1.0),
                     [1.1, 1.5, 2.0, 3.0, 5.0, 8.0, 12.0, 20.0],
                     lambda v, alpha, m: st.pareto.logcdf(v, alpha, scale=m))

    def test_triangular(self):
        check_logcdf(pm.Triangular, dict(lower=0.0, c=0.3, upper=1.0), Unit,
                     lambda v, lower, c, upper: st.triang.logcdf(
                         v, (c - lower) / (upper - lower), loc=lower,
                         scale=upper - lower))

    def test_weibull(self):
        check_logcdf(pm.Weibull, dict(alpha=2.0, beta=1.5), Rplus,
                     lambda v, alpha, beta: st.weibull_min.logcdf(
                         v, alpha, scale=beta))

    def test_exgaussian(self):
        check_logcdf(pm.ExGaussian, dict(mu=0.0, sigma=1.0, nu=1.0), R,
                     lambda v, mu, sigma, nu: st.exponnorm.logcdf(
                         v, K=nu / sigma, loc=mu, scale=sigma))

    def test_wald(self):
        """Correct inverse-Gaussian logcdf (the reference's v3.8 closed
        form mis-scales for mu != 1; see Wald.logcdf docstring)."""
        for mu, lam in [(1.0, 1.0), (2.0, 0.5), (0.5, 3.0)]:
            check_logcdf(pm.Wald, dict(mu=mu, lam=lam), Rplus,
                         lambda v, mu, lam: st.invgauss.logcdf(
                             v, mu / lam, scale=lam))

    def test_wald_tails_finite_and_monotone(self):
        d = pm.Wald.dist(mu=2.0, lam=0.7)
        grid = np.asarray([1e-3, 0.1, 1.0, 10.0, 100.0, 1e3, 1e4, 1e5],
                          np.float32)
        lc = np.asarray(d.logcdf(grid))
        assert np.all(np.isfinite(lc))
        assert np.all(np.diff(lc) >= -1e-6)
        assert lc[-1] <= 0.0 and lc[-1] > -1e-4
