"""Cartesian parameter-domain sweeps for logp/logcdf, mirroring the
reference's Domain-product methodology
(``pymc3/tests/test_distributions.py:1`` — every distribution checked
over products of parameter domains with precision-tiered tolerances),
plus the logcdf tail-stability and broadcasting cases where distribution
bugs actually live.

The existing ``test_distributions*.py`` pin most distributions at one
parameter set; this file is the depth pass."""
import itertools

import numpy as np
import pytest
import scipy.stats as st
import scipy.special as sp

import pymc3_tpu as pm
from pymc3_tpu.config import floatX


def TOL():
    # cf. the reference's select_by_precision(float64=6, float32=3),
    # tests/helpers.py:100
    return 1e-6 if floatX() == "float64" else 1.5e-3


# value grids (shared length 8 so each elementwise kernel compiles once)
R = [-3.5, -1.0, -0.1, 0.0, 0.5, 1.0, 2.5, 3.3]
Rplus = [0.05, 0.3, 0.5, 1.0, 2.5, 4.0, 7.5, 15.0]
Unit = [0.02, 0.1, 0.25, 0.5, 0.65, 0.8, 0.95, 0.99]
Circ = [-3.0, -1.5, -0.5, 0.0, 0.5, 1.0, 2.0, 3.0]
Nat = [0, 1, 2, 3, 5, 8, 13, 21]


def combos(paramdomains):
    """Cartesian product of parameter domains -> list of param dicts.
    A list input is taken as explicit (pre-paired) parameter sets for
    distributions with cross-parameter constraints (lower < upper ...)."""
    if isinstance(paramdomains, list):
        return paramdomains
    names = list(paramdomains)
    return [dict(zip(names, vals))
            for vals in itertools.product(*(paramdomains[n] for n in names))]


def check_logp_matrix(dist_cls, paramdomains, grid, scipy_logpdf,
                      tol_scale=1.0, dist_kwargs=None):
    tol = TOL() * tol_scale
    for params in combos(paramdomains):
        d = dist_cls.dist(**params, **(dist_kwargs or {}))
        v = np.asarray(grid, dtype=floatX())
        got = np.asarray(d.logp(v))
        with np.errstate(all="ignore"):
            want = np.array([scipy_logpdf(x, **params) for x in grid],
                            dtype=np.float64)
        finite = np.isfinite(want)
        np.testing.assert_allclose(
            got[finite], want[finite], rtol=tol, atol=tol,
            err_msg=f"{dist_cls.__name__} logp at {params}")
        # outside support: -inf (or the bound()-mask huge negative)
        assert np.all(~np.isfinite(got[~finite]) | (got[~finite] < -1e6)), \
            f"{dist_cls.__name__} support mask at {params}"


def check_logcdf_matrix(dist_cls, paramdomains, grid, scipy_logcdf,
                        tol_scale=1.0):
    tol = TOL() * tol_scale
    for params in combos(paramdomains):
        d = dist_cls.dist(**params)
        v = np.asarray(grid, dtype=floatX())
        got = np.asarray(d.logcdf(v))
        with np.errstate(all="ignore"):
            want = np.array([scipy_logcdf(x, **params) for x in grid],
                            dtype=np.float64)
        finite = np.isfinite(want)
        np.testing.assert_allclose(
            got[finite], want[finite], rtol=tol, atol=tol,
            err_msg=f"{dist_cls.__name__} logcdf at {params}")


def check_logcdf_tails(dist_cls, params, lo, hi, deep):
    """Tail discipline: monotone non-decreasing, right tail -> 0, left
    tail very negative, and NEVER NaN — not even at ``deep`` values far
    past float32 underflow (the reference's extreme-value logcdf
    regressions)."""
    d = dist_cls.dist(**params)
    grid = np.asarray(sorted(lo + hi), dtype=floatX())
    got = np.asarray(d.logcdf(grid))
    assert not np.any(np.isnan(got)), f"{dist_cls.__name__} NaN in tails"
    assert np.all(got[np.isfinite(got)] <= 1e-6)
    # monotone along the sorted grid (allow exact ties / -inf floor)
    finite = got[np.isfinite(got)]
    assert np.all(np.diff(finite) >= -1e-5), \
        f"{dist_cls.__name__} logcdf not monotone: {got}"
    # right tail saturates at log(1) = 0
    assert abs(float(got[-1])) < 5e-2, f"{dist_cls.__name__} hi tail {got[-1]}"
    # left tail is far down but defined
    assert float(got[0]) < -5.0
    deep_got = np.asarray(d.logcdf(np.asarray(deep, dtype=floatX())))
    assert not np.any(np.isnan(deep_got)), \
        f"{dist_cls.__name__} NaN at deep tail values {deep} -> {deep_got}"


# =========================================================================
# continuous logp matrix
# =========================================================================

CONTINUOUS_LOGP = [
    ("normal", pm.Normal,
     dict(mu=[-3.0, 0.0, 2.5], sigma=[0.2, 1.0, 5.0]), R,
     lambda v, mu, sigma: st.norm.logpdf(v, mu, sigma), 1.0),
    ("uniform", pm.Uniform,
     [dict(lower=-4.0, upper=-2.0), dict(lower=-1.0, upper=3.0),
      dict(lower=0.0, upper=0.5)], R,
     lambda v, lower, upper: st.uniform.logpdf(v, lower, upper - lower), 1.0),
    ("truncated_normal", pm.TruncatedNormal,
     [dict(mu=0.0, sigma=1.0, lower=-1.0, upper=1.0),
      dict(mu=2.0, sigma=0.5, lower=0.0, upper=10.0),
      dict(mu=-1.0, sigma=3.0, lower=-2.0, upper=-0.5)], R,
     lambda v, mu, sigma, lower, upper: st.truncnorm.logpdf(
         v, (lower - mu) / sigma, (upper - mu) / sigma, mu, sigma), 3.0),
    ("halfnormal", pm.HalfNormal,
     dict(sigma=[0.3, 1.0, 4.0]), Rplus,
     lambda v, sigma: st.halfnorm.logpdf(v, scale=sigma), 1.0),
    ("wald", pm.Wald,
     dict(mu=[0.5, 1.0, 3.0], lam=[0.5, 2.0]), Rplus,
     lambda v, mu, lam: st.invgauss.logpdf(v, mu / lam, scale=lam), 2.0),
    ("beta", pm.Beta,
     dict(alpha=[0.5, 1.0, 2.0, 8.0], beta=[0.5, 1.0, 2.0, 8.0]), Unit,
     lambda v, alpha, beta: st.beta.logpdf(v, alpha, beta), 2.0),
    ("kumaraswamy", pm.Kumaraswamy,
     dict(a=[0.5, 2.0, 5.0], b=[0.5, 2.0, 5.0]), Unit,
     lambda v, a, b: (np.log(a * b) + (a - 1) * np.log(v)
                      + (b - 1) * np.log1p(-v ** a)), 2.0),
    ("exponential", pm.Exponential,
     dict(lam=[0.2, 1.0, 5.0]), Rplus,
     lambda v, lam: st.expon.logpdf(v, scale=1.0 / lam), 1.0),
    ("laplace", pm.Laplace,
     dict(mu=[-2.0, 0.0, 1.5], b=[0.3, 1.0, 4.0]), R,
     lambda v, mu, b: st.laplace.logpdf(v, mu, b), 1.0),
    ("lognormal", pm.Lognormal,
     dict(mu=[-1.0, 0.0, 1.0], sigma=[0.4, 1.0, 2.0]), Rplus,
     lambda v, mu, sigma: st.lognorm.logpdf(v, sigma, scale=np.exp(mu)), 1.0),
    ("studentt", pm.StudentT,
     dict(nu=[1.0, 4.0, 30.0], mu=[-1.0, 2.0], sigma=[0.5, 2.0]), R,
     lambda v, nu, mu, sigma: st.t.logpdf(v, nu, mu, sigma), 2.0),
    ("pareto", pm.Pareto,
     dict(alpha=[0.8, 2.0, 5.0], m=[0.1, 1.0, 2.0]), Rplus,
     lambda v, alpha, m: st.pareto.logpdf(v, alpha, scale=m), 1.0),
    ("cauchy", pm.Cauchy,
     dict(alpha=[-2.0, 0.0, 1.0], beta=[0.3, 1.0, 3.0]), R,
     lambda v, alpha, beta: st.cauchy.logpdf(v, alpha, beta), 1.0),
    ("halfcauchy", pm.HalfCauchy,
     dict(beta=[0.3, 1.0, 5.0]), Rplus,
     lambda v, beta: st.halfcauchy.logpdf(v, scale=beta), 1.0),
    ("gamma", pm.Gamma,
     dict(alpha=[0.5, 1.0, 3.0, 10.0], beta=[0.5, 2.0]), Rplus,
     lambda v, alpha, beta: st.gamma.logpdf(v, alpha, scale=1.0 / beta), 2.0),
    ("inversegamma", pm.InverseGamma,
     dict(alpha=[0.5, 2.0, 5.0], beta=[0.5, 1.0, 3.0]), Rplus,
     lambda v, alpha, beta: st.invgamma.logpdf(v, alpha, scale=beta), 2.0),
    ("chisquared", pm.ChiSquared,
     dict(nu=[1.0, 3.0, 9.0]), Rplus,
     lambda v, nu: st.chi2.logpdf(v, nu), 3.0),
    ("weibull", pm.Weibull,
     dict(alpha=[0.5, 1.0, 3.0], beta=[0.5, 2.0]), Rplus,
     lambda v, alpha, beta: st.weibull_min.logpdf(v, alpha, scale=beta), 2.0),
    ("halfstudentt", pm.HalfStudentT,
     dict(nu=[1.0, 5.0, 25.0], sigma=[0.5, 2.0]), Rplus,
     lambda v, nu, sigma: np.log(2) + st.t.logpdf(v, nu, 0.0, sigma), 2.0),
    ("exgaussian", pm.ExGaussian,
     dict(mu=[-1.0, 1.0], sigma=[0.5, 1.5], nu=[0.5, 2.0]), R,
     lambda v, mu, sigma, nu: st.exponnorm.logpdf(
         v, nu / sigma, mu, sigma), 5.0),
    ("vonmises", pm.VonMises,
     dict(mu=[-1.0, 0.0, 1.5], kappa=[0.5, 2.0, 10.0]), Circ,
     lambda v, mu, kappa: st.vonmises.logpdf(v, kappa, mu), 3.0),
    ("skewnormal", pm.SkewNormal,
     dict(mu=[-1.0, 1.0], sigma=[0.5, 2.0], alpha=[-3.0, 0.0, 2.0]), R,
     lambda v, mu, sigma, alpha: st.skewnorm.logpdf(v, alpha, mu, sigma),
     3.0),
    ("triangular", pm.Triangular,
     [dict(lower=-2.0, c=0.0, upper=2.0), dict(lower=0.0, c=0.5, upper=3.0),
      dict(lower=-3.0, c=-2.5, upper=-1.0)], R,
     lambda v, lower, c, upper: st.triang.logpdf(
         v, (c - lower) / (upper - lower), lower, upper - lower), 1.0),
    ("gumbel", pm.Gumbel,
     dict(mu=[-1.0, 0.0, 2.0], beta=[0.5, 1.0, 3.0]), R,
     lambda v, mu, beta: st.gumbel_r.logpdf(v, mu, beta), 1.0),
    ("rice", pm.Rice,
     dict(nu=[0.5, 2.0, 4.0], sigma=[0.5, 1.0]), Rplus,
     lambda v, nu, sigma: st.rice.logpdf(v, nu / sigma, scale=sigma), 5.0),
    ("logistic", pm.Logistic,
     dict(mu=[-2.0, 0.0, 1.0], s=[0.3, 1.0, 2.5]), R,
     lambda v, mu, s: st.logistic.logpdf(v, mu, s), 1.0),
    ("logitnormal", pm.LogitNormal,
     dict(mu=[-1.0, 0.0, 1.0], sigma=[0.5, 1.0, 2.0]), Unit,
     lambda v, mu, sigma: (st.norm.logpdf(sp.logit(v), mu, sigma)
                           - np.log(v) - np.log1p(-v)), 2.0),
]


@pytest.mark.parametrize(
    "name,dist,domains,grid,logpdf,tol_scale", CONTINUOUS_LOGP,
    ids=[e[0] for e in CONTINUOUS_LOGP])
def test_continuous_logp_matrix(name, dist, domains, grid, logpdf,
                                tol_scale):
    check_logp_matrix(dist, domains, grid, logpdf, tol_scale)


# =========================================================================
# continuous logcdf matrix (incl. tails)
# =========================================================================

CONTINUOUS_LOGCDF = [
    ("normal", pm.Normal, dict(mu=[-2.0, 0.0, 1.5], sigma=[0.5, 1.0, 3.0]),
     R, lambda v, mu, sigma: st.norm.logcdf(v, mu, sigma), 2.0),
    ("uniform", pm.Uniform,
     [dict(lower=-1.0, upper=2.0), dict(lower=0.0, upper=0.5)], R,
     lambda v, lower, upper: st.uniform.logcdf(v, lower, upper - lower), 1.0),
    ("halfnormal", pm.HalfNormal, dict(sigma=[0.5, 1.0, 3.0]), Rplus,
     lambda v, sigma: st.halfnorm.logcdf(v, scale=sigma), 2.0),
    ("wald", pm.Wald, dict(mu=[0.5, 1.5], lam=[1.0, 3.0]), Rplus,
     lambda v, mu, lam: st.invgauss.logcdf(v, mu / lam, scale=lam), 5.0),
    ("exponential", pm.Exponential, dict(lam=[0.3, 1.0, 4.0]), Rplus,
     lambda v, lam: st.expon.logcdf(v, scale=1.0 / lam), 1.0),
    ("laplace", pm.Laplace, dict(mu=[-1.0, 0.5], b=[0.5, 2.0]), R,
     lambda v, mu, b: st.laplace.logcdf(v, mu, b), 1.0),
    ("lognormal", pm.Lognormal, dict(mu=[-0.5, 0.5], sigma=[0.5, 1.5]),
     Rplus,
     lambda v, mu, sigma: st.lognorm.logcdf(v, sigma, scale=np.exp(mu)), 3.0),
    ("studentt", pm.StudentT,
     dict(nu=[2.0, 10.0], mu=[0.0, 1.0], sigma=[0.5, 2.0]), R,
     lambda v, nu, mu, sigma: st.t.logcdf(v, nu, mu, sigma), 5.0),
    ("pareto", pm.Pareto, dict(alpha=[1.0, 3.0], m=[0.5, 1.0]), Rplus,
     lambda v, alpha, m: st.pareto.logcdf(v, alpha, scale=m), 2.0),
    ("cauchy", pm.Cauchy, dict(alpha=[-1.0, 0.5], beta=[0.5, 2.0]), R,
     lambda v, alpha, beta: st.cauchy.logcdf(v, alpha, beta), 2.0),
    ("halfcauchy", pm.HalfCauchy, dict(beta=[0.5, 1.0, 3.0]), Rplus,
     lambda v, beta: st.halfcauchy.logcdf(v, scale=beta), 2.0),
    ("gamma", pm.Gamma, dict(alpha=[0.5, 2.0, 6.0], beta=[0.5, 2.0]), Rplus,
     lambda v, alpha, beta: st.gamma.logcdf(v, alpha, scale=1.0 / beta), 5.0),
    ("inversegamma", pm.InverseGamma,
     dict(alpha=[1.0, 3.0], beta=[0.5, 2.0]), Rplus,
     lambda v, alpha, beta: st.invgamma.logcdf(v, alpha, scale=beta), 5.0),
    ("weibull", pm.Weibull, dict(alpha=[0.5, 2.0], beta=[0.5, 2.0]), Rplus,
     lambda v, alpha, beta: st.weibull_min.logcdf(v, alpha, scale=beta), 2.0),
    ("triangular", pm.Triangular,
     [dict(lower=-2.0, c=0.0, upper=2.0), dict(lower=0.0, c=2.0, upper=3.0)],
     R, lambda v, lower, c, upper: st.triang.logcdf(
         v, (c - lower) / (upper - lower), lower, upper - lower), 2.0),
    ("gumbel", pm.Gumbel, dict(mu=[-1.0, 1.0], beta=[0.5, 2.0]), R,
     lambda v, mu, beta: st.gumbel_r.logcdf(v, mu, beta), 2.0),
    ("logistic", pm.Logistic, dict(mu=[-1.0, 0.5], s=[0.5, 2.0]), R,
     lambda v, mu, s: st.logistic.logcdf(v, mu, s), 2.0),
    ("exgaussian", pm.ExGaussian,
     dict(mu=[0.0], sigma=[1.0], nu=[1.0, 2.5]), R,
     lambda v, mu, sigma, nu: st.exponnorm.logcdf(v, nu / sigma, mu, sigma),
     10.0),
    ("beta", pm.Beta, dict(alpha=[0.5, 2.0], beta=[0.5, 3.0]), Unit,
     lambda v, alpha, beta: st.beta.logcdf(v, alpha, beta), 10.0),
]


@pytest.mark.parametrize(
    "name,dist,domains,grid,logcdf,tol_scale", CONTINUOUS_LOGCDF,
    ids=[e[0] for e in CONTINUOUS_LOGCDF])
def test_continuous_logcdf_matrix(name, dist, domains, grid, logcdf,
                                  tol_scale):
    check_logcdf_matrix(dist, domains, grid, logcdf, tol_scale)


TAIL_CASES = [
    ("normal", pm.Normal, dict(mu=0.0, sigma=1.0),
     [-9.0, -7.0, -5.0], [5.0, 7.0, 9.0], [-30.0, -100.0, 100.0]),
    ("halfnormal", pm.HalfNormal, dict(sigma=1.0),
     [1e-4, 1e-2], [5.0, 8.0], [1e-8, 40.0]),
    ("exponential", pm.Exponential, dict(lam=1.0),
     [1e-4, 1e-2], [20.0, 40.0], [1e-8, 500.0]),
    ("laplace", pm.Laplace, dict(mu=0.0, b=1.0),
     [-40.0, -20.0], [20.0, 40.0], [-500.0, 500.0]),
    ("gumbel", pm.Gumbel, dict(mu=0.0, beta=1.0),
     [-2.5, -2.0], [15.0, 30.0], [-4.0, 300.0]),
    ("logistic", pm.Logistic, dict(mu=0.0, s=1.0),
     [-60.0, -30.0], [30.0, 60.0], [-700.0, 700.0]),
    ("cauchy", pm.Cauchy, dict(alpha=0.0, beta=1.0),
     [-1e4, -1e2], [1e2, 1e4], [-1e7, 1e7]),
    ("gamma", pm.Gamma, dict(alpha=2.0, beta=1.0),
     [1e-3, 1e-2], [30.0, 60.0], [1e-6, 300.0]),
    ("weibull", pm.Weibull, dict(alpha=2.0, beta=1.0),
     [1e-3, 1e-2], [5.0, 8.0], [1e-6, 30.0]),
    ("studentt", pm.StudentT, dict(nu=3.0, mu=0.0, sigma=1.0),
     [-1e3, -1e2], [1e2, 1e3], [-1e6, 1e6]),
]


@pytest.mark.parametrize("name,dist,params,lo,hi,deep", TAIL_CASES,
                         ids=[e[0] for e in TAIL_CASES])
def test_logcdf_tails(name, dist, params, lo, hi, deep):
    check_logcdf_tails(dist, params, lo, hi, deep)


# =========================================================================
# discrete logp/logcdf matrix
# =========================================================================

def _zip_pmf(base_pmf):
    """Zero-inflation wrapper: psi-mixture with a point mass at 0."""
    def pmf(v, psi, **kw):
        p = psi * base_pmf(v, **kw)
        if v == 0:
            p += 1.0 - psi
        return np.log(p)
    return pmf


DISCRETE_LOGP = [
    ("binomial", pm.Binomial, dict(n=[8, 21], p=[0.1, 0.5, 0.9]), Nat,
     lambda v, n, p: st.binom.logpmf(v, n, p), 2.0),
    ("betabinomial", pm.BetaBinomial,
     dict(alpha=[0.5, 2.0], beta=[0.5, 3.0], n=[8, 21]), Nat,
     lambda v, alpha, beta, n: st.betabinom.logpmf(v, n, alpha, beta), 5.0),
    ("bernoulli", pm.Bernoulli, dict(p=[0.05, 0.4, 0.95]), [0, 1] * 4,
     lambda v, p: st.bernoulli.logpmf(v, p), 1.0),
    ("poisson", pm.Poisson, dict(mu=[0.5, 3.0, 12.0]), Nat,
     lambda v, mu: st.poisson.logpmf(v, mu), 2.0),
    ("negativebinomial", pm.NegativeBinomial,
     dict(mu=[1.0, 4.0], alpha=[0.5, 2.0, 8.0]), Nat,
     lambda v, mu, alpha: st.nbinom.logpmf(
         v, alpha, alpha / (mu + alpha)), 3.0),
    ("geometric", pm.Geometric, dict(p=[0.1, 0.5, 0.9]),
     [1, 2, 3, 5, 8, 13, 21, 34],
     lambda v, p: st.geom.logpmf(v, p), 2.0),
    ("discreteuniform", pm.DiscreteUniform,
     [dict(lower=0, upper=10), dict(lower=-5, upper=5),
      dict(lower=2, upper=2)], Nat,
     lambda v, lower, upper: st.randint.logpmf(v, lower, upper + 1), 1.0),
    ("zipoisson", pm.ZeroInflatedPoisson,
     dict(psi=[0.3, 0.8], theta=[1.0, 5.0]), Nat,
     _zip_pmf(lambda v, theta: st.poisson.pmf(v, theta)), 3.0),
    ("zibinomial", pm.ZeroInflatedBinomial,
     dict(psi=[0.3, 0.8], n=[13], p=[0.3, 0.7]), Nat,
     _zip_pmf(lambda v, n, p: st.binom.pmf(v, n, p)), 3.0),
    ("zinegbinomial", pm.ZeroInflatedNegativeBinomial,
     dict(psi=[0.4, 0.9], mu=[2.0], alpha=[1.0, 4.0]), Nat,
     _zip_pmf(lambda v, mu, alpha: st.nbinom.pmf(
         v, alpha, alpha / (mu + alpha))), 5.0),
    ("discreteweibull", pm.DiscreteWeibull,
     dict(q=[0.25, 0.7, 0.9], beta=[0.5, 1.5, 3.0]), Nat,
     # log-space form (the direct q**(v**b) difference underflows even
     # in this float64 oracle at q=0.25, v=13, b=3)
     lambda v, q, beta: (v ** beta * np.log(q) + np.log1p(
         -np.exp(((v + 1.0) ** beta - v ** beta) * np.log(q)))),
     3.0),
]


@pytest.mark.parametrize(
    "name,dist,domains,grid,logpmf,tol_scale", DISCRETE_LOGP,
    ids=[e[0] for e in DISCRETE_LOGP])
def test_discrete_logp_matrix(name, dist, domains, grid, logpmf, tol_scale):
    check_logp_matrix(dist, domains, grid, logpmf, tol_scale)


DISCRETE_LOGCDF = [
    ("binomial", pm.Binomial, dict(n=[13], p=[0.2, 0.6]), Nat,
     lambda v, n, p: st.binom.logcdf(v, n, p), 10.0),
    ("poisson", pm.Poisson, dict(mu=[0.5, 4.0]), Nat,
     lambda v, mu: st.poisson.logcdf(v, mu), 10.0),
    ("geometric", pm.Geometric, dict(p=[0.2, 0.7]),
     [1, 2, 3, 5, 8, 13, 21, 34],
     lambda v, p: st.geom.logcdf(v, p), 5.0),
    ("bernoulli", pm.Bernoulli, dict(p=[0.2, 0.8]), [0, 1] * 4,
     lambda v, p: st.bernoulli.logcdf(v, p), 2.0),
]


@pytest.mark.parametrize(
    "name,dist,domains,grid,logcdf,tol_scale", DISCRETE_LOGCDF,
    ids=[e[0] for e in DISCRETE_LOGCDF])
def test_discrete_logcdf_matrix(name, dist, domains, grid, logcdf,
                                tol_scale):
    check_logcdf_matrix(dist, domains, grid, logcdf, tol_scale)


# =========================================================================
# broadcasting: array params x array values (the reference covers this
# through its Domain machinery; bugs here surface as silent mis-shaping)
# =========================================================================

class TestParamBroadcasting:
    def test_vector_params_vector_values(self):
        mu = np.array([-1.0, 0.0, 2.0], dtype=floatX())
        sigma = np.array([0.5, 1.0, 2.0], dtype=floatX())
        v = np.array([0.3, -0.2, 1.7], dtype=floatX())
        got = np.asarray(pm.Normal.dist(mu=mu, sigma=sigma).logp(v))
        want = st.norm.logpdf(v.astype(np.float64), mu, sigma)
        np.testing.assert_allclose(got, want, rtol=TOL() * 2, atol=TOL() * 2)

    def test_matrix_values_vector_params(self):
        mu = np.array([-1.0, 0.0, 2.0], dtype=floatX())
        v = np.arange(6, dtype=floatX()).reshape(2, 3) / 3.0
        got = np.asarray(pm.Normal.dist(mu=mu, sigma=1.0).logp(v))
        assert got.shape == (2, 3)
        want = st.norm.logpdf(np.asarray(v, np.float64), mu, 1.0)
        np.testing.assert_allclose(got, want, rtol=TOL() * 2, atol=TOL() * 2)

    def test_gamma_row_params(self):
        alpha = np.array([0.5, 2.0, 4.0], dtype=floatX())
        beta = np.array([1.0, 0.5, 2.0], dtype=floatX())
        v = np.array([[0.5, 1.0, 2.0], [0.1, 3.0, 0.7]], dtype=floatX())
        got = np.asarray(pm.Gamma.dist(alpha=alpha, beta=beta).logp(v))
        want = st.gamma.logpdf(np.asarray(v, np.float64), alpha,
                               scale=1.0 / beta)
        np.testing.assert_allclose(got, want, rtol=TOL() * 3, atol=TOL() * 3)

    def test_binomial_vector_n(self):
        n = np.array([5, 10, 20])
        p = np.array([0.2, 0.5, 0.8], dtype=floatX())
        v = np.array([2, 5, 15])
        got = np.asarray(pm.Binomial.dist(n=n, p=p).logp(v))
        want = st.binom.logpmf(v, n, p.astype(np.float64))
        np.testing.assert_allclose(got, want, rtol=TOL() * 3, atol=TOL() * 3)

    def test_logcdf_broadcasts(self):
        mu = np.array([-1.0, 0.0, 1.0], dtype=floatX())
        v = np.array([0.0, 0.0, 0.0], dtype=floatX())
        got = np.asarray(pm.Normal.dist(mu=mu, sigma=1.0).logcdf(v))
        want = st.norm.logcdf(np.zeros(3), mu, 1.0)
        np.testing.assert_allclose(got, want, rtol=TOL() * 2, atol=TOL() * 2)
