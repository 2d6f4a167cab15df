"""``random()`` shape semantics and distributional correctness — a port of
the reference contract pinned by ``pymc3/tests/test_distributions_random.py``
(``BaseTestCases.BaseTestCase``, the size x dist_shape matrix, and the
KS / chi-square two-sample checks of ``pymc3_random``/``pymc3_random_discrete``).
"""
import numpy as np
import pytest
import scipy.stats as st

import pymc3_tpu as pm

SIZES = [None, 5, (4, 5)]


def _shape_of(x):
    return np.atleast_1d(np.asarray(x)).shape


SCALAR_DISTS = [
    (pm.Normal, dict(mu=0.0, sigma=1.0)),
    (pm.HalfNormal, dict(sigma=1.0)),
    (pm.Uniform, dict(lower=0.0, upper=1.0)),
    (pm.Beta, dict(alpha=2.0, beta=3.0)),
    (pm.Gamma, dict(alpha=2.0, beta=1.5)),
    (pm.Exponential, dict(lam=1.2)),
    (pm.StudentT, dict(nu=4.0, mu=0.0, sigma=1.0)),
    (pm.Lognormal, dict(mu=0.0, sigma=0.5)),
    (pm.Cauchy, dict(alpha=0.0, beta=1.0)),
    (pm.Laplace, dict(mu=0.0, b=1.0)),
    (pm.Bernoulli, dict(p=0.4)),
    (pm.Binomial, dict(n=10, p=0.4)),
    (pm.Poisson, dict(mu=3.0)),
    (pm.NegativeBinomial, dict(mu=3.0, alpha=2.0)),
    (pm.Geometric, dict(p=0.3)),
    (pm.DiscreteUniform, dict(lower=0, upper=10)),
    (pm.ZeroInflatedPoisson, dict(psi=0.7, theta=3.0)),
]


@pytest.mark.parametrize("dist_cls,params",
                         SCALAR_DISTS, ids=lambda d: getattr(d, "__name__", ""))
class TestScalarShapeMatrix:
    """cf. ``BaseTestCases.BaseTestCase.test_scalar_parameter_shape`` /
    ``test_scalar_shape`` / ``test_parameters_1d_shape``."""

    def test_scalar_parameter_shape(self, dist_cls, params):
        d = dist_cls.dist(**params)
        for size in SIZES:
            expected = (1,) if size is None else tuple(np.atleast_1d(size))
            assert _shape_of(d.random(size=size)) == expected, size

    def test_scalar_shape(self, dist_cls, params):
        d = dist_cls.dist(shape=10, **params)
        for size in SIZES:
            expected = (() if size is None
                        else tuple(np.atleast_1d(size))) + (10,)
            assert _shape_of(d.random(size=size)) == expected, size

    def test_parameters_1d_shape(self, dist_cls, params):
        vec = {k: np.asarray(v) * np.ones(5, dtype=np.asarray(v).dtype)
               for k, v in params.items()}
        d = dist_cls.dist(shape=5, **vec)
        for size in SIZES:
            expected = (() if size is None
                        else tuple(np.atleast_1d(size))) + (5,)
            assert _shape_of(d.random(size=size)) == expected, size


class TestBroadcastShape:
    def test_normal_broadcast(self):
        d = pm.Normal.dist(mu=np.zeros(5), sigma=1.0, shape=(10, 5))
        for size in SIZES:
            expected = (() if size is None
                        else tuple(np.atleast_1d(size))) + (10, 5)
            assert _shape_of(d.random(size=size)) == expected, size


class TestMultivariateShapes:
    def test_mvnormal(self):
        mu = np.zeros(3)
        cov = np.eye(3)
        d = pm.MvNormal.dist(mu=mu, cov=cov, shape=(3,))
        assert _shape_of(d.random()) == (3,)
        assert _shape_of(d.random(size=5)) == (5, 3)
        assert _shape_of(d.random(size=(4, 5))) == (4, 5, 3)

    def test_dirichlet(self):
        d = pm.Dirichlet.dist(a=np.ones(4))
        assert _shape_of(d.random()) == (4,)
        s = np.asarray(d.random(size=6))
        assert s.shape == (6, 4)
        np.testing.assert_allclose(s.sum(-1), 1.0, rtol=1e-6)

    def test_multinomial(self):
        d = pm.Multinomial.dist(n=10, p=np.array([0.2, 0.3, 0.5]))
        assert _shape_of(d.random()) == (3,)
        s = np.asarray(d.random(size=7))
        assert s.shape == (7, 3)
        assert np.all(s.sum(-1) == 10)

    def test_categorical_vector_p(self):
        d = pm.Categorical.dist(p=np.array([0.2, 0.3, 0.5]))
        assert _shape_of(d.random(size=11)) == (11,)
        vals = np.asarray(d.random(size=1000))
        assert set(np.unique(vals)).issubset({0, 1, 2})


def ks_check(dist, params, ref_rand, size=10000, alpha=0.01, fails=5):
    """cf. ``pymc3_random`` (``test_distributions_random.py:37-56``)."""
    p = alpha
    f = fails
    while p <= alpha and f > 0:
        s0 = np.atleast_1d(np.asarray(dist.random(size=size))).ravel()
        s1 = np.atleast_1d(ref_rand(size=size, **params)).ravel()
        _, p = st.ks_2samp(s0, s1)
        f -= 1
    assert p > alpha, (dist, p)


def chisq_check(dist, params, ref_rand, size=20000, alpha=0.01, fails=10):
    """cf. ``pymc3_random_discrete`` (``test_distributions_random.py:59-85``)."""
    p = alpha
    f = fails
    while p <= alpha and f > 0:
        o = np.atleast_1d(np.asarray(dist.random(size=size))).ravel()
        e = np.atleast_1d(ref_rand(size=size, **params)).ravel()
        observed = dict(zip(*np.unique(o, return_counts=True)))
        expected = dict(zip(*np.unique(e, return_counts=True)))
        k = np.array([(observed.get(x, 0), expected[x]) for x in expected])
        if np.all(k[:, 0] == k[:, 1]):
            p = 1.0
        else:
            _, p = st.chisquare(k[:, 0], k[:, 1] * k[:, 0].sum() / k[:, 1].sum())
        f -= 1
    assert p > alpha, (dist, p)


class TestRandomMatchesScipy:
    def test_normal(self):
        ks_check(pm.Normal.dist(mu=1.0, sigma=2.0), dict(),
                 lambda size: st.norm.rvs(1.0, 2.0, size=size))

    def test_beta(self):
        ks_check(pm.Beta.dist(alpha=2.0, beta=5.0), dict(),
                 lambda size: st.beta.rvs(2.0, 5.0, size=size))

    def test_gamma(self):
        ks_check(pm.Gamma.dist(alpha=3.0, beta=2.0), dict(),
                 lambda size: st.gamma.rvs(3.0, scale=1 / 2.0, size=size))

    def test_exponential(self):
        ks_check(pm.Exponential.dist(lam=2.5), dict(),
                 lambda size: st.expon.rvs(scale=1 / 2.5, size=size))

    def test_studentt(self):
        ks_check(pm.StudentT.dist(nu=5.0, mu=0.5, sigma=1.5), dict(),
                 lambda size: st.t.rvs(5.0, 0.5, 1.5, size=size))

    def test_lognormal(self):
        ks_check(pm.Lognormal.dist(mu=0.3, sigma=0.6), dict(),
                 lambda size: st.lognorm.rvs(0.6, scale=np.exp(0.3),
                                             size=size))

    def test_halfcauchy(self):
        ks_check(pm.HalfCauchy.dist(beta=2.0), dict(),
                 lambda size: st.halfcauchy.rvs(scale=2.0, size=size))

    def test_mvnormal(self):
        mu = np.array([1.0, -1.0])
        cov = np.array([[2.0, 0.5], [0.5, 1.0]])
        d = pm.MvNormal.dist(mu=mu, cov=cov, shape=(2,))
        s = np.asarray(d.random(size=20000))
        np.testing.assert_allclose(s.mean(0), mu, atol=0.06)
        np.testing.assert_allclose(np.cov(s.T), cov, atol=0.1)

    def test_poisson(self):
        chisq_check(pm.Poisson.dist(mu=4.0), dict(),
                    lambda size: st.poisson.rvs(4.0, size=size))

    def test_binomial(self):
        chisq_check(pm.Binomial.dist(n=10, p=0.3), dict(),
                    lambda size: st.binom.rvs(10, 0.3, size=size))

    def test_geometric(self):
        chisq_check(pm.Geometric.dist(p=0.4), dict(),
                    lambda size: st.geom.rvs(0.4, size=size))

    def test_negative_binomial(self):
        chisq_check(pm.NegativeBinomial.dist(mu=4.0, alpha=2.0), dict(),
                    lambda size: st.nbinom.rvs(2.0, 2.0 / 6.0, size=size))

    def test_bernoulli(self):
        chisq_check(pm.Bernoulli.dist(p=0.3), dict(),
                    lambda size: st.bernoulli.rvs(0.3, size=size))

    def test_zero_inflated_poisson_moments(self):
        psi, theta = 0.7, 3.0
        s = np.asarray(pm.ZeroInflatedPoisson.dist(
            psi=psi, theta=theta).random(size=50000))
        np.testing.assert_allclose(s.mean(), psi * theta, rtol=0.05)


class TestRandomWithPoint:
    """Point replacement in forward draws (cf. ``TestDrawValues``)."""

    def test_point_replaces_parameters(self):
        with pm.Model():
            mu = pm.Normal("mu", mu=0.0, tau=1e-3)
            sigma = pm.Gamma("sigma", alpha=1.0, beta=1.0, transform=None)
            y = pm.Normal("y", mu=mu, sigma=sigma)
            s = y.distribution.random(point={"mu": 5.0, "sigma": 1e-6},
                                      size=100)
        np.testing.assert_allclose(np.asarray(s), 5.0, atol=1e-3)

    def test_draw_values_deterministic(self):
        from pymc3_tpu.distributions.distribution import draw_values
        with pm.Model():
            x = pm.Normal("x", mu=0.0, sigma=1.0)
            exp_x = pm.Deterministic("exp_x", pm.math.exp(x))
            xv, ev = draw_values([x, exp_x], point={"x": 1.7})
        np.testing.assert_allclose(np.exp(xv), ev, rtol=1e-5)


class TestTimeseriesRandom:
    def test_grw_shape_and_moments(self):
        d = pm.GaussianRandomWalk.dist(mu=0.0, sigma=1.0, shape=20)
        s = np.asarray(d.random(size=2000))
        assert s.shape == (2000, 20)
        # var of step t grows ~ t+1 (first step includes the init increment)
        v = s.var(0)
        assert v[10] > v[2]

    def test_ar1_shape(self):
        d = pm.AR1.dist(k=0.5, tau_e=1.0, shape=15)
        s = np.asarray(d.random(size=50))
        assert s.shape == (50, 15)


# ---------------------------------------------------------------------------
# round 3: the rest of the size x dist_shape cartesian contract
# (cf. /root/reference/pymc3/tests/test_distributions_random.py)
# ---------------------------------------------------------------------------
EXTRA_SCALAR_DISTS = [
    (pm.TruncatedNormal, dict(mu=0.0, sigma=1.0, lower=-1.0, upper=2.0)),
    (pm.Wald, dict(mu=1.0, lam=1.0)),
    (pm.Kumaraswamy, dict(a=2.0, b=3.0)),
    (pm.Triangular, dict(lower=0.0, c=0.3, upper=1.0)),
    (pm.Gumbel, dict(mu=0.0, beta=1.0)),
    (pm.Logistic, dict(mu=0.0, s=1.0)),
    (pm.LogitNormal, dict(mu=0.0, sigma=1.0)),
    (pm.SkewNormal, dict(mu=0.0, sigma=1.0, alpha=2.0)),
    (pm.ExGaussian, dict(mu=0.0, sigma=1.0, nu=1.0)),
    (pm.VonMises, dict(mu=0.0, kappa=1.0)),
    (pm.Rice, dict(nu=1.0, sigma=1.0)),
    (pm.Weibull, dict(alpha=2.0, beta=1.0)),
    (pm.HalfStudentT, dict(nu=4.0, sigma=1.0)),
    (pm.ChiSquared, dict(nu=3.0)),
    (pm.InverseGamma, dict(alpha=3.0, beta=1.0)),
    (pm.Pareto, dict(alpha=3.0, m=1.0)),
    (pm.BetaBinomial, dict(alpha=1.0, beta=1.0, n=10)),
    (pm.DiscreteWeibull, dict(q=0.5, beta=1.5)),
    (pm.Constant, dict(c=3)),
]


@pytest.mark.parametrize("dist_cls,params", EXTRA_SCALAR_DISTS,
                         ids=lambda d: getattr(d, "__name__", ""))
class TestExtraScalarShapeMatrix:
    """size x dist_shape matrix for the families the round-2 suite left
    untested."""

    def test_scalar_parameter_shape(self, dist_cls, params):
        d = dist_cls.dist(**params)
        for size in SIZES:
            expected = (1,) if size is None else tuple(np.atleast_1d(size))
            assert _shape_of(d.random(size=size)) == expected, size

    def test_scalar_shape(self, dist_cls, params):
        d = dist_cls.dist(shape=10, **params)
        for size in SIZES:
            expected = (() if size is None
                        else tuple(np.atleast_1d(size))) + (10,)
            assert _shape_of(d.random(size=size)) == expected, size

    def test_parameters_1d_shape(self, dist_cls, params):
        vec = {k: np.asarray(v) * np.ones(5, dtype=np.asarray(v).dtype)
               for k, v in params.items()}
        d = dist_cls.dist(shape=5, **vec)
        for size in SIZES:
            expected = (() if size is None
                        else tuple(np.atleast_1d(size))) + (5,)
            assert _shape_of(d.random(size=size)) == expected, size


class TestInterpolatedRandom:
    def test_shapes_and_support(self):
        d = pm.Interpolated.dist(x_points=np.linspace(0, 1, 11),
                                 pdf_points=np.ones(11))
        assert _shape_of(d.random()) == (1,)
        assert np.asarray(d.random(size=7)).shape == (7,)
        draws = np.asarray(d.random(size=500))
        assert draws.min() >= 0.0 and draws.max() <= 1.0


class TestMatrixVariateShapes:
    """Wishart / MatrixNormal / Kronecker random-path shape contracts
    (cf. reference ``test_distributions_random.py`` matrix cases)."""

    def test_wishart(self):
        with pytest.warns(UserWarning, match="MCMC"):
            d = pm.Wishart.dist(nu=5, V=np.eye(3))
        assert np.asarray(d.random()).shape == (3, 3)
        assert np.asarray(d.random(size=4)).shape == (4, 3, 3)
        assert np.asarray(d.random(size=(2, 3))).shape == (2, 3, 3, 3)
        # draws are symmetric PSD with mean nu*V
        w = np.asarray(d.random(size=2000))
        np.testing.assert_allclose(w, np.swapaxes(w, -1, -2), atol=1e-10)
        np.testing.assert_allclose(w.mean(axis=0), 5 * np.eye(3), atol=0.35)

    def test_matrix_normal(self):
        d = pm.MatrixNormal.dist(mu=np.zeros((3, 4)), rowcov=np.eye(3),
                                 colcov=np.eye(4), shape=(3, 4))
        assert np.asarray(d.random()).shape == (3, 4)
        assert np.asarray(d.random(size=5)).shape == (5, 3, 4)

    def test_kronecker_normal(self):
        d = pm.KroneckerNormal.dist(mu=np.zeros(6),
                                    covs=[np.eye(2), np.eye(3)], shape=6)
        assert np.asarray(d.random()).shape == (6,)
        assert np.asarray(d.random(size=4)).shape == (4, 6)
        assert np.asarray(d.random(size=(2, 5))).shape == (2, 5, 6)
        # kron structure: var 1 everywhere for identity factors
        x = np.asarray(d.random(size=20000))
        np.testing.assert_allclose(x.var(axis=0), np.ones(6), atol=0.06)

    def test_mv_student_t(self):
        d = pm.MvStudentT.dist(nu=6, mu=np.zeros(3), cov=np.eye(3))
        assert np.asarray(d.random()).shape == (3,)
        assert np.asarray(d.random(size=7)).shape == (7, 3)
        assert np.asarray(d.random(size=(2, 4))).shape == (2, 4, 3)
        x = np.asarray(d.random(size=60000))
        # var = nu/(nu-2) * I
        np.testing.assert_allclose(x.var(axis=0), np.full(3, 1.5), atol=0.1)

    def test_lkj_corr_packed(self):
        d = pm.LKJCorr.dist(eta=1.0, n=4)
        assert np.asarray(d.random()).shape == (6,)  # packed triu
        assert np.asarray(d.random(size=3)).shape == (3, 6)
        x = np.asarray(d.random(size=200))
        assert np.all(np.abs(x) <= 1.0)

    def test_lkj_cholesky_cov_packed(self):
        d = pm.LKJCholeskyCov.dist(eta=1.0, n=3,
                                   sd_dist=pm.HalfNormal.dist(1.0))
        assert np.asarray(d.random()).shape == (6,)  # n*(n+1)/2
        assert np.asarray(d.random(size=3)).shape == (3, 6)


class TestMixtureRandom:
    def test_normal_mixture_scalar_and_shaped(self):
        w = np.array([0.3, 0.7])
        mu = np.array([0.0, 5.0])
        d = pm.NormalMixture.dist(w=w, mu=mu, sigma=1.0)
        assert _shape_of(d.random()) == (1,)
        assert np.asarray(d.random(size=10)).shape == (10,)
        d6 = pm.NormalMixture.dist(w=w, mu=mu, sigma=1.0, shape=6)
        assert np.asarray(d6.random()).shape == (6,)
        assert np.asarray(d6.random(size=4)).shape == (4, 6)

    def test_normal_mixture_moments(self):
        w = np.array([0.3, 0.7])
        mu = np.array([0.0, 5.0])
        d = pm.NormalMixture.dist(w=w, mu=mu, sigma=0.5)
        x = np.asarray(d.random(size=40000))
        np.testing.assert_allclose(x.mean(), w @ mu, atol=0.1)
        # both modes populated in roughly the right proportion
        frac_hi = np.mean(x > 2.5)
        assert abs(frac_hi - 0.7) < 0.05

    def test_iterable_components(self):
        d = pm.Mixture.dist(w=np.array([0.5, 0.5]),
                            comp_dists=[pm.Poisson.dist(1.0),
                                        pm.Poisson.dist(20.0)])
        x = np.asarray(d.random(size=5000))
        assert x.shape == (5000,)
        assert abs(x.mean() - 10.5) < 0.6


class TestOrderedLogisticRandom:
    def test_shapes(self):
        d = pm.OrderedLogistic.dist(eta=0.0, cutpoints=np.array([-1.0, 1.0]))
        assert _shape_of(d.random()) == (1,)
        assert np.asarray(d.random(size=8)).shape == (8,)
        dv = pm.OrderedLogistic.dist(eta=np.zeros(7),
                                     cutpoints=np.array([-1.0, 1.0]),
                                     shape=7)
        assert np.asarray(dv.random()).shape == (7,)
        assert np.asarray(dv.random(size=3)).shape == (3, 7)

    def test_category_probabilities(self):
        cut = np.array([-1.0, 1.0])
        d = pm.OrderedLogistic.dist(eta=0.0, cutpoints=cut)
        x = np.asarray(d.random(size=40000))
        assert set(np.unique(x)).issubset({0, 1, 2})
        sig = lambda z: 1.0 / (1.0 + np.exp(-z))
        expected = np.array([sig(cut[0]), sig(cut[1]) - sig(cut[0]),
                             1.0 - sig(cut[1])])
        freq = np.array([(x == k).mean() for k in range(3)])
        np.testing.assert_allclose(freq, expected, atol=0.02)


class TestZeroInflatedRandom:
    def test_zib_moments(self):
        d = pm.ZeroInflatedBinomial.dist(psi=0.6, n=10, p=0.5)
        x = np.asarray(d.random(size=40000))
        assert x.shape == (40000,)
        np.testing.assert_allclose(x.mean(), 0.6 * 10 * 0.5, atol=0.12)
        assert (x == 0).mean() > 0.35  # inflation visible

    def test_zinb_moments(self):
        d = pm.ZeroInflatedNegativeBinomial.dist(psi=0.7, mu=3.0, alpha=2.0)
        x = np.asarray(d.random(size=40000))
        np.testing.assert_allclose(x.mean(), 0.7 * 3.0, atol=0.15)


class TestTimeseriesRandomParity:
    """Reference parity: only GaussianRandomWalk defines ``random``
    (``/root/reference/pymc3/distributions/timeseries.py:258`` is the sole
    implementation); the rest raise."""

    def test_grw_size_matrix(self):
        d = pm.GaussianRandomWalk.dist(sigma=1.0, shape=12)
        assert np.asarray(d.random()).shape == (12,)
        assert np.asarray(d.random(size=3)).shape == (3, 12)
        assert np.asarray(d.random(size=(2, 4))).shape == (2, 4, 12)

    def test_unimplemented_random_raise(self):
        cases = [
            pm.AR.dist(rho=[0.5], sigma=1.0, shape=15),
            pm.MvGaussianRandomWalk.dist(mu=np.zeros(3), cov=np.eye(3),
                                         shape=(10, 3)),
            pm.GARCH11.dist(omega=1.0, alpha_1=0.3, beta_1=0.3,
                            initial_vol=1.0, shape=10),
        ]
        for d in cases:
            with pytest.raises(NotImplementedError):
                d.random(size=2)

    def test_ar1_extension(self):
        # extension beyond the reference: AR1 forward sampling
        d = pm.AR1.dist(k=0.5, tau_e=1.0, shape=200)
        x = np.asarray(d.random(size=50))
        assert x.shape == (50, 200)
        # stationary lag-1 autocorrelation ~ k
        xc = x - x.mean(axis=1, keepdims=True)
        r1 = np.mean(np.sum(xc[:, 1:] * xc[:, :-1], axis=1)
                     / np.sum(xc * xc, axis=1))
        assert abs(r1 - 0.5) < 0.15


class TestBoundRandom:
    def test_bounded_support(self):
        d = pm.Bound(pm.Normal, lower=0.0).dist(mu=1.0, sigma=1.0)
        x = np.asarray(d.random(size=500))
        assert x.shape == (500,)
        assert x.min() >= 0.0

    def test_two_sided(self):
        d = pm.Bound(pm.Normal, lower=-1.0, upper=1.0).dist(mu=0.0,
                                                            sigma=5.0)
        x = np.asarray(d.random(size=500))
        assert x.min() >= -1.0 and x.max() <= 1.0


class TestExtraScipyAgreement:
    """KS-style two-sample agreement for the newly covered families."""

    def _ks(self, draws, cdf):
        stat = st.kstest(np.asarray(draws), cdf).pvalue
        assert stat > 1e-3, stat

    def test_gumbel(self):
        np.random.seed(0)
        self._ks(pm.Gumbel.dist(mu=1.0, beta=2.0).random(size=3000),
                 st.gumbel_r(loc=1.0, scale=2.0).cdf)

    def test_triangular(self):
        np.random.seed(0)
        self._ks(pm.Triangular.dist(lower=0.0, c=0.3, upper=1.0)
                 .random(size=3000),
                 st.triang(c=0.3, loc=0.0, scale=1.0).cdf)

    def test_weibull(self):
        np.random.seed(0)
        self._ks(pm.Weibull.dist(alpha=2.0, beta=1.5).random(size=3000),
                 st.weibull_min(c=2.0, scale=1.5).cdf)

    def test_wald(self):
        np.random.seed(0)
        self._ks(pm.Wald.dist(mu=2.0, lam=1.0).random(size=3000),
                 st.invgauss(mu=2.0, scale=1.0).cdf)

    def test_vonmises(self):
        np.random.seed(0)
        self._ks(pm.VonMises.dist(mu=0.5, kappa=2.0).random(size=3000),
                 st.vonmises(kappa=2.0, loc=0.5).cdf)

    def test_pareto(self):
        np.random.seed(0)
        self._ks(pm.Pareto.dist(alpha=3.0, m=2.0).random(size=3000),
                 st.pareto(b=3.0, scale=2.0).cdf)

    def test_betabinomial_moments(self):
        np.random.seed(0)
        x = np.asarray(pm.BetaBinomial.dist(alpha=2.0, beta=3.0, n=10)
                       .random(size=40000))
        np.testing.assert_allclose(x.mean(), 10 * 2.0 / 5.0, atol=0.1)


# ---------------------------------------------------------------------------
# round 5: 2-D dist_shape x size cells and further correctness pins
# (the remaining depth of the reference matrix,
#  /root/reference/pymc3/tests/test_distributions_random.py:1)
# ---------------------------------------------------------------------------
TWO_D_DISTS = [
    (pm.Normal, dict(mu=0.0, sigma=1.0)),
    (pm.Gamma, dict(alpha=2.0, beta=1.0)),
    (pm.Uniform, dict(lower=0.0, upper=1.0)),
    (pm.Binomial, dict(n=10, p=0.4)),
    (pm.Poisson, dict(mu=3.0)),
    (pm.Weibull, dict(alpha=2.0, beta=1.0)),
]


@pytest.mark.parametrize("dist_cls,params", TWO_D_DISTS,
                         ids=lambda d: getattr(d, "__name__", ""))
class Test2DShapeMatrix:
    def test_2d_dist_shape(self, dist_cls, params):
        d = dist_cls.dist(shape=(2, 5), **params)
        assert np.asarray(d.random()).shape == (2, 5)
        assert np.asarray(d.random(size=7)).shape == (7, 2, 5)
        assert np.asarray(d.random(size=(3, 7))).shape == (3, 7, 2, 5)

    def test_2d_params_implied_shape(self, dist_cls, params):
        """2-D parameter arrays imply the dist shape (reference
        ``test_parameters_stacked_shape`` semantics)."""
        arr = {k: np.asarray(v) * np.ones((2, 3),
                                          dtype=np.asarray(v).dtype)
               for k, v in params.items()}
        d = dist_cls.dist(shape=(2, 3), **arr)
        assert np.asarray(d.random()).shape == (2, 3)
        assert np.asarray(d.random(size=4)).shape == (4, 2, 3)


class TestMoreRandomMatchesScipy:
    """KS two-sample pins for families the earlier rounds left to shape
    checks only (cf. ``pymc3_random``, reference ``:58-77``)."""

    N = 4000

    def _ks(self, draws, ref_rvs):
        d = np.asarray(draws).ravel()
        r = np.asarray(ref_rvs).ravel()
        p = st.ks_2samp(d, r).pvalue
        assert p > 1e-4, p

    def test_weibull(self):
        np.random.seed(3)
        self._ks(pm.Weibull.dist(alpha=2.0, beta=1.5).random(size=self.N),
                 st.weibull_min.rvs(2.0, scale=1.5, size=self.N,
                                    random_state=1))

    def test_gumbel(self):
        np.random.seed(4)
        self._ks(pm.Gumbel.dist(mu=1.0, beta=2.0).random(size=self.N),
                 st.gumbel_r.rvs(1.0, 2.0, size=self.N, random_state=1))

    def test_triangular(self):
        np.random.seed(5)
        self._ks(pm.Triangular.dist(lower=-1.0, c=0.5, upper=2.0)
                 .random(size=self.N),
                 st.triang.rvs(0.5, -1.0, 3.0, size=self.N, random_state=1))

    def test_wald(self):
        np.random.seed(6)
        self._ks(pm.Wald.dist(mu=1.0, lam=2.0).random(size=self.N),
                 st.invgauss.rvs(0.5, scale=2.0, size=self.N,
                                 random_state=1))

    def test_skewnormal(self):
        np.random.seed(7)
        self._ks(pm.SkewNormal.dist(mu=0.0, sigma=1.0, alpha=-3.0)
                 .random(size=self.N),
                 st.skewnorm.rvs(-3.0, size=self.N, random_state=1))

    def test_vonmises(self):
        np.random.seed(8)
        self._ks(pm.VonMises.dist(mu=0.5, kappa=2.0).random(size=self.N),
                 st.vonmises.rvs(2.0, loc=0.5, size=self.N, random_state=1))

    def test_pareto(self):
        np.random.seed(9)
        self._ks(pm.Pareto.dist(alpha=3.0, m=1.0).random(size=self.N),
                 st.pareto.rvs(3.0, scale=1.0, size=self.N, random_state=1))

    def test_exgaussian(self):
        np.random.seed(10)
        self._ks(pm.ExGaussian.dist(mu=0.0, sigma=1.0, nu=2.0)
                 .random(size=self.N),
                 st.exponnorm.rvs(2.0, size=self.N, random_state=1))

    def test_betabinomial(self):
        np.random.seed(11)
        draws = np.asarray(pm.BetaBinomial.dist(alpha=2.0, beta=3.0, n=20)
                           .random(size=self.N))
        ref = st.betabinom.rvs(20, 2.0, 3.0, size=self.N, random_state=1)
        # chi-square on the discrete support (reference pymc3_random_discrete)
        obs = np.bincount(draws.astype(int), minlength=21)
        exp = np.bincount(ref, minlength=21)
        keep = (obs + exp) > 10
        chi2 = np.sum((obs[keep] - exp[keep]) ** 2 / (obs[keep] + exp[keep]))
        assert chi2 < 2.5 * keep.sum(), chi2

    def test_discrete_weibull_median(self):
        np.random.seed(12)
        d = pm.DiscreteWeibull.dist(q=0.8, beta=1.5)
        draws = np.asarray(d.random(size=self.N))
        # pmf-implied median equals the declared median default
        med = int(np.median(draws))
        assert abs(med - int(np.asarray(d.median.test_value))) <= 1
