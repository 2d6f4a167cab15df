"""GP math-vs-hand-cholesky matrix (cf. the reference's ``tests/test_gp.py``
— classes that had no test before: WarpedInput/Gibbs/ScaledCov/
Coregion numeric pins, Marginal-vs-Latent logp, sparse approximations
vs exact, TP at high nu, LatentKron/MarginalKron vs their dense
counterparts)."""
import numpy as np
import numpy.testing as npt
import pytest

import jax.numpy as jnp

import pymc3_tpu as pm
from pymc3_tpu.node import evaluate
from pymc3_tpu.math import cartesian


def _eval(node):
    return np.asarray(evaluate(node, {}))


class TestWarpedInput:
    """cf. ``test_gp.py:533`` — same numeric pin."""

    def test_1d(self):
        X = np.linspace(0, 1, 10)[:, None]

        def warp_func(x, a, b, c):
            return x + (a * jnp.tanh(b * (x - c)))

        cov_m52 = pm.gp.cov.Matern52(1, 0.2)
        cov = pm.gp.cov.WarpedInput(1, warp_func=warp_func, args=(1, 10, 1),
                                    cov_func=cov_m52)
        K = _eval(cov(X))
        npt.assert_allclose(K[0, 1], 0.79593, atol=1e-3)
        K2 = _eval(cov(X, X))
        npt.assert_allclose(K2[0, 1], 0.79593, atol=1e-3)
        Kd = _eval(cov(X, diag=True))
        npt.assert_allclose(np.diag(K), Kd, atol=1e-5)

    def test_raises(self):
        cov_m52 = pm.gp.cov.Matern52(1, 0.2)
        with pytest.raises(TypeError):
            pm.gp.cov.WarpedInput(1, cov_m52, "str is not callable")
        with pytest.raises(TypeError):
            pm.gp.cov.WarpedInput(1, "str is not a Covariance", lambda x: x)


class TestGibbs:
    """cf. ``test_gp.py:557`` — same numeric pin."""

    def test_1d(self):
        X = np.linspace(0, 2, 10)[:, None]

        def tanh_func(x, x1, x2, w, x0):
            return (x1 + x2) / 2.0 - (x1 - x2) / 2.0 * jnp.tanh((x - x0) / w)

        cov = pm.gp.cov.Gibbs(1, tanh_func, args=(0.05, 0.6, 0.4, 1.0))
        K = _eval(cov(X))
        npt.assert_allclose(K[2, 3], 0.136683, atol=1e-4)
        K2 = _eval(cov(X, X))
        npt.assert_allclose(K2[2, 3], 0.136683, atol=1e-4)
        Kd = _eval(cov(X, diag=True))
        npt.assert_allclose(np.diag(K), Kd, atol=1e-5)

    def test_raises(self):
        with pytest.raises(TypeError):
            pm.gp.cov.Gibbs(1, "str is not callable")
        with pytest.raises(NotImplementedError):
            pm.gp.cov.Gibbs(3, lambda x: x, active_dims=[0, 1])


class TestScaledCov:
    """cf. ``test_gp.py:581`` — same numeric pin."""

    def test_1d(self):
        X = np.linspace(0, 1, 10)[:, None]

        def scaling_func(x, a, b):
            return a + b * x

        cov_m52 = pm.gp.cov.Matern52(1, 0.2)
        cov = pm.gp.cov.ScaledCov(1, scaling_func=scaling_func, args=(2, -1),
                                  cov_func=cov_m52)
        K = _eval(cov(X))
        npt.assert_allclose(K[0, 1], 3.00686, atol=1e-3)
        K2 = _eval(cov(X, X))
        npt.assert_allclose(K2[0, 1], 3.00686, atol=1e-3)
        Kd = _eval(cov(X, diag=True))
        npt.assert_allclose(np.diag(K), Kd, atol=1e-5)

    def test_raises(self):
        cov_m52 = pm.gp.cov.Matern52(1, 0.2)
        with pytest.raises(TypeError):
            pm.gp.cov.ScaledCov(1, cov_m52, "str is not callable")
        with pytest.raises(TypeError):
            pm.gp.cov.ScaledCov(1, "str is not a Covariance", lambda x: x)


class TestCoregion:
    """cf. ``test_gp.py:624``."""

    def setup_method(self):
        rng = np.random.RandomState(11)
        self.nrows, self.ncols = 6, 3
        self.W = rng.rand(self.nrows, self.ncols)
        self.kappa = rng.rand(self.nrows)
        self.B = self.W @ self.W.T + np.diag(self.kappa)
        self.rand_rows = rng.randint(0, self.nrows, size=(20, 1))
        self.rand_cols = rng.randint(0, self.ncols, size=(10, 1))
        self.X = np.concatenate((self.rand_rows, rng.rand(20, 1)), axis=1)
        self.Xs = np.concatenate((self.rand_cols, rng.rand(10, 1)), axis=1)

    def test_full(self):
        B_mat = self.B[self.rand_rows, self.rand_rows.T]
        B = pm.gp.cov.Coregion(2, W=self.W, kappa=self.kappa,
                               active_dims=[0])
        npt.assert_allclose(_eval(B(np.array([[2, 1.5], [3, -42]]))),
                            self.B[2:4, 2:4], rtol=1e-5)
        npt.assert_allclose(_eval(B(self.X)), B_mat, rtol=1e-5)

    def test_fullB(self):
        B_mat = self.B[self.rand_rows, self.rand_rows.T]
        B = pm.gp.cov.Coregion(1, B=self.B)
        npt.assert_allclose(_eval(B(np.array([[2], [3]]))),
                            self.B[2:4, 2:4], rtol=1e-5)
        npt.assert_allclose(_eval(B(self.X)), B_mat, rtol=1e-5)

    def test_Xs(self):
        B_mat = self.B[self.rand_rows, self.rand_cols.T]
        B = pm.gp.cov.Coregion(2, W=self.W, kappa=self.kappa,
                               active_dims=[0])
        npt.assert_allclose(
            _eval(B(np.array([[2, 1.5]]), np.array([[3, -42]]))),
            self.B[2, 3], rtol=1e-5)
        npt.assert_allclose(_eval(B(self.X, self.Xs)), B_mat, rtol=1e-5)

    def test_diag(self):
        B_diag = np.diag(self.B)[self.rand_rows.ravel()]
        B = pm.gp.cov.Coregion(2, W=self.W, kappa=self.kappa,
                               active_dims=[0])
        npt.assert_allclose(_eval(B(np.array([[2, 1.5]]), diag=True)),
                            np.diag(self.B)[2], rtol=1e-5)
        npt.assert_allclose(_eval(B(self.X, diag=True)), B_diag, rtol=1e-5)

    def test_raises(self):
        with pytest.raises(ValueError):
            pm.gp.cov.Coregion(2, W=self.W, kappa=self.kappa)  # 2 active
        with pytest.raises(ValueError):
            pm.gp.cov.Coregion(1, W=self.W, kappa=self.kappa, B=self.B)
        with pytest.raises(ValueError):
            pm.gp.cov.Coregion(1)


class TestMarginalVsLatent:
    """Marginal with noise=0 must equal Latent in logp
    (cf. ``test_gp.py:692``)."""

    def setup_method(self):
        rng = np.random.RandomState(5)
        self.X = rng.randn(30, 3)
        self.y = rng.randn(30) * 0.01
        self.Xnew = rng.randn(20, 3)
        self.pnew = rng.randn(20) * 0.01
        with pm.Model() as model:
            cov_func = pm.gp.cov.ExpQuad(3, [0.1, 0.2, 0.3])
            mean_func = pm.gp.mean.Constant(0.5)
            gp = pm.gp.Marginal(mean_func, cov_func)
            gp.marginal_likelihood("f", self.X, self.y, noise=0.0,
                                   is_observed=False)
            gp.conditional("p", self.Xnew)
        self.logp = model.logp({**model.test_point, "f": self.y,
                                "p": self.pnew})

    def testLatent1(self):
        with pm.Model() as model:
            cov_func = pm.gp.cov.ExpQuad(3, [0.1, 0.2, 0.3])
            mean_func = pm.gp.mean.Constant(0.5)
            gp = pm.gp.Latent(mean_func, cov_func)
            gp.prior("f", self.X, reparameterize=False)
            gp.conditional("p", self.Xnew)
        latent_logp = model.logp({**model.test_point, "f": self.y,
                                  "p": self.pnew})
        npt.assert_allclose(latent_logp, self.logp, atol=0, rtol=1e-2)

    def testLatent2(self):
        with pm.Model() as model:
            cov_func = pm.gp.cov.ExpQuad(3, [0.1, 0.2, 0.3])
            mean_func = pm.gp.mean.Constant(0.5)
            gp = pm.gp.Latent(mean_func, cov_func)
            gp.prior("f", self.X, reparameterize=True)
            gp.conditional("p", self.Xnew)
        from pymc3_tpu.gp.util import stabilize
        chol = np.linalg.cholesky(
            _eval(stabilize(cov_func(self.X))).astype(np.float64))
        y_rotated = np.linalg.solve(chol, self.y - 0.5)
        latent_logp = model.logp({**model.test_point,
                                  "f_rotated_": y_rotated, "p": self.pnew})
        npt.assert_allclose(latent_logp, self.logp, atol=5)


class TestMarginalVsMarginalSparse:
    """Sparse approximations with Xu=X must match the exact marginal
    (cf. ``test_gp.py:736``)."""

    def setup_method(self):
        rng = np.random.RandomState(6)
        self.X = rng.randn(30, 3)
        self.y = rng.randn(30) * 0.01
        self.Xnew = rng.randn(20, 3)
        self.pnew = rng.randn(20) * 0.01
        self.sigma = 0.1
        with pm.Model() as model:
            cov_func = pm.gp.cov.ExpQuad(3, [0.1, 0.2, 0.3])
            mean_func = pm.gp.mean.Constant(0.5)
            self.gp = pm.gp.Marginal(mean_func, cov_func)
            self.gp.marginal_likelihood("f", self.X, self.y,
                                        noise=self.sigma)
            self.gp.conditional("p", self.Xnew)
        self.logp = model.logp({**model.test_point, "p": self.pnew})

    @pytest.mark.parametrize("approx", ["FITC", "VFE", "DTC"])
    def testApproximations(self, approx):
        with pm.Model() as model:
            cov_func = pm.gp.cov.ExpQuad(3, [0.1, 0.2, 0.3])
            mean_func = pm.gp.mean.Constant(0.5)
            gp = pm.gp.MarginalSparse(mean_func, cov_func, approx=approx)
            gp.marginal_likelihood("f", self.X, self.X, self.y, self.sigma)
            gp.conditional("p", self.Xnew)
        approx_logp = model.logp({**model.test_point, "p": self.pnew})
        # VFE's trace penalty -(0.5/s^2)(trK - trQ) picks up the cholesky
        # jitter bias ~ 0.5*n*jitter/s^2 (=0.75 at the float32 jitter
        # 5e-4, gp/util.py:22) that the float64 reference never sees
        npt.assert_allclose(approx_logp, self.logp,
                            atol=1.0 if approx == "VFE" else 0.0,
                            rtol=1e-2)

    @pytest.mark.parametrize("approx", ["FITC", "VFE", "DTC"])
    def testPredictVar(self, approx):
        with pm.Model() as model:
            cov_func = pm.gp.cov.ExpQuad(3, [0.1, 0.2, 0.3])
            mean_func = pm.gp.mean.Constant(0.5)
            gp = pm.gp.MarginalSparse(mean_func, cov_func, approx=approx)
            gp.marginal_likelihood("f", self.X, self.X, self.y, self.sigma)
            mu1, var1 = self.gp.predict(self.Xnew, diag=True)
            mu2, var2 = gp.predict(self.Xnew, diag=True)
        npt.assert_allclose(mu1, mu2, atol=1e-3)
        npt.assert_allclose(var1, var2, atol=1e-3)

    def testPredictCov(self):
        with pm.Model() as model:
            cov_func = pm.gp.cov.ExpQuad(3, [0.1, 0.2, 0.3])
            mean_func = pm.gp.mean.Constant(0.5)
            gp = pm.gp.MarginalSparse(mean_func, cov_func, approx="DTC")
            gp.marginal_likelihood("f", self.X, self.X, self.y, self.sigma,
                                   is_observed=False)
            mu1, cov1 = self.gp.predict(self.Xnew, pred_noise=True)
            mu2, cov2 = gp.predict(self.Xnew, pred_noise=True)
        npt.assert_allclose(mu1, mu2, atol=1e-3)
        npt.assert_allclose(cov1, cov2, atol=1e-3)


class TestTP:
    """TP at nu=10000 approaches the GP (cf. ``test_gp.py:913``)."""

    def setup_method(self):
        rng = np.random.RandomState(9)
        self.X = rng.randn(15, 3)
        self.y = rng.randn(15) * 0.01
        self.Xnew = rng.randn(20, 3)
        self.pnew = rng.randn(20) * 0.01
        with pm.Model() as model:
            cov_func = pm.gp.cov.ExpQuad(3, [0.1, 0.2, 0.3])
            gp = pm.gp.Latent(cov_func=cov_func)
            gp.prior("f", self.X, reparameterize=False)
            gp.conditional("p", self.Xnew)
        self.latent_logp = model.logp({**model.test_point, "f": self.y,
                                       "p": self.pnew})

    def testTPvsLatent(self):
        with pm.Model() as model:
            cov_func = pm.gp.cov.ExpQuad(3, [0.1, 0.2, 0.3])
            tp = pm.gp.TP(cov_func=cov_func, nu=10000)
            tp.prior("f", self.X, reparameterize=False)
            tp.conditional("p", self.Xnew)
        tp_logp = model.logp({**model.test_point, "f": self.y,
                              "p": self.pnew})
        npt.assert_allclose(self.latent_logp, tp_logp, atol=0, rtol=1e-2)

    def testAdditiveTPRaises(self):
        with pm.Model():
            cov_func = pm.gp.cov.ExpQuad(3, [0.1, 0.2, 0.3])
            gp1 = pm.gp.TP(cov_func=cov_func, nu=10)
            gp2 = pm.gp.TP(cov_func=cov_func, nu=10)
            with pytest.raises(Exception):
                gp1 + gp2


class TestLatentKron:
    """LatentKron == Latent with the dense Kron covariance
    (cf. ``test_gp.py:964``)."""

    def setup_method(self):
        rng = np.random.RandomState(13)
        self.Xs = [np.linspace(0, 1, 5)[:, None],
                   np.linspace(0, 1, 4)[:, None],
                   np.linspace(0, 1, 3)[:, None]]
        self.X = cartesian(*self.Xs)
        self.N = int(np.prod([len(X) for X in self.Xs]))
        self.y = rng.randn(self.N) * 0.1
        self.Xnew = np.concatenate([rng.randn(5, 1) for _ in range(3)],
                                   axis=1)
        self.pnew = rng.randn(len(self.Xnew)) * 0.01
        ls = 0.2
        self.cov_funcs = (pm.gp.cov.ExpQuad(1, ls),
                          pm.gp.cov.ExpQuad(1, ls),
                          pm.gp.cov.ExpQuad(1, ls))
        self.mean = pm.gp.mean.Constant(0.5)
        with pm.Model() as latent_model:
            cov_func = pm.gp.cov.Kron(self.cov_funcs)
            gp = pm.gp.Latent(mean_func=self.mean, cov_func=cov_func)
            gp.prior("f", self.X)
            gp.conditional("p", self.Xnew)
        from pymc3_tpu.gp.util import stabilize
        chol = np.linalg.cholesky(
            _eval(stabilize(cov_func(self.X))).astype(np.float64))
        self.y_rotated = np.linalg.solve(chol, self.y - 0.5)
        self.logp = latent_model.logp({**latent_model.test_point,
                                       "f_rotated_": self.y_rotated,
                                       "p": self.pnew})

    def testLatentKronvsLatent(self):
        with pm.Model() as kron_model:
            kron_gp = pm.gp.LatentKron(mean_func=self.mean,
                                       cov_funcs=self.cov_funcs)
            kron_gp.prior("f", self.Xs)
            kron_gp.conditional("p", self.Xnew)
        kron_logp = kron_model.logp({**kron_model.test_point,
                                     "f_rotated_": self.y_rotated,
                                     "p": self.pnew})
        npt.assert_allclose(kron_logp, self.logp, atol=0, rtol=1e-3)

    def testLatentKronRaisesAdditive(self):
        gp1 = pm.gp.LatentKron(mean_func=self.mean,
                               cov_funcs=self.cov_funcs)
        gp2 = pm.gp.LatentKron(mean_func=self.mean,
                               cov_funcs=self.cov_funcs)
        with pytest.raises(TypeError):
            gp1 + gp2

    def testLatentKronRaisesSizes(self):
        with pm.Model():
            gp = pm.gp.LatentKron(mean_func=self.mean,
                                  cov_funcs=self.cov_funcs)
            with pytest.raises(ValueError):
                gp.prior("f", Xs=[np.linspace(0, 1, 7)[:, None],
                                  np.linspace(0, 1, 5)[:, None]])


class TestMarginalKron:
    """MarginalKron == Marginal with the dense Kron covariance
    (cf. ``test_gp.py:1021``)."""

    def setup_method(self):
        rng = np.random.RandomState(14)
        self.Xs = [np.linspace(0, 1, 5)[:, None],
                   np.linspace(0, 1, 4)[:, None],
                   np.linspace(0, 1, 3)[:, None]]
        self.X = cartesian(*self.Xs)
        self.N = int(np.prod([len(X) for X in self.Xs]))
        self.y = rng.randn(self.N) * 0.1
        self.Xnew = np.concatenate([rng.randn(5, 1) for _ in range(3)],
                                   axis=1)
        self.sigma = 0.2
        self.pnew = rng.randn(len(self.Xnew)) * 0.01
        ls = 0.2
        self.cov_funcs = [pm.gp.cov.ExpQuad(1, ls),
                          pm.gp.cov.ExpQuad(1, ls),
                          pm.gp.cov.ExpQuad(1, ls)]
        self.mean = pm.gp.mean.Constant(0.5)
        with pm.Model() as model:
            cov_func = pm.gp.cov.Kron(self.cov_funcs)
            gp = pm.gp.Marginal(mean_func=self.mean, cov_func=cov_func)
            gp.marginal_likelihood("f", self.X, self.y, noise=self.sigma)
            gp.conditional("p", self.Xnew)
            self.mu, self.cov = gp.predict(self.Xnew)
        self.logp = model.logp({**model.test_point, "p": self.pnew})

    def testMarginalKronvsMarginalpredict(self):
        with pm.Model():
            kron_gp = pm.gp.MarginalKron(mean_func=self.mean,
                                         cov_funcs=self.cov_funcs)
            kron_gp.marginal_likelihood("f", self.Xs, self.y,
                                        sigma=self.sigma, shape=self.N)
            kron_gp.conditional("p", self.Xnew)
            mu, cov = kron_gp.predict(self.Xnew)
        npt.assert_allclose(mu, self.mu, atol=0.01, rtol=1e-2)
        npt.assert_allclose(cov, self.cov, atol=0.01, rtol=1e-2)

    def testMarginalKronvsMarginal(self):
        with pm.Model() as kron_model:
            kron_gp = pm.gp.MarginalKron(mean_func=self.mean,
                                         cov_funcs=self.cov_funcs)
            kron_gp.marginal_likelihood("f", self.Xs, self.y,
                                        sigma=self.sigma, shape=self.N)
            kron_gp.conditional("p", self.Xnew)
        kron_logp = kron_model.logp({**kron_model.test_point,
                                     "p": self.pnew})
        npt.assert_allclose(kron_logp, self.logp, atol=0, rtol=1e-2)

    def testMarginalKronRaises(self):
        gp1 = pm.gp.MarginalKron(mean_func=self.mean,
                                 cov_funcs=self.cov_funcs)
        gp2 = pm.gp.MarginalKron(mean_func=self.mean,
                                 cov_funcs=self.cov_funcs)
        with pytest.raises(TypeError):
            gp1 + gp2
