"""Conjugate-ELBO matrix (cf. the reference's
``tests/test_variational_inference.py:457-716`` — exact MC-ELBO values,
total_size likelihood scaling, and the fit-method × full/minibatch
posterior grid)."""
import numpy as np
import pytest

import jax

import pymc3_tpu as pm
from pymc3_tpu import variational as v
from pymc3_tpu.variational.approximations import MeanField
from pymc3_tpu.variational.operators import KL


def _pinned_meanfield(model, post_mu, post_sigma):
    """MeanField q pinned at N(post_mu, post_sigma) like the reference's
    shared-param set_value calls (``test_variational_inference.py:474``)."""
    approx = MeanField(model=model)
    approx.params[0] = {
        "mu": np.asarray([post_mu], np.float32),
        "rho": np.asarray([np.log(np.exp(post_sigma) - 1)], np.float32),
    }
    return approx


class TestExactELBO:
    """``test_elbo`` (``test_variational_inference.py:457``) — the MC ELBO
    at a pinned q equals the closed form."""

    mu0, sigma = 1.5, 1.0
    y_obs = np.array([1.6, 1.4], np.float32)
    post_mu, post_sigma = 1.88, 1.0

    def _elbo_true(self, beta_lik=1.0):
        """Closed-form ELBO; ``beta_lik`` scales the likelihood term (the
        total_size case). For beta_lik=1 this is the reference's formula
        verbatim."""
        y, mu0, q_mu, q_sd = self.y_obs, self.mu0, self.post_mu, \
            self.post_sigma
        # E_q[logp(y|mu)] with q = N(q_mu, q_sd)
        e_lik = sum(-0.5 * (np.log(2 * np.pi) + (yi - q_mu) ** 2 + q_sd ** 2)
                    for yi in y)
        e_prior = -0.5 * (np.log(2 * np.pi) + (q_mu - mu0) ** 2 + q_sd ** 2)
        entropy = 0.5 * (np.log(2 * np.pi) + 1.0) + np.log(q_sd)
        return beta_lik * e_lik + e_prior + entropy

    def test_elbo(self):
        with pm.Model() as model:
            mu = pm.Normal("mu", mu=self.mu0, sigma=self.sigma)
            pm.Normal("y", mu=mu, sigma=1.0, observed=self.y_obs)
        approx = _pinned_meanfield(model, self.post_mu, self.post_sigma)
        loss = KL(approx)().loss_fn(10000)
        elbo_mc = -float(loss(approx.params, jax.random.PRNGKey(0)))
        np.testing.assert_allclose(elbo_mc, self._elbo_true(), atol=1e-1)

    @pytest.mark.parametrize("total_size", [2, 5, 8])
    def test_elbo_total_size_scales_likelihood(self, total_size):
        """``test_elbo_beta_kl`` (``test_variational_inference.py:541``):
        total_size multiplies only the likelihood term by N/batch."""
        with pm.Model() as model:
            mu = pm.Normal("mu", mu=self.mu0, sigma=self.sigma)
            pm.Normal("y", mu=mu, sigma=1.0, observed=self.y_obs,
                      total_size=total_size)
        approx = _pinned_meanfield(model, self.post_mu, self.post_sigma)
        loss = KL(approx)().loss_fn(10000)
        elbo_mc = -float(loss(approx.params, jax.random.PRNGKey(0)))
        beta = total_size / float(len(self.y_obs))
        np.testing.assert_allclose(elbo_mc, self._elbo_true(beta_lik=beta),
                                   atol=2e-1)


class TestFitMethodGrid:
    """``test_fit_oo`` (``test_variational_inference.py:705``): every fit
    method recovers the conjugate posterior, full-data and minibatched."""

    N = 1000
    sigma0, mu0, sigma, mu_true = 2.0, 4.0, 3.0, -5.0

    @classmethod
    def setup_class(cls):
        rng = np.random.RandomState(42)
        cls.data = (cls.sigma * rng.randn(cls.N) + cls.mu_true).astype(
            np.float32)
        d = cls.N / cls.sigma ** 2 + 1 / cls.sigma0 ** 2
        cls.mu_post = (cls.N * np.mean(cls.data) / cls.sigma ** 2 +
                       cls.mu0 / cls.sigma0 ** 2) / d
        cls.sd_post = np.sqrt(1.0 / d)

    def _model(self, use_minibatch):
        obs = pm.Minibatch(self.data, batch_size=128) if use_minibatch \
            else self.data
        with pm.Model() as model:
            mu_ = pm.Normal("mu", mu=self.mu0, sigma=self.sigma0, testval=0)
            pm.Normal("x", mu=mu_, sigma=self.sigma, observed=obs,
                      total_size=self.N)
        return model

    # (method string, fit kwargs, mean rtol multiplier, check sd)
    GRID = [
        ("advi", dict(n=4000, obj_n_mc=3,
                      obj_optimizer=None), 0.05, True),
        ("fullrank_advi", dict(n=4000, obj_n_mc=3,
                               obj_optimizer=None), 0.05, True),
        ("svgd", dict(n=300, inf_kwargs={"n_particles": 100},
                      obj_optimizer=None), 0.2, False),
        ("asvgd", dict(n=500, obj_n_mc=50,
                       obj_optimizer=None), 0.2, False),
        ("nfvi=scale-loc", dict(n=4000,
                                obj_optimizer=None), 0.05, True),
    ]

    @pytest.mark.parametrize("use_minibatch", [False, True],
                             ids=["full", "mini"])
    @pytest.mark.parametrize("method,kwargs,tol,check_sd", GRID,
                             ids=[g[0] for g in GRID])
    def test_fit_recovers_posterior(self, method, kwargs, tol, check_sd,
                                    use_minibatch):
        kwargs = dict(kwargs)
        if kwargs.get("obj_optimizer") is None:
            kwargs["obj_optimizer"] = v.updates.adam(
                learning_rate=0.1 if "svgd" in method else 0.05)
        model = self._model(use_minibatch)
        approx = v.fit(method=method, model=model, random_seed=1,
                       progressbar=False, **kwargs)
        mean = float(np.asarray(approx.mean)[0])
        # |q_mu - mu_post| relative to the posterior location scale
        assert abs(mean - self.mu_post) < tol * abs(self.mu_post) + 0.2, \
            (method, mean, self.mu_post)
        if check_sd and not use_minibatch:
            sd = float(np.asarray(approx.std)[0])
            np.testing.assert_allclose(sd, self.sd_post, rtol=0.5)

    def test_trace_moments_advi(self):
        """The sampled trace (not just the params) matches the conjugate
        posterior — the reference's actual assertion
        (``test_variational_inference.py:709-713``)."""
        model = self._model(False)
        approx = v.fit(n=4000, method="advi", model=model, random_seed=1,
                       progressbar=False, obj_n_mc=3,
                       obj_optimizer=v.updates.adam(learning_rate=0.05))
        trace = approx.sample(10000)
        np.testing.assert_allclose(np.mean(trace["mu"]), self.mu_post,
                                   rtol=0.05)
        np.testing.assert_allclose(np.std(trace["mu"]), self.sd_post,
                                   rtol=0.4)

    def test_run_profiling(self):
        """``test_profile`` (``test_variational_inference.py:715``)."""
        model = self._model(False)
        with model:
            inf = v.ADVI()
        inf.run_profiling(n=100)
