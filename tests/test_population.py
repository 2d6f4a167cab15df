"""Population-sampler matrix (cf. ``tests/test_step.py:709`` —
``TestPopulationSamplers``): size validation, warning on small
populations, tune-parameter validation, chain distinctness, and the
posterior-correctness check."""
import numpy as np
import pytest

import pymc3_tpu as pm

from . import models


class TestPopulationSamplers:
    steppers = [pm.DEMetropolis]

    def test_checks_population_size(self):
        """``test_step.py:713``."""
        with pm.Model() as model:
            pm.Normal("n", mu=0, sigma=1)
            for stepper in self.steppers:
                step = stepper()
                with pytest.raises(ValueError, match="at least 3 chains"):
                    pm.sample(draws=10, tune=10, chains=1, step=step,
                              progressbar=False,
                              compute_convergence_checks=False)
                pm.sample(draws=10, tune=10, chains=4, step=step,
                          progressbar=False, random_seed=1,
                          compute_convergence_checks=False)

    def test_demcmc_warning_on_small_populations(self):
        """``test_step.py:725``."""
        with pm.Model():
            pm.Normal("n", mu=0, sigma=1, shape=(2, 3))
            with pytest.warns(UserWarning, match="more chains than"):
                pm.sample(draws=5, tune=5, chains=6, step=pm.DEMetropolis(),
                          progressbar=False, random_seed=1,
                          compute_convergence_checks=False)

    def test_demcmc_tune_parameter(self):
        """``test_step.py:738``."""
        with pm.Model():
            pm.Normal("n", mu=0, sigma=1, shape=(2, 3))
            step = pm.DEMetropolis()
            assert step.tune_target is None
            step = pm.DEMetropolis(tune="scaling")
            assert step.tune_target == "scaling"
            step = pm.DEMetropolis(tune="lambda")
            assert step.tune_target == "lambda"
            with pytest.raises(ValueError):
                pm.DEMetropolis(tune="foo")

    def test_chains_are_random(self):
        """``test_step.py:754`` — population chains must not collapse to
        identical trajectories (all chains advance in one device array
        here, so this guards the per-chain crossover/accept RNG split)."""
        with pm.Model():
            pm.Normal("x", 0, 1)
            trace = pm.sample(chains=4, draws=20, tune=0,
                              step=pm.DEMetropolis(), progressbar=False,
                              random_seed=1,
                              compute_convergence_checks=False)
        samples = np.array(trace.get_values("x", combine=False))[:, 5]
        assert len(set(samples)) == 4

    def test_posterior_correct(self):
        """The posterior check: DEMetropolis
        with a healthy population recovers a known Gaussian posterior."""
        start, model, (mu_true, sd_true) = models.simple_model()
        with model:
            trace = pm.sample(chains=32, draws=2000, tune=1000,
                              step=pm.DEMetropolis(), progressbar=False,
                              random_seed=4,
                              compute_convergence_checks=False)
        x = np.asarray(trace["x"]).reshape(-1, 2)
        np.testing.assert_allclose(x.mean(axis=0), mu_true, atol=0.15)
        np.testing.assert_allclose(x.std(axis=0), sd_true, rtol=0.1)
        rhat = pm.rhat(trace, var_names=["x"])["x"]
        assert float(np.max(np.asarray(rhat))) < 1.05

    def test_demetropolis_z_posterior(self):
        """DEMetropolisZ (history-based, non-population) on the same
        target (cf. ``test_step.py:803``)."""
        start, model, (mu_true, sd_true) = models.simple_model()
        with model:
            trace = pm.sample(chains=4, draws=3000, tune=1000,
                              step=pm.DEMetropolisZ(), progressbar=False,
                              random_seed=4,
                              compute_convergence_checks=False)
        x = np.asarray(trace["x"]).reshape(-1, 2)
        np.testing.assert_allclose(x.mean(axis=0), mu_true, atol=0.15)
        np.testing.assert_allclose(x.std(axis=0), sd_true, rtol=0.15)
