"""Smoke tests for packaged example models (cf.
``pymc3/tests/test_examples.py``): build, check the test point is finite,
and run a short sample."""
import numpy as np
import pytest

import pymc3_tpu as pm


def _finite_test_point(model):
    pt = model.check_test_point()
    assert np.all(np.isfinite(np.asarray(pt.values, dtype=np.float64))), pt


def test_gelman_bioassay():
    from pymc3_tpu.examples.gelman_bioassay import build_model
    model = build_model()
    _finite_test_point(model)
    with model:
        trace = pm.sample(draws=150, tune=150, chains=2, progressbar=False,
                          random_seed=1, compute_convergence_checks=False)
    # theta rates are increasing in dose on average (monotone logit-linear)
    theta = np.asarray(trace["theta"]).reshape(-1, 4).mean(axis=0)
    assert np.all(np.diff(theta) > 0)
    assert float(np.asarray(trace["beta"]).mean()) > 0


def test_lasso_missing_imputation():
    """End-to-end imputation: masked Bernoulli/Poisson predictors become
    free RVs sampled by the compound step (model.py:231-301)."""
    from pymc3_tpu.examples.lasso_missing import build_model
    model = build_model()
    _finite_test_point(model)
    # siblings has no NaNs in the dataset, so only these two impute
    missing_names = {v.name for v in model.free_RVs if "missing" in v.name}
    assert {"disability_imp_missing", "mother_imp_missing"} <= missing_names
    with model:
        trace = pm.sample(draws=60, tune=60, chains=1, progressbar=False,
                          random_seed=1, compute_convergence_checks=False)
    imputed = np.asarray(trace["disability_imp_missing"])
    assert set(np.unique(imputed)) <= {0.0, 1.0}
    # imputed trace actually mixes (not frozen at init)
    assert np.unique(np.asarray(trace["mother_imp_missing"]).sum(1)).size > 1


def test_factor_potential():
    from pymc3_tpu.examples.factor_potential import build_model
    model = build_model()
    _finite_test_point(model)
    with model:
        trace = pm.sample(draws=300, tune=300, chains=2, progressbar=False,
                          random_seed=1, compute_convergence_checks=False)
    # N(1,1) x exp(-x^2) => posterior N(1/3, 1/3)
    x = np.asarray(trace["x"])
    assert abs(x.mean() - 1.0 / 3.0) < 0.1
    assert abs(x.var() - 1.0 / 3.0) < 0.1


def test_custom_dists():
    from pymc3_tpu.examples.custom_dists import build_model, theta_true
    model = build_model()
    _finite_test_point(model)
    with model:
        trace = pm.sample(draws=300, tune=400, chains=2, progressbar=False,
                          random_seed=1, compute_convergence_checks=False)
    assert abs(float(np.asarray(trace["slope"]).mean())
               - theta_true[1]) < 0.4


def test_rankdata_ordered():
    from pymc3_tpu.examples.rankdata_ordered import build_model, yreal, K
    model = build_model()
    _finite_test_point(model)
    with model:
        trace = pm.sample(draws=150, tune=300, chains=1, progressbar=False,
                          random_seed=1, compute_convergence_checks=False)
    latentmu = np.hstack(
        [[0], np.asarray(trace["mu_hat"]).reshape(-1, K - 1).mean(0)])
    # adjacent items are confusable at noise sd 1 (the reference example
    # asserts nothing); require the unambiguous extremes to be recovered
    order = list(np.argsort(latentmu))
    true = list(yreal.flatten())
    assert order[0] == true[0] and order[-1] == true[-1], (order, true)


# ---------------------------------------------------------------------------
# round 5: every example module runs end-to-end (cf. the
# reference's tests/test_examples.py:1 breadth)
# ---------------------------------------------------------------------------

def _sample_short(model, draws=150, tune=200, chains=2, **kw):
    with model:
        return pm.sample(draws=draws, tune=tune, chains=chains,
                         progressbar=False, random_seed=1,
                         compute_convergence_checks=False, **kw)


def test_disaster_model_compound_discrete():
    """Discrete switchpoint (Metropolis) compounds with NUTS on the rates
    — the reference's canonical CompoundStep path."""
    from pymc3_tpu.examples.disaster_model import build_model
    trace = _sample_short(build_model(), draws=300, tune=300)
    early = trace["early_mean"].mean()
    late = trace["late_mean"].mean()
    sp = np.asarray(trace["switchpoint"])
    assert early > late  # disasters dropped after the switch
    assert 2.0 < early < 4.5 and 0.5 < late < 1.5
    assert 30 <= np.median(sp) <= 50  # true changepoint ~ year 40

def test_arma_example():
    from pymc3_tpu.examples.arma_example import build_model
    trace = _sample_short(build_model(), nuts={"target_accept": 0.9})
    assert np.isfinite(trace["mu"]).all()
    assert 0 < trace["sigma"].mean() < 2.0

def test_garch_example():
    from pymc3_tpu.examples.garch_example import build_model
    trace = _sample_short(build_model())
    a1 = trace["alpha1"]
    assert np.all(a1 >= 0) and np.all(a1 <= 1)
    assert 0 < trace["omega"].mean() < 10

def test_stochastic_volatility():
    from pymc3_tpu.examples.stochastic_volatility import build_model
    trace = _sample_short(build_model(n_obs=200), draws=100, tune=200,
                          nuts={"target_accept": 0.9})
    assert trace["s"].shape[1] == 200
    assert np.isfinite(trace["s"]).all()
    assert np.all(trace["nu"] > 0)

def test_lkj_correlation():
    from pymc3_tpu.examples.LKJ_correlation import build_model, mu_actual
    trace = _sample_short(build_model(), draws=200, tune=300,
                          nuts={"target_accept": 0.9})
    mu_post = trace["mu"].mean(axis=0)
    np.testing.assert_allclose(mu_post, mu_actual, atol=0.5)
    # L is a valid Cholesky factor: positive diagonal
    L = trace["L"]
    assert np.all(L[:, np.arange(3), np.arange(3)] > 0)

def test_baseball():
    from pymc3_tpu.examples.baseball import build_model
    trace = _sample_short(build_model(), draws=200, tune=300,
                          nuts={"target_accept": 0.9})
    phi = trace["phi"].mean()
    assert 0.15 < phi < 0.35  # league-average batting
    assert trace["thetas"].shape[1] == 18

def test_censored_data():
    from pymc3_tpu.examples.censored_data import build_model
    trace = _sample_short(build_model(), draws=200, tune=300)
    # recovers N(1.0, 1.5) despite censoring at [-1, 3]
    assert abs(trace["mu"].mean() - 1.0) < 0.4
    assert abs(trace["sigma"].mean() - 1.5) < 0.5

def test_arbitrary_stochastic_densitydist():
    from pymc3_tpu.examples.arbitrary_stochastic import build_model
    trace = _sample_short(build_model(), draws=300, tune=300)
    v = trace["custom"]
    assert np.isfinite(v).all()
    assert abs(np.median(v)) < 0.5  # symmetric target

def test_gelman_schools():
    from pymc3_tpu.examples.gelman_schools import build_model
    trace = _sample_short(build_model(), draws=300, tune=300, chains=4,
                          nuts={"target_accept": 0.9})
    assert -5 < trace["mu"].mean() < 15
    assert np.all(trace["tau"] > 0)
    assert trace["theta"].shape[1] == 8

def test_glm_hierarchical_radon():
    from pymc3_tpu.examples.glm_hierarchical import build_model
    trace = _sample_short(build_model(), draws=100, tune=200)
    # radon floor effect is negative (basement readings higher)
    assert trace["b"].mean() < 0

def test_gp_example():
    from pymc3_tpu.examples.gp_example import make_data, build_marginal
    X, y = make_data(n=40)
    model, gp = build_marginal(X, y)
    trace = _sample_short(model, draws=100, tune=150,
                          nuts={"target_accept": 0.9})
    assert np.all(np.asarray(trace["ls"]) > 0)

def test_lightspeed():
    from pymc3_tpu.examples.lightspeed_example import build_model
    trace = _sample_short(build_model(), draws=300, tune=300)
    assert abs(trace["beta"].mean() - 26.2) < 2.0

def test_minibatch_advi_logistic():
    from pymc3_tpu.examples.minibatch_advi_logistic import (build_model,
                                                            make_data)
    X, y, w_true = make_data(n=4000, d=5, seed=3)
    model = build_model(X, y, batch_size=250)
    approx = pm.fit(n=2000, method="advi", model=model, progressbar=False,
                    random_seed=1,
                    obj_optimizer=pm.variational.updates.adam(
                        learning_rate=0.05))
    w_est = np.asarray(approx.mean)[:5]
    # sign pattern and rough magnitude of the true weights
    assert np.all(np.sign(w_est) == np.sign(w_true))
    np.testing.assert_allclose(w_est, w_true, atol=0.6)

def test_samplers_mvnormal_harness():
    from pymc3_tpu.examples.samplers_mvnormal import build_model
    model, cov = build_model(d=3)
    with model:
        trace = pm.sample(draws=400, tune=400, chains=4, progressbar=False,
                          step=pm.DEMetropolisZ(model=model), random_seed=1,
                          compute_convergence_checks=False)
    sd_est = trace["x"].std(axis=0)
    np.testing.assert_allclose(sd_est, np.sqrt(np.diag(cov)), rtol=0.5)
