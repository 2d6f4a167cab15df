"""Plot smoke tests (cf. reference ``pymc3/tests/test_plots.py``): every
plotting entry point renders on a real trace without error and returns
matplotlib axes, on the Agg backend."""
import numpy as np
import pytest

import pymc3_tpu as pm

# matplotlib is optional: where it is not installed, `pytest -m gpu` must
# still collect this module
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


@pytest.fixture(scope="module")
def trace_and_model():
    with pm.Model() as m:
        mu = pm.Normal("mu", 0.0, 5.0)
        sd = pm.HalfNormal("sd", 1.0)
        pm.Normal("obs", mu=mu, sigma=sd,
                  observed=np.random.default_rng(0).normal(1.0, 0.5, 40))
        tr = pm.sample(draws=150, tune=150, chains=2, progressbar=False,
                       compute_convergence_checks=False, random_seed=6)
    return tr, m


def _close():
    plt.close("all")


def test_traceplot(trace_and_model):
    tr, _ = trace_and_model
    axes = pm.traceplot(tr)
    assert np.asarray(axes).size >= 2
    axes_c = pm.traceplot(tr, combined=True, var_names=["mu"])
    assert np.asarray(axes_c).size >= 1
    _close()


def test_plot_posterior(trace_and_model):
    tr, _ = trace_and_model
    axes = pm.plot_posterior(tr)
    assert np.asarray(axes).size >= 2
    axes_rt = pm.plot_posterior(tr, var_names=["mu"], ref_val=1.0)
    assert np.asarray(axes_rt).size >= 1
    _close()


def test_forestplot(trace_and_model):
    tr, _ = trace_and_model
    pm.forestplot(tr)
    pm.forestplot(tr, var_names=["sd"], credible_interval=0.5)
    _close()


def test_energyplot(trace_and_model):
    tr, _ = trace_and_model
    pm.energyplot(tr)
    _close()


def test_autocorrplot(trace_and_model):
    tr, _ = trace_and_model
    pm.autocorrplot(tr, max_lag=20)
    _close()


def test_densityplot_kde_alias(trace_and_model):
    tr, _ = trace_and_model
    pm.densityplot(tr)
    assert pm.kdeplot is pm.densityplot
    _close()


def test_pairplot_with_divergences(trace_and_model):
    tr, _ = trace_and_model
    pm.pairplot(tr)
    pm.pairplot(tr, divergences=True)
    _close()


def test_compareplot():
    import pandas as pd
    comp = pd.DataFrame({
        "rank": [0, 1], "waic": [10.0, 12.0], "p_waic": [1.0, 1.5],
        "d_waic": [0.0, 2.0], "weight": [0.7, 0.3], "se": [1.0, 1.2],
        "dse": [0.0, 0.5], "warning": [False, False],
    }, index=["m1", "m2"])
    pm.compareplot(comp)
    _close()


def test_plot_posterior_predictive_glm(trace_and_model):
    tr, _ = trace_and_model
    # lm draws a line per sample from (mu, sd)
    pm.plots.plot_posterior_predictive_glm(
        tr, eval=np.linspace(0, 1, 10),
        lm=lambda x, s: s["mu"] + 0.0 * x, samples=10)
    _close()


def test_discrete_trace_plots():
    with pm.Model() as m:
        pm.Poisson("k", mu=3.0)
        tr = pm.sample(draws=120, tune=80, chains=2, progressbar=False,
                       compute_convergence_checks=False, random_seed=7,
                       step=pm.Metropolis())
    pm.traceplot(tr)
    pm.plot_posterior(tr)  # discrete branch (histogram, not KDE)
    _close()
