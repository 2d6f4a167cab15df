"""return_inferencedata / native InferenceData export and failure
attribution (cf. reference ``sampling.py:544-560`` ArviZ wrapping and
``base_hmc.py:138-158`` per-RV bad-energy attribution)."""
import numpy as np
import pytest

import pymc3_tpu as pm


def small_model():
    with pm.Model() as m:
        mu = pm.Normal("mu", 0.0, 1.0)
        sigma = pm.HalfNormal("sigma", 1.0)
        pm.Normal("obs", mu=mu, sigma=sigma,
                  observed=np.array([0.1, -0.3, 0.5, 0.2]))
    return m


def test_return_inferencedata():
    m = small_model()
    idata = pm.sample(draws=150, tune=150, chains=2, model=m,
                      progressbar=False, random_seed=1,
                      compute_convergence_checks=False,
                      return_inferencedata=True)
    assert "posterior" in idata
    assert "sample_stats" in idata
    post = idata.posterior
    assert np.asarray(post["mu"]).shape == (2, 150)
    assert np.asarray(post["sigma"]).shape == (2, 150)
    # transformed variables are excluded from the posterior group
    assert "sigma_log__" not in post
    stats = idata.sample_stats
    assert np.asarray(stats["diverging"]).shape == (2, 150)
    assert "acceptance_rate" in stats  # ArviZ-convention alias
    obs = idata.observed_data
    np.testing.assert_allclose(np.asarray(obs["obs"]),
                               [0.1, -0.3, 0.5, 0.2])
    assert "posterior" in idata.groups()


def test_multitrace_returned_by_default():
    m = small_model()
    tr = pm.sample(draws=50, tune=50, chains=2, model=m, progressbar=False,
                   random_seed=1, compute_convergence_checks=False)
    from pymc3_tpu.backends.base import MultiTrace
    assert isinstance(tr, MultiTrace)


def test_nonfinite_logp_attribution():
    """A chain that records a non-finite model logp gets a BAD_ENERGY
    warning naming the offending logp term."""
    from pymc3_tpu.backends.report import SamplerWarning, WarningType
    from pymc3_tpu.sampling import _attach_sample_stats_warnings
    from pymc3_tpu.backends.base import MultiTrace
    from pymc3_tpu.backends.ndarray import NDArray

    m = small_model()
    strace = NDArray(model=m)
    stats_dtypes = [{"model_logp": np.float64, "diverging": bool}]
    strace.setup(3, 0, stats_dtypes)
    pts = [m.test_point, m.test_point,
           {"mu": np.array(np.nan), "sigma_log__": np.array(0.0)}]
    for i, pt in enumerate(pts):
        lp = float(m.logp(pt))
        strace.record(pt, [{"model_logp": lp, "diverging": False}])
    mtrace = MultiTrace([strace])
    _attach_sample_stats_warnings(mtrace, _FakeStep(), 0, m)
    warns = mtrace.report._chain_warnings.get(0, [])
    bad = [w for w in warns if w.kind == WarningType.BAD_ENERGY]
    assert bad, "expected a BAD_ENERGY warning"
    assert "mu" in bad[0].message


class _FakeStep:
    generates_stats = True
    stats_dtypes = [{"model_logp": np.float64, "diverging": bool}]


def test_log_likelihood_group_and_dims():
    """idata_kwargs plumbing: log_likelihood is computed pointwise on
    device, coords/dims flow through."""
    import scipy.stats as st

    obs = np.array([0.1, -0.3, 0.5])
    with pm.Model(coords={"unit": np.array(["u0", "u1", "u2"])}) as m:
        mu = pm.Normal("mu", 0.0, 1.0)
        pm.Normal("obs", mu=mu, sigma=1.0, observed=obs)
        tr = pm.sample(draws=40, tune=40, chains=2, progressbar=False,
                       random_seed=2, compute_convergence_checks=False)
    idata = pm.to_inference_data(tr, model=m, log_likelihood=True,
                                 dims={"obs": ["unit"]})
    assert "log_likelihood" in idata.groups()
    ll = np.asarray(idata.log_likelihood["obs"])
    assert ll.shape == (2, 40, 3)
    pt = tr.point(0, chain=tr.chains[0])
    np.testing.assert_allclose(ll[0, 0],
                               st.norm.logpdf(obs, pt["mu"], 1.0),
                               atol=1e-4)


def test_unknown_idata_kwargs_raise():
    m = small_model()
    tr = pm.sample(draws=20, tune=20, chains=1, model=m, progressbar=False,
                   random_seed=1, compute_convergence_checks=False)
    with pytest.raises(TypeError, match="idata_kwargs"):
        pm.to_inference_data(tr, model=m, not_an_option=True)
