"""Sampling driver tests (cf. ``pymc3/tests/test_sampling.py``)."""
import numpy as np
import pytest

import pymc3_tpu as pm

from . import models


class TestSample:
    def setup_method(self):
        self.start, self.model, _ = models.simple_model()

    def test_sample_runs(self):
        with self.model:
            trace = pm.sample(draws=100, tune=100, chains=2,
                              progressbar=False, random_seed=42,
                              compute_convergence_checks=False)
        assert len(trace) == 100
        assert trace.nchains == 2
        assert trace["x"].shape == (200, 2)

    def test_reproducibility(self):
        with self.model:
            t1 = pm.sample(draws=50, tune=50, chains=2, random_seed=7,
                           progressbar=False,
                           compute_convergence_checks=False)
            t2 = pm.sample(draws=50, tune=50, chains=2, random_seed=7,
                           progressbar=False,
                           compute_convergence_checks=False)
        np.testing.assert_allclose(t1["x"], t2["x"])

    def test_keep_tune(self):
        with self.model:
            trace = pm.sample(draws=50, tune=50, chains=1,
                              discard_tuned_samples=False,
                              progressbar=False, random_seed=3,
                              compute_convergence_checks=False)
        assert len(trace) == 100

    def test_start_arg(self):
        start = {"x": np.array([0.5, -0.5], dtype=np.float32)}
        with self.model:
            trace = pm.sample(draws=20, tune=20, chains=1, start=start,
                              progressbar=False, random_seed=5,
                              compute_convergence_checks=False)
        assert len(trace) == 20

    def test_sampler_stats(self):
        with self.model:
            trace = pm.sample(draws=100, tune=100, chains=2,
                              progressbar=False, random_seed=11,
                              compute_convergence_checks=False)
        depth = trace.get_sampler_stats("depth")
        assert depth.shape == (200,)
        assert np.all(depth >= 1)
        assert "mean_tree_accept" in trace.stat_names
        energy = trace.get_sampler_stats("energy")
        assert np.all(np.isfinite(energy))

    def test_bad_init(self):
        with pm.Model() as model:
            pm.HalfNormal("a", sigma=1, testval=-1, transform=None)
            with pytest.raises(pm.SamplingError) as error:
                pm.sample(model=model, random_seed=1, progressbar=False)
            error.match("Initial evaluation")

    def test_step_assignment_mixed(self):
        """Discrete + continuous → CompoundStep (NUTS + Metropolis)."""
        with pm.Model() as model:
            p = pm.Beta("p", 1.0, 1.0)
            pm.Binomial("k", n=10, p=p, observed=np.int32(4))
            z = pm.Poisson("z", 2.0)
            trace = pm.sample(draws=200, tune=200, chains=2,
                              progressbar=False, random_seed=9,
                              compute_convergence_checks=False)
        zs = trace["z"]
        assert zs.std() > 0.5  # discrete var actually moves
        assert np.allclose(zs, np.round(zs))

    def test_partial_trace(self):
        _, model, _ = models.simple_model()
        with model:
            trace = pm.sample(draws=30, tune=10, chains=1,
                              progressbar=False, random_seed=2,
                              compute_convergence_checks=False)
        sliced = trace[10:]
        assert len(sliced) == 20


class TestNutsInit:
    def test_adapt_diag(self):
        _, model, _ = models.simple_model()
        start, step = pm.init_nuts(init="adapt_diag", chains=2, model=model)
        assert len(start) == 2
        assert isinstance(step, pm.NUTS)

    def test_jitter_adapt_diag(self):
        _, model, _ = models.simple_model()
        start, step = pm.init_nuts(init="jitter+adapt_diag", chains=3,
                                   model=model)
        assert len(start) == 3
        q = [model.dict_to_array(s) for s in start]
        assert not np.allclose(q[0], q[1])

    def test_unknown_raises(self):
        _, model, _ = models.simple_model()
        with pytest.raises(ValueError):
            pm.init_nuts(init="foo", model=model)


class TestSamplePPC:
    def test_prior_predictive(self):
        _, model = models.beta_bernoulli()
        prior = pm.sample_prior_predictive(samples=300, model=model)
        assert prior["p"].shape == (300,)
        assert prior["y"].shape == (300, 6)
        assert 0.3 < prior["p"].mean() < 0.7  # uniform prior
        assert set(np.unique(prior["y"])) <= {0, 1}

    def test_posterior_predictive(self):
        _, model = models.beta_bernoulli()
        with model:
            trace = pm.sample(draws=200, tune=200, chains=2,
                              progressbar=False, random_seed=4,
                              compute_convergence_checks=False)
            ppc = pm.sample_posterior_predictive(trace, model=model,
                                                 progressbar=False)
        assert ppc["y"].shape[0] == 400
        # posterior of p given 4/6 successes with flat prior: mean 5/8
        assert abs(ppc["y"].mean() - 5.0 / 8.0) < 0.1

    def test_fast_alias(self):
        _, model = models.beta_bernoulli()
        with model:
            trace = pm.sample(draws=50, tune=100, chains=1,
                              progressbar=False, random_seed=4,
                              compute_convergence_checks=False)
            ppc = pm.fast_sample_posterior_predictive(trace, model=model)
        assert ppc["y"].shape[0] == 50

    def test_keep_size(self):
        _, model = models.beta_bernoulli()
        with model:
            trace = pm.sample(draws=50, tune=100, chains=2,
                              progressbar=False, random_seed=4,
                              compute_convergence_checks=False)
            ppc = pm.sample_posterior_predictive(trace, model=model,
                                                 keep_size=True,
                                                 progressbar=False)
        assert ppc["y"].shape == (2, 50, 6)


class TestIterSample:
    """Sequential host-path generator (cf. ``iter_sample``,
    ``pymc3/sampling.py:581`` — cumulative-trace semantics)."""

    def test_iter(self):
        _, model, _ = models.simple_model()
        with model:
            step = pm.Metropolis(vars=model.free_RVs, blocked=True)
            traces = list(pm.iter_sample(20, step, model=model,
                                         random_seed=1))
        assert len(traces) == 20
        assert len(traces[-1]) == 20

    def test_cumulative_nuts(self):
        start, model, _ = models.simple_model()
        with model:
            step = pm.NUTS()
            lengths = []
            last = None
            for i, trace in enumerate(pm.iter_sample(
                    8, step, start=start, tune=2, random_seed=11)):
                lengths.append(len(trace))
                last = trace
                if i >= 7:
                    break
            assert lengths == list(range(1, 9))
            assert last["x"].shape == (8, 2)
            # sampler stats recorded on the host path too
            assert "diverging" in last.stat_names

    def test_cumulative_compound(self):
        with pm.Model() as model:
            pm.Normal("x", 0, 1)
            pm.Bernoulli("z", 0.6)
            steps = pm.sampling.assign_step_methods(model, None)
            step = pm.CompoundStep(steps) if isinstance(steps, list) else steps
            traces = list(pm.iter_sample(5, step, tune=1, random_seed=5))
        assert len(traces) == 5
        assert len(traces[-1]) == 5
        zvals = traces[-1]["z"]
        assert set(np.unique(zvals)).issubset({0, 1})


class TestBlockPadding:
    """The equalize-blocks padding steps past ``total`` must not advance
    kernel state or RNG (``sampling.py`` _mask_padding)."""

    def test_final_state_invariant_to_block_size(self):
        start, model, _ = models.simple_model()
        common = dict(draws=60, tune=40, chains=2, model=model,
                      progressbar=False, random_seed=3,
                      compute_convergence_checks=False)
        t_pad = pm.sample(block_size=64, **common)    # 100 = 64 + 36pad
        t_exact = pm.sample(block_size=100, **common)  # one exact block
        np.testing.assert_allclose(
            t_pad.get_values("x", combine=True),
            t_exact.get_values("x", combine=True), atol=1e-5)
        w_pad = t_pad._straces[0].warmup_state
        w_exact = t_exact._straces[0].warmup_state
        assert w_pad is not None and w_exact is not None
        for k in w_pad:
            np.testing.assert_allclose(w_pad[k], w_exact[k], atol=1e-5,
                                       err_msg=k)
