"""``sample()`` argument/seed/reproducibility matrix (cf. the reference's
``tests/test_sampling.py:41-238`` — at the reference's depth).

Deltas from the reference matrix: ``cores`` is accepted but
inert (chains are a vmap axis), chain parallelism is always on, and the
callback cancel granularity is a streaming block rather than a draw.
"""
import numpy as np
import pytest

import pymc3_tpu as pm
from pymc3_tpu.exceptions import SamplingError

from . import models


class TestSampleArgs:
    """cf. ``tests/test_sampling.py:41-220``."""

    def setup_method(self):
        self.start, self.model, _ = models.simple_model()

    def test_sample_does_not_set_seed(self):
        """``test_sampling.py:46`` — sampling must not disturb the global
        numpy RNG stream."""
        draws_after = []
        for _ in range(2):
            np.random.seed(1)
            pm.sample(draws=5, tune=2, chains=1, model=self.model,
                      progressbar=False,
                      compute_convergence_checks=False)
            draws_after.append(np.random.random())
        assert draws_after[0] == draws_after[1]

    def test_chains_do_not_reuse_seed(self):
        """``test_sampling.py:55`` — distinct chains produce distinct
        draws; identical seeds reproduce the whole multi-chain run."""
        from itertools import combinations
        chains = 4
        run_draws = []
        for _ in range(2):
            trace = pm.sample(draws=50, tune=20, chains=chains,
                              model=self.model, random_seed=7,
                              progressbar=False,
                              compute_convergence_checks=False)
            for i, j in combinations(range(chains), 2):
                assert not np.array_equal(trace.get_values("x", chains=i),
                                          trace.get_values("x", chains=j))
            run_draws.append(trace.get_values("x"))
        assert np.array_equal(run_draws[0], run_draws[1])

    @pytest.mark.parametrize("steps", [1, 10, 300])
    def test_sample_draw_counts(self, steps):
        """``test_sampling.py:75``."""
        trace = pm.sample(draws=steps, tune=2, chains=1, model=self.model,
                          random_seed=1, progressbar=False,
                          compute_convergence_checks=False)
        assert len(trace) == steps

    @pytest.mark.parametrize("init", ["adapt_diag", "jitter+adapt_diag",
                                      "advi", "advi_map", "map", "nuts",
                                      "advi+adapt_diag",
                                      "advi+adapt_diag_grad",
                                      "adapt_full", "jitter+adapt_full"])
    def test_sample_init(self, init):
        """``test_sampling.py:88`` + ``test_exec_nuts_init:681`` — every
        init strategy produces a usable start + step."""
        trace = pm.sample(init=init, tune=5, n_init=200, draws=10, chains=2,
                          model=self.model, random_seed=1, progressbar=False,
                          compute_convergence_checks=False)
        assert len(trace) == 10

    def test_sample_args_unknown_kwarg(self):
        """``test_sampling.py:99``."""
        with pytest.raises(ValueError) as excinfo:
            pm.sample(draws=10, tune=2, model=self.model,
                      progressbar=False, foo=1)
        assert "foo" in str(excinfo.value)

    def test_sample_args_step_kwargs_validated(self):
        with pytest.raises(ValueError) as excinfo:
            pm.sample(draws=10, tune=2, model=self.model,
                      progressbar=False, step_kwargs={"foo": {}})
        assert "foo" in str(excinfo.value)

    def test_sample_args_stepper_name_kwargs(self):
        """step kwargs route by stepper name (our spelling of the
        reference's step_kwargs plumbing, ``sampling.py:96-139``)."""
        trace = pm.sample(draws=20, tune=20, chains=1, model=self.model,
                          progressbar=False, random_seed=1,
                          nuts={"target_accept": 0.95},
                          compute_convergence_checks=False)
        assert len(trace) == 20

    def test_per_chain_start(self):
        """``test_sampling.py:125`` — list-valued start seeds each chain."""
        trace = pm.sample(draws=1, tune=0, chains=2, model=self.model,
                          step=pm.Metropolis(model=self.model),
                          discard_tuned_samples=False, progressbar=False,
                          random_seed=1,
                          start=[{"x": [10, 10]}, {"x": [-10, -10]}],
                          compute_convergence_checks=False)
        assert trace.get_values("x", chains=0)[0][0] > 0
        assert trace.get_values("x", chains=1)[0][0] < 0

    def test_sample_tune_len(self):
        """``test_sampling.py:138``."""
        kw = dict(model=self.model, progressbar=False, random_seed=1,
                  compute_convergence_checks=False)
        assert len(pm.sample(draws=100, tune=50, chains=1, **kw)) == 100
        assert len(pm.sample(draws=100, tune=50, chains=1,
                             discard_tuned_samples=False, **kw)) == 150
        assert len(pm.sample(draws=100, tune=50, chains=4, **kw)) == 100

    @pytest.mark.parametrize("step_cls", [pm.NUTS, pm.Metropolis, pm.Slice])
    @pytest.mark.parametrize("discard", [True, False])
    def test_trace_report(self, step_cls, discard):
        """``test_sampling.py:149`` — report metadata survives every
        stepper × discard combination."""
        with self.model:
            trace = pm.sample(draws=100, tune=50, chains=2,
                              discard_tuned_samples=discard,
                              step=step_cls(), progressbar=False,
                              random_seed=1,
                              compute_convergence_checks=False)
        assert trace.report.n_tune == 50
        assert trace.report.n_draws == 100
        assert isinstance(trace.report.t_sampling, float)

    def test_sampler_stat_tune(self):
        """``test_sampling.py:164`` — the `tune` stat flags exactly the
        warmup draws."""
        with self.model:
            trace = pm.sample(tune=5, draws=7, chains=2,
                              discard_tuned_samples=False,
                              step=pm.Metropolis(), progressbar=False,
                              random_seed=1,
                              compute_convergence_checks=False)
        tune_stat = list(np.asarray(
            trace.get_sampler_stats("tune", chains=1)).astype(bool))
        assert tune_stat.count(True) == 5
        assert tune_stat.count(False) == 7

    @pytest.mark.parametrize(
        "start,error",
        [({"x": 1}, ValueError),
         ({"x": [1, 2, 3]}, ValueError),
         ({"x": np.array([[1, 1], [1, 1]])}, ValueError)])
    def test_sample_start_bad_shape(self, start, error):
        """``test_sampling.py:184``."""
        with pytest.raises(error):
            pm.sampling._check_start_shape(self.model, start, 1)

    @pytest.mark.parametrize(
        "start", [{"x": np.array([1, 1])}, {"x": [10, 10]},
                  {"x": [-10, -10]}])
    def test_sample_start_good_shape(self, start):
        pm.sampling._check_start_shape(self.model, start, 1)

    def test_sample_callback_called(self):
        """``test_sampling.py:194``."""
        calls = []
        pm.sample(draws=10, tune=0, chains=2, model=self.model,
                  step=pm.Metropolis(model=self.model), progressbar=False,
                  random_seed=1, callback=lambda trace, draw: calls.append(draw),
                  compute_convergence_checks=False)
        assert calls
        assert calls[-1].is_last

    def test_callback_can_cancel(self):
        """``test_sampling.py:207`` — a KeyboardInterrupt from the callback
        yields a partial trace; cancel granularity is one streaming block."""
        def cancel(trace, draw):
            if draw.draw_idx >= 5:
                raise KeyboardInterrupt()

        trace = pm.sample(draws=20, tune=0, chains=1, model=self.model,
                          step=pm.Metropolis(model=self.model),
                          progressbar=False, random_seed=1,
                          block_size=5, callback=cancel,
                          compute_convergence_checks=False)
        assert 5 <= len(trace) < 20

    def test_empty_model(self):
        """``test_sampling.py:222``."""
        with pm.Model():
            pm.Normal("a", observed=1)
            with pytest.raises(ValueError, match="free variables"):
                pm.sample()

    def test_partial_trace_sample(self):
        """``test_sampling.py:230``."""
        with pm.Model() as model:
            a = pm.Normal("a", mu=0, sigma=1)
            pm.Normal("b", mu=0, sigma=1)
            trace = pm.sample(draws=10, tune=2, trace=[a],
                              progressbar=False, random_seed=1,
                              compute_convergence_checks=False)
        assert "a" in trace.varnames
        assert "b" not in trace.varnames

    def test_bad_start_raises_with_attribution(self):
        """cf. 'Bad initial energy' per-RV attribution
        (``base_hmc.py:138-158``)."""
        with pytest.raises(SamplingError, match="Initial evaluation"):
            pm.sample(draws=5, tune=2, chains=1, model=self.model,
                      start={"x": np.array([np.nan, 0.0])},
                      progressbar=False,
                      compute_convergence_checks=False)


class TestInitNuts:
    """``test_exec_nuts_init`` (``test_sampling.py:681``)."""

    @pytest.mark.parametrize("method", ["adapt_diag", "jitter+adapt_diag",
                                        "map", "advi", "nuts"])
    def test_exec_nuts_init(self, method):
        with pm.Model() as model:
            pm.Normal("a", mu=0, sigma=1, shape=2)
            pm.HalfNormal("b", sigma=1)
        with model:
            start, step = pm.init_nuts(init=method, n_init=50, chains=1)
            assert isinstance(start, list) and len(start) == 1
            assert isinstance(start[0], dict)
            assert "a" in start[0] and "b_log__" in start[0]
            start, step = pm.init_nuts(init=method, n_init=50, chains=2)
            assert isinstance(start, list) and len(start) == 2
            assert all("a" in s and "b_log__" in s for s in start)


class TestRecordStatsSubset:
    """List-valued ``record_stats`` trims which sampler stats reach the
    trace (the stats analog of the list-valued ``trace`` subset);
    ``diverging`` is always kept for the report."""

    def test_subset_recorded(self):
        _, model, _ = models.simple_model()
        trace = pm.sample(draws=20, tune=20, chains=2, model=model,
                          progressbar=False, random_seed=1,
                          record_stats=["depth"],
                          compute_convergence_checks=False)
        assert "depth" in trace.stat_names
        assert "diverging" in trace.stat_names  # always kept
        assert "energy" not in trace.stat_names
        assert trace.get_sampler_stats("depth").shape == (40,)


class TestWarmResume:
    """``resume_from`` (an extension, SURVEY §5 checkpoint/resume — the
    gap the reference leaves open: its sampler state is never
    checkpointed): continue a run with tune=0 from the previous kernel
    state."""

    def test_resume_carries_kernel_state(self):
        _, model, _ = models.simple_model()
        tr1 = pm.sample(draws=100, tune=200, chains=4, model=model,
                        progressbar=False, random_seed=1,
                        compute_convergence_checks=False)
        tr2 = pm.sample(draws=100, tune=0, chains=4, model=model,
                        progressbar=False, random_seed=2, resume_from=tr1,
                        compute_convergence_checks=False)
        e1 = np.asarray(tr1.get_sampler_stats("step_size",
                                              combine=False))[:, -1]
        e2 = np.asarray(tr2.get_sampler_stats("step_size",
                                              combine=False))[:, 0]
        np.testing.assert_allclose(e1, e2, rtol=1e-5)
        assert len(tr2) == 100

    def test_resume_after_save_load(self, tmp_path):
        """The checkpoint survives save_trace/load_trace."""
        _, model, _ = models.simple_model()
        with model:
            tr1 = pm.sample(draws=100, tune=200, chains=2,
                            progressbar=False, random_seed=3,
                            compute_convergence_checks=False)
            d = pm.save_trace(tr1, str(tmp_path / "ckpt"), overwrite=True)
            loaded = pm.load_trace(d)
            tr2 = pm.sample(draws=50, tune=0, chains=2, progressbar=False,
                            random_seed=4, resume_from=loaded,
                            compute_convergence_checks=False)
        e1 = np.asarray(tr1.get_sampler_stats("step_size",
                                              combine=False))[:, -1]
        e2 = np.asarray(tr2.get_sampler_stats("step_size",
                                              combine=False))[:, 0]
        np.testing.assert_allclose(e1, e2, rtol=1e-5)

    def test_resume_chain_count_mismatch_raises(self):
        _, model, _ = models.simple_model()
        tr1 = pm.sample(draws=20, tune=20, chains=2, model=model,
                        progressbar=False, random_seed=1,
                        compute_convergence_checks=False)
        with pytest.raises(ValueError, match="chains"):
            pm.sample(draws=10, tune=0, chains=8, model=model,
                      progressbar=False, resume_from=tr1,
                      compute_convergence_checks=False)
