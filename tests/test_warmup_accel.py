"""Round-5 warmup accelerators: the Stan-style step-size probe, the
early pooled mass-window promotions, and the warmup depth-cap schedule
(the time-to-first-draw work)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import pymc3_tpu as pm
from pymc3_tpu.step_methods.hmc.nuts import NUTS, find_reasonable_eps
from pymc3_tpu.step_methods.hmc.quadpotential import (
    diag_adapt_init, diag_adapt_update)


def _gaussian_model(sd):
    with pm.Model() as m:
        pm.Normal("x", 0.0, sd, shape=np.shape(sd) or None)
    return m


class TestFindReasonableEps:
    def test_scales_with_target_width(self):
        """For an isotropic Gaussian the stable step scales with sd: the
        probed eps must track it across two orders of magnitude."""
        found = {}
        for sd in (0.01, 1.0):
            m = _gaussian_model(np.full(4, sd, np.float32))
            step = NUTS(model=m)
            q0 = np.zeros((16, 4), np.float32)
            found[sd] = find_reasonable_eps(step, q0, seed=1)
        ratio = found[1.0] / found[0.01]
        assert 20 < ratio < 500, found

    def test_one_leapfrog_accept_in_window(self):
        """The returned eps gives a pooled one-leapfrog acceptance in the
        search window (not collapsed to a bound)."""
        m = _gaussian_model(np.float32(1.0))
        step = NUTS(model=m)
        eps = find_reasonable_eps(step, np.zeros((64, 1), np.float32),
                                  seed=3)
        assert 1e-6 < eps < 1e3
        assert np.isfinite(eps)

    def test_partial_step_returns_input(self):
        """Compound-step NUTS over a subset of a larger model skips the
        probe (its logp closes over the other coordinates)."""
        with pm.Model() as m:
            pm.Normal("a", 0.0, 1.0)
            pm.Bernoulli("b", 0.5)
        step = NUTS(vars=[m["a"]], model=m)
        if step._partial:
            assert find_reasonable_eps(step, np.zeros((4, 1), np.float32),
                                       seed=1) == step.step_size

    def test_sample_uses_probe_and_stays_correct(self):
        """End-to-end: posterior of a scaled Gaussian stays exact with
        the probe active (it only changes eps0, not the kernel)."""
        sd = np.array([0.05, 5.0], np.float32)
        m = _gaussian_model(sd)
        tr = pm.sample(draws=1500, tune=700, chains=4, model=m,
                       progressbar=False, random_seed=1,
                       compute_convergence_checks=False)
        x = tr["x"]
        np.testing.assert_allclose(x.std(axis=0), sd, rtol=0.1)
        assert np.all(np.abs(x.mean(axis=0)) < 4 * sd / np.sqrt(400)), \
            x.mean(axis=0)


class TestEarlyWindowPromotion:
    def _drive(self, axis_name, n_steps, n_lanes=64):
        """Drive diag_adapt_update under vmap with target sd 0.1 and
        return the mass (var) trajectory."""
        rng = np.random.RandomState(0)
        samples = rng.normal(0.0, 0.1, size=(n_steps, n_lanes, 1)).astype(
            np.float32)

        def one_lane(samps):
            state = diag_adapt_init(jnp.zeros(1), jnp.ones(1), 10.0)

            def body(state, s):
                new = diag_adapt_update(state, s, True,
                                        axis_name=axis_name)
                return new, new.var
            _, vars_ = jax.lax.scan(body, state, samps)
            return vars_

        vars_ = jax.vmap(one_lane, in_axes=1, out_axes=1,
                         axis_name=axis_name or "unused")(
            jnp.asarray(samples))
        return np.asarray(vars_[:, 0, 0])

    def test_pooled_mass_converges_by_draw_11(self):
        """With 256 pooled lanes (256 x 10 = 2560 pooled samples > the
        1024 gate) the n=10 promotion discards the init prior: by draw
        11 the pooled variance estimate is within 2x of the true 0.01
        (unpooled still carries the weight-10 unit prior)."""
        pooled = self._drive("ch", 12, n_lanes=256)
        assert pooled[11] < 0.02, pooled[8:]
        unpooled = self._drive(None, 12, n_lanes=256)
        assert unpooled[11] > 0.2, unpooled[8:]  # prior still dominates

    def test_small_pools_keep_reference_schedule(self):
        """4 pooled lanes x 3 draws = 12 samples < 1024: no early
        promotion, matching the reference's 101-draw window."""
        pooled = self._drive("ch", 12, n_lanes=4)
        # init prior (weight 10 of var 1 per lane) still dominates
        assert pooled[11] > 0.2, pooled


class TestWarmupDepthCaps:
    def test_caps_only_apply_to_pooled_runs(self):
        """Unpooled (reference-parity) runs keep the 8/10 schedule; the
        5/6 caps are the pooled-lockstep cost control."""
        import inspect
        src = inspect.getsource(NUTS.kernel_step)
        assert "axis_name is not None" in src  # guard present

    def test_pooled_funnel_still_converges(self):
        """Eight-schools non-centered under pooled adaptation with the
        caps active: R-hat < 1.02 and sane moments."""
        y = np.array([28., 8., -3., 7., -1., 1., 18., 12.], np.float32)
        s = np.array([15., 10., 16., 11., 9., 11., 10., 18.], np.float32)
        with pm.Model() as m:
            mu = pm.Normal("mu", 0., 5.)
            tau = pm.HalfCauchy("tau", 5.)
            eta = pm.Normal("eta", 0., 1., shape=8)
            pm.Normal("obs", mu=mu + tau * eta, sigma=s, observed=y)
        tr = pm.sample(draws=1000, tune=1000, chains=8, model=m,
                       progressbar=False, random_seed=2,
                       axis_name="chains_local",
                       compute_convergence_checks=False)
        rhat = float(np.asarray(pm.rhat(tr, var_names=["mu"])["mu"]))
        assert rhat < 1.02, rhat
        assert abs(tr["mu"].mean() - 4.4) < 1.0
