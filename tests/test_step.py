"""Step-method tests (cf. ``pymc3/tests/test_step.py``; statistical checks
instead of the reference's golden traces — SURVEY §4.3)."""
import numpy as np
import pytest
import jax

import pymc3_tpu as pm
from pymc3_tpu.step_methods import (
    NUTS, HamiltonianMC, Metropolis, Slice, BinaryGibbsMetropolis,
    CategoricalGibbsMetropolis, DEMetropolisZ, CompoundStep, Competence,
)
from pymc3_tpu.step_methods.hmc.integration import (
    IntegrationState, compute_state, leapfrog,
)

from . import models


class TestLeapfrogReversible:
    """cf. ``pymc3/tests/test_hmc.py`` leapfrog reversibility."""

    def test_reversibility(self):
        _, model, _ = models.simple_model()
        logp_fn = jax.value_and_grad(model.make_logp_fn())
        import jax.numpy as jnp
        n = model.ordering.size
        var = jnp.ones(n)
        key = jax.random.PRNGKey(0)
        q = jax.random.normal(key, (n,))
        p = jax.random.normal(jax.random.PRNGKey(1), (n,))
        state = compute_state(logp_fn, var, q, p)
        eps = 0.1
        fwd = state
        for _ in range(8):
            fwd = leapfrog(logp_fn, var, eps, fwd)
        back = IntegrationState(q=fwd.q, p=-fwd.p, v=-fwd.v,
                                q_grad=fwd.q_grad, energy=fwd.energy,
                                model_logp=fwd.model_logp)
        for _ in range(8):
            back = leapfrog(logp_fn, var, eps, back)
        np.testing.assert_allclose(np.asarray(back.q), np.asarray(q),
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(-back.p), np.asarray(p),
                                   atol=1e-4)

    def test_energy_conservation(self):
        _, model, _ = models.simple_model()
        logp_fn = jax.value_and_grad(model.make_logp_fn())
        import jax.numpy as jnp
        n = model.ordering.size
        var = jnp.ones(n)
        q = jnp.zeros(n) + 0.3
        p = jnp.ones(n) * 0.7
        state = compute_state(logp_fn, var, q, p)
        e0 = float(state.energy)
        for _ in range(100):
            state = leapfrog(logp_fn, var, 0.01, state)
        assert abs(float(state.energy) - e0) < 1e-2


class TestStepCompetence:
    def test_assignments(self):
        with pm.Model() as model:
            x = pm.Normal("x", 0, 1)
            steps = pm.assign_step_methods(model)
        assert isinstance(steps, NUTS)

    def test_discrete_goes_metropolis(self):
        with pm.Model() as model:
            z = pm.Poisson("z", 2.0)
            steps = pm.assign_step_methods(model)
        assert isinstance(steps, Metropolis)

    def test_binary(self):
        with pm.Model() as model:
            b = pm.Bernoulli("b", 0.5)
            steps = pm.assign_step_methods(model)
        assert isinstance(steps, BinaryGibbsMetropolis)

    def test_mixed_compound(self):
        with pm.Model() as model:
            x = pm.Normal("x", 0, 1)
            z = pm.Poisson("z", 2.0)
            steps = pm.assign_step_methods(model)
        assert isinstance(steps, list) or isinstance(steps, CompoundStep)


class TestMetropolisTuning:
    def test_scaling_tunes(self):
        """Proposal scaling must adapt towards reasonable acceptance."""
        _, model, _ = models.simple_model()
        with model:
            step = Metropolis(vars=model.free_RVs, blocked=True, scaling=100.0)
            trace = pm.sample(draws=200, tune=600, chains=1, step=step,
                              progressbar=False, random_seed=1,
                              compute_convergence_checks=False)
        final_scaling = trace.get_sampler_stats("scaling")[-1]
        assert final_scaling < 100.0


class TestDEMetropolisZ:
    def test_sampling(self):
        _, model, _ = models.simple_model()
        with model:
            step = DEMetropolisZ(model=model)
            trace = pm.sample(draws=1500, tune=800, chains=2, step=step,
                              progressbar=False, random_seed=1,
                              compute_convergence_checks=False)
        x = trace["x"]
        assert abs(x.mean() + 2.1) < 0.3
        assert "lambda" in trace.stat_names


class TestHamiltonianMC:
    def test_sampling(self):
        _, model, _ = models.simple_model()
        with model:
            step = HamiltonianMC(model=model, path_length=1.0)
            trace = pm.sample(draws=1500, tune=800, chains=2, step=step,
                              progressbar=False, random_seed=2,
                              compute_convergence_checks=False)
        x = trace["x"]
        assert abs(x.mean() + 2.1) < 0.3
        assert "n_steps" in trace.stat_names


class TestNutsDiagnostics:
    def test_divergences_flagged(self):
        """Funnel-like geometry should produce divergence stats."""
        with pm.Model() as model:
            v = pm.Normal("v", 0, 3)
            x = pm.Normal("x", 0, (v / 2).exp())
            trace = pm.sample(draws=500, tune=300, chains=2,
                              progressbar=False, random_seed=5,
                              nuts={"target_accept": 0.7},
                              compute_convergence_checks=False)
        div = trace.get_sampler_stats("diverging")
        assert div.dtype == bool  # present & typed

    def test_max_treedepth_stat(self):
        _, model, _ = models.simple_model()
        with model:
            step = NUTS(model=model, max_treedepth=3)
            trace = pm.sample(draws=200, tune=200, chains=1, step=step,
                              progressbar=False, random_seed=6,
                              compute_convergence_checks=False)
        assert trace.get_sampler_stats("depth").max() <= 3


class TestCategoricalGibbs:
    def test_sampling(self):
        p = np.array([0.1, 0.4, 0.5], dtype=np.float32)
        with pm.Model() as model:
            c = pm.Categorical("c", p=p)
            trace = pm.sample(draws=3000, tune=500, chains=1,
                              progressbar=False, random_seed=7,
                              compute_convergence_checks=False)
        vals = trace["c"].astype(int)
        freq = np.bincount(vals, minlength=3) / len(vals)
        np.testing.assert_allclose(freq, p, atol=0.07)


class TestSGLD:
    def test_minibatch_posterior_mean(self):
        """SGLD with a Minibatch likelihood converges to the conjugate
        posterior mean of a Normal location model (the minibatch dlogp is
        threaded through the env RNG key, sgmcmc.py:46)."""
        from pymc3_tpu.step_methods.sgmcmc import SGLD

        rng = np.random.RandomState(0)
        data = (1.5 + 0.5 * rng.randn(4000)).astype("float32")
        with pm.Model() as model:
            mb = pm.Minibatch(data, batch_size=200)
            mu = pm.Normal("mu", 0.0, 10.0)
            pm.Normal("obs", mu=mu, sigma=0.5, observed=mb,
                      total_size=len(data))
            step = SGLD(vars=[mu], step_size=1e-3, model=model)
            trace = pm.sample(draws=3000, tune=500, chains=1, step=step,
                              init=None, progressbar=False, random_seed=1,
                              compute_convergence_checks=False)
        mu_hat = float(np.mean(trace["mu"][1000:]))
        assert abs(mu_hat - 1.5) < 0.15, mu_hat


class TestCompoundStateConsistency:
    def test_no_stale_logp_divergences(self):
        """Under CompoundStep each stepper owns a subset of q; cached
        logp/grad must be refreshed after other steppers move q
        (arraystep._refresh_logp). A stale Hamiltonian shows up as ~100%
        divergences; correct refresh gives an essentially divergence-free
        mixed NUTS+BinaryGibbs run."""
        rng = np.random.RandomState(3)
        z_true = rng.binomial(1, 0.4, 50).astype("float64")
        y = 2.0 * z_true + 0.5 * rng.randn(50)
        with pm.Model() as m:
            p = pm.Beta("p", 1.0, 1.0)
            z = pm.Bernoulli("z", p, shape=50, testval=z_true)
            mu = pm.Normal("mu", 0.0, 5.0)
            pm.Normal("y", mu * z, 0.5, observed=y)
            trace = pm.sample(draws=400, tune=600, chains=2,
                              progressbar=False, random_seed=1,
                              compute_convergence_checks=False)
        ndiv = int(np.sum(np.asarray(trace.get_sampler_stats("diverging"))))
        assert ndiv < 8, f"{ndiv} divergences: stale compound kernel state"
        assert abs(float(np.mean(trace["mu"])) - 2.0) < 0.2


def test_warmup_stuck_lane_rescue():
    """Pooled-adaptation failure detection (SURVEY §5, on device): a lane
    initialized in a pathological region diverges every draw under the
    POOLED step size and never recovers; with rescue_stuck (default) it
    teleports to the pooled best-logp lane at a tuning-window boundary and
    samples normally afterwards."""

    def run(rescue):
        with pm.Model() as m:
            sigma = pm.HalfNormal("sigma", 1.0)
            pm.Normal("obs", 0.0, sigma, observed=np.full(10, 0.5,
                                                          np.float32))
        start = [{"sigma_log__": np.float32(0.0)} for _ in range(8)]
        start[3]["sigma_log__"] = np.float32(-12.0)  # curvature ~ e^24
        tr = pm.sample(draws=100, tune=250, chains=8, model=m, start=start,
                       progressbar=False, random_seed=2,
                       axis_name="chains_local",
                       nuts={"rescue_stuck": rescue},
                       compute_convergence_checks=False)
        div = np.asarray(tr.get_sampler_stats("diverging", combine=False))
        sig3 = tr.get_values("sigma", chains=[3])
        return int(div[3].sum()), float(np.median(sig3))

    d_off, s_off = run(False)
    assert d_off > 90          # reproduces the stuck-lane pathology
    assert s_off < 1e-3
    d_on, s_on = run(True)
    assert d_on < 10
    assert 0.1 < s_on < 2.0    # recovered to the posterior scale


def test_per_lane_eps_scale_bounds_and_health():
    """Pooled-adaptation runs carry a per-lane step-size fallback
    (``nuts.py`` eps_scale): it must stay within [2^-8, 1], never fire the
    teleport rescue on a healthy model, and keep the centered eight-schools
    funnel sampling correct."""
    import numpy as np
    from . import models
    _, model = models.eight_schools()
    with model:
        trace = pm.sample(draws=300, tune=300, chains=16,
                          axis_name="chains_local", progressbar=False,
                          random_seed=3,
                          compute_convergence_checks=False)
    scale = np.asarray(trace.get_sampler_stats("step_size_scale"))
    assert np.all(scale <= 1.0 + 1e-6)
    assert np.all(scale >= 2.0 ** -8 - 1e-9)
    assert not np.any(np.asarray(trace.get_sampler_stats("rescued")))
    # post-tune the healthy bulk should be at (or very near) the pooled eps
    assert float(np.median(scale)) > 0.5


def test_leapfrog_reversible_dense_mass():
    """Reversibility with a DENSE inverse mass (the round-4
    mass_velocity path)."""
    import jax.numpy as jnp
    _, model, _ = models.simple_model()
    logp_fn = jax.value_and_grad(model.make_logp_fn())
    n = model.ordering.size
    rng = np.random.RandomState(0)
    A = rng.randn(n, n).astype(np.float32)
    mass = jnp.asarray(A @ A.T / n + np.eye(n, dtype=np.float32))
    q = jax.random.normal(jax.random.PRNGKey(2), (n,))
    p = jax.random.normal(jax.random.PRNGKey(3), (n,))
    state = compute_state(logp_fn, mass, q, p)
    fwd = state
    for _ in range(8):
        fwd = leapfrog(logp_fn, mass, 0.1, fwd)
    back = IntegrationState(q=fwd.q, p=-fwd.p, v=-fwd.v,
                            q_grad=fwd.q_grad, energy=fwd.energy,
                            model_logp=fwd.model_logp)
    for _ in range(8):
        back = leapfrog(logp_fn, mass, 0.1, back)
    np.testing.assert_allclose(np.asarray(back.q), np.asarray(q),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(-back.p), np.asarray(p),
                               atol=1e-4)
