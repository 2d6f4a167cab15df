"""SMC tests (cf. ``pymc3/tests/test_smc.py``)."""
import numpy as np
import pytest

import pymc3_tpu as pm


class TestSMC:
    def setup_method(self):
        self.n = 4
        mu1 = np.ones(self.n) * 0.5
        mu2 = -mu1
        stdev = 0.1
        sigma = np.power(stdev, 2) * np.eye(self.n)
        isigma = np.linalg.inv(sigma)
        dsigma = np.linalg.det(sigma)
        w1 = stdev
        w2 = 1 - stdev

        def two_gaussians_logp(x):
            import jax.numpy as jnp
            log_like1 = (
                -0.5 * self.n * jnp.log(2 * np.pi)
                - 0.5 * np.log(dsigma)
                - 0.5 * (x - mu1) @ isigma @ (x - mu1))
            log_like2 = (
                -0.5 * self.n * jnp.log(2 * np.pi)
                - 0.5 * np.log(dsigma)
                - 0.5 * (x - mu2) @ isigma @ (x - mu2))
            return jnp.logaddexp(jnp.log(w1) + log_like1,
                                 jnp.log(w2) + log_like2)

        from pymc3_tpu.node import apply as node_apply
        with pm.Model() as self.SMC_test:
            X = pm.Uniform("X", lower=-2, upper=2, shape=self.n)
            llk = pm.Potential("muh", node_apply(two_gaussians_logp, X))
        self.muref = mu1

    def test_sample_bimodal(self):
        trace = pm.sample_smc(draws=2000, model=self.SMC_test, random_seed=1,
                              n_steps=20)
        x = trace["X"]
        # dominant mode is mu2 = -0.5 (weight 0.9)
        mode_sign = np.sign(x.mean(axis=0))
        assert np.all(mode_sign == -1) or \
            np.mean(np.abs(x.mean(axis=0) + 0.5) < 0.2) > 0.5
        # both modes present?
        frac_pos = np.mean(x[:, 0] > 0)
        assert 0.01 < frac_pos < 0.4

    def test_marginal_likelihood(self):
        """Beta-binomial evidence is analytic (cf. test_smc.py ml check)."""
        data = np.repeat([1, 0], [50, 50]).astype(np.int32)
        marginals = []
        a_prior, b_prior = 1.0, 1.0
        with pm.Model() as model:
            a = pm.Beta("a", a_prior, b_prior)
            y = pm.Bernoulli("y", a, observed=data)
        trace = pm.sample_smc(2000, model=model, random_seed=2)
        # analytic log evidence: log B(a0+50, b0+50) - log B(a0,b0)
        from scipy.special import betaln
        expected = betaln(a_prior + 50, b_prior + 50) - \
            betaln(a_prior, b_prior)
        assert abs(trace.report.log_marginal_likelihood - expected) < 1.0


def test_smc_abc():
    """SMC-ABC with a Simulator (cf. ``smc.py:386`` PseudoLikelihood)."""
    np.random.seed(3)
    data = np.random.normal(loc=1.2, scale=1.0, size=200).astype(np.float32)

    def normal_sim(a, b):
        import jax
        import jax.numpy as jnp
        # jax-traceable simulator: moment-matched gaussian summary
        return a + b * jnp.zeros(200)

    with pm.Model() as model:
        a = pm.Normal("a", mu=0, sigma=5)
        b = pm.HalfNormal("b", sigma=2)
        s = pm.Simulator("s", normal_sim, a, b, observed=data)
    trace = pm.sample_smc(draws=1000, kernel="abc", epsilon=0.5,
                          model=model, random_seed=4)
    assert abs(trace["a"].mean() - data.mean()) < 0.5


def test_beta_stage_matches_host_bisection():
    """Device while_loop bisection (smc._beta_stage) reproduces the
    reference host algorithm (``pymc3/smc/smc.py:169-197``)."""
    import jax.numpy as jnp
    from pymc3_tpu.smc.smc import _beta_stage

    def host_bisect(ll, old_beta, threshold):
        def lse(a):
            amax = a.max()
            return float(np.log(np.sum(np.exp(a - amax))) + amax)
        low_beta = old_beta
        up_beta = 2.0
        rN = int(len(ll) * threshold)
        while up_beta - low_beta > 1e-6:
            new_beta = (low_beta + up_beta) / 2.0
            lw_un = (new_beta - old_beta) * ll
            lw = lw_un - lse(lw_un)
            ESS = int(np.exp(-lse(lw * 2)))
            if ESS == rN:
                break
            elif ESS < rN:
                up_beta = new_beta
            else:
                low_beta = new_beta
        if new_beta >= 1:
            new_beta = 1
            lw_un = (new_beta - old_beta) * ll
            lw = lw_un - lse(lw_un)
        lml_inc = lse(lw_un) - np.log(len(ll))
        w = np.exp(lw)
        return new_beta, w / w.sum(), lml_inc

    rng = np.random.default_rng(0)
    for old_beta, scale in [(0.0, 50.0), (0.3, 5.0), (0.9, 0.5)]:
        ll = -np.abs(rng.normal(size=512)) * scale
        b_host, w_host, lml_host = host_bisect(ll, old_beta, 0.5)
        b_dev, w_dev, lml_dev = _beta_stage(
            jnp.asarray(ll, jnp.float32), jnp.asarray(old_beta, jnp.float32),
            jnp.asarray(256, jnp.int32))
        assert abs(float(b_dev) - b_host) < 2e-5, (b_host, float(b_dev))
        np.testing.assert_allclose(np.asarray(w_dev), w_host, atol=1e-5)
        assert abs(float(lml_dev) - lml_host) < 1e-3


def test_particle_state_stays_on_device():
    """Between-stage particle state is device-resident: no full-particle
    numpy round trip."""
    import jax
    from pymc3_tpu.smc.smc import SMC

    with pm.Model() as model:
        x = pm.Normal("x", 0.0, 1.0, shape=2)
        pm.Normal("obs", mu=x.sum(), sigma=1.0, observed=np.array([0.3]))

    smc = SMC(draws=256, model=model, random_seed=4, n_steps=3)
    smc.initialize_population()
    smc.setup_kernel()
    smc.initialize_logp()
    for _ in range(3):
        if smc.beta >= 1:
            break
        smc.update_weights_beta()
        smc.resample()
        smc.update_proposal()
        smc.mutate()
        for name in ("posterior", "prior_logp", "likelihood_logp",
                     "acc_per_chain", "scalings", "weights", "chol"):
            assert isinstance(getattr(smc, name), jax.Array), name
        assert isinstance(smc.beta, float)
        assert isinstance(smc.acc_rate, float)


def test_indefinite_particle_cov_is_flagged():
    """A finite but numerically indefinite particle Gram matrix must be
    flagged via its NaN cholesky (advisor r3 medium: previously only
    isfinite(cov) was checked, so mutation silently proposed NaN deltas)."""
    import jax.numpy as jnp
    from pymc3_tpu.smc.smc import _particle_cov_chol
    # rank-deficient particles with large magnitudes: cov finite, chol NaN
    base = np.full((64,), 1e6, dtype=np.float32)
    X = np.stack([base, base + 1e-3]).T.astype(np.float32)  # (64, 2) nearly
    X = np.concatenate([X, X], axis=1)  # (64, 4) exactly rank-deficient
    cov, chol, ok = _particle_cov_chol(jnp.asarray(X))
    assert bool(np.isfinite(np.asarray(cov)).all())
    if not np.isfinite(np.asarray(chol)).all():
        assert not bool(ok)
    else:
        # platform factored it anyway: ok must then be True
        assert bool(ok)


class TestShardedSMC:
    """Particle-sharded SMC on the virtual device mesh (SURVEY §2.4 SMC
    particle parallelism; the round-5 scaling leg)."""

    def _run(self, devices):
        import jax
        with pm.Model() as model:
            x = pm.Normal("x", 0.0, 1.0, shape=2)
            pm.Normal("y", mu=x, sigma=0.5,
                      observed=np.array([1.0, -1.0], np.float32))
        trace = pm.sample_smc(draws=4096, model=model, random_seed=1,
                              devices=devices)
        return np.asarray(trace["x"])

    def test_sharded_matches_posterior(self):
        import jax
        xs = self._run(jax.devices()[:4])
        # conjugate posterior: mean y*(1/0.25)/(1+4) etc.
        post_mean = np.array([1.0, -1.0]) * (1 / 0.25) / (1 + 1 / 0.25)
        np.testing.assert_allclose(xs.mean(axis=0), post_mean, atol=0.1)

    def test_sharded_resample_indices_match_unsharded(self):
        """The sharding constraints in the resampling path must not
        change the selected indices (replicate-then-local-gather is a
        pure lowering change)."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from pymc3_tpu.parallel import make_mesh
        from pymc3_tpu.smc.smc import _systematic_indices
        mesh = make_mesh(jax.devices()[:4], axis_name="particles")
        sh = NamedSharding(mesh, P("particles"))
        key = jax.random.PRNGKey(3)
        w = jax.random.dirichlet(key, np.ones(4096, np.float32))
        idx_plain = np.asarray(_systematic_indices(key, w))
        idx_shard = np.asarray(_systematic_indices(
            key, jax.device_put(w, sh), sh))
        np.testing.assert_array_equal(idx_plain, idx_shard)
