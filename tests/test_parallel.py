"""Multi-device chain-parallelism tests on the 8-virtual-device CPU mesh.

The reference tests its process-based communication backend by exercising
the real pipe protocol in-process (``pymc3/tests/test_parallel_sampling.py:
19-73``, no mocks). The analog here: drive the real ``shard_map``
path — sharded end-to-end sampling, the exact pooled-Welford ``psum`` merge,
block-carry continuity, and the chain/device divisibility contract — on the
virtual 8-device CPU mesh set up by the root conftest.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import pymc3_tpu as pm
from pymc3_tpu.parallel import (
    CHAIN_AXIS, LOCAL_CHAIN_AXIS, make_mesh, pooled_axes, shard_block_fn,
    shard_chain_fn,
)
from pymc3_tpu.step_methods.hmc.quadpotential import (
    welford_add, welford_init, welford_merge_psum, welford_var,
)


def eight_schools():
    y = np.array([28., 8., -3., 7., -1., 1., 18., 12.])
    s = np.array([15., 10., 16., 11., 9., 11., 10., 18.])
    with pm.Model() as m:
        mu = pm.Normal("mu", 0., 5.)
        tau = pm.HalfCauchy("tau", 5.)
        th = pm.Normal("th", 0., 1., shape=8)
        pm.Normal("obs", mu=mu + tau * th, sigma=s, observed=y)
    return m


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_welford_psum_merge_is_exact():
    """Pooled cross-shard Welford merge == numpy moments of the pooled data
    (cf. ``_WeightedVariance.add_sample``, ``quadpotential.py:336-342``)."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(8, 50, 3)).astype(np.float32)

    def shard_fn(xs):
        st = welford_init(3)

        def body(st, x):
            return welford_add(st, x), None

        st, _ = jax.lax.scan(body, st, xs)
        return welford_merge_psum(st, "shards")

    merged = jax.vmap(shard_fn, axis_name="shards")(jnp.asarray(data))
    flat = data.reshape(-1, 3).astype(np.float64)
    exp_mean = flat.mean(0)
    exp_m2 = ((flat - exp_mean) ** 2).sum(0)
    for i in range(8):  # every shard sees the identical pooled state
        np.testing.assert_allclose(np.asarray(merged.w)[i], 400.0)
        np.testing.assert_allclose(np.asarray(merged.mean)[i], exp_mean,
                                   rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(merged.m2)[i], exp_m2,
                                   rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(welford_var(type(merged)(merged.w[0], merged.mean[0],
                                            merged.m2[0]))),
        flat.var(0), rtol=2e-4)


def test_sharded_sampling_statistically_equals_vmap():
    """End-to-end: mesh-sharded chains and vmap-only chains target the same
    posterior (eight-schools; same per-chain seeds)."""
    model = eight_schools()
    kw = dict(draws=500, tune=500, chains=8, model=model, progressbar=False,
              random_seed=42, compute_convergence_checks=False)
    tr_vmap = pm.sample(**kw)
    tr_shard = pm.sample(devices=jax.devices(), **kw)
    for var in ("mu", "tau"):
        a = np.asarray(tr_vmap.get_values(var), dtype=np.float64)
        b = np.asarray(tr_shard.get_values(var), dtype=np.float64)
        mcse = a.std() / np.sqrt(200.0)  # conservative ESS floor
        assert abs(a.mean() - b.mean()) < 5 * mcse, (var, a.mean(), b.mean())
        assert abs(a.std() - b.std()) < 0.5 * a.std()


def test_pooled_adaptation_quality():
    """Pooled cross-chain mass-matrix adaptation (psum over the vmap chain
    axis) converges at least as well as per-chain adaptation — the
    validation SURVEY §7 flags as a hard part."""
    model = eight_schools()
    kw = dict(draws=500, tune=500, chains=8, model=model, progressbar=False,
              random_seed=7, compute_convergence_checks=False)
    tr_per = pm.sample(**kw)
    tr_pool = pm.sample(axis_name=LOCAL_CHAIN_AXIS, **kw)
    mu_per = np.asarray(tr_per.get_values("mu"), dtype=np.float64)
    mu_pool = np.asarray(tr_pool.get_values("mu"), dtype=np.float64)
    assert abs(mu_per.mean() - mu_pool.mean()) < 1.0
    rhat_pool = float(np.asarray(pm.rhat(tr_pool, var_names=["mu"])["mu"]))
    assert rhat_pool < 1.05


def test_chains_must_divide_devices():
    model = eight_schools()
    with pytest.raises(ValueError, match="multiple of the device count"):
        pm.sample(draws=10, tune=10, chains=6, model=model,
                  devices=jax.devices(), progressbar=False,
                  compute_convergence_checks=False)


def test_sharded_decode_roundtrip():
    """Constrained values recorded from the sharded path are consistent with
    their unconstrained counterparts (transform round-trip)."""
    model = eight_schools()
    tr = pm.sample(draws=100, tune=100, chains=8, model=model,
                   devices=jax.devices(), progressbar=False, random_seed=3,
                   compute_convergence_checks=False)
    tau = np.asarray(tr.get_values("tau"))
    tau_log = np.asarray(tr.get_values("tau_log__"))
    np.testing.assert_allclose(tau, np.exp(tau_log), rtol=1e-5)
    assert np.all(tau > 0)


def test_shard_block_fn_carry_continuity():
    """The chunked-scan carry survives across block invocations unchanged —
    the streaming driver's core contract."""
    def chain_block(carry, idxs):
        def one(c, idx):
            key, q, st = c
            q = q + 1.0
            return (key, q, st + 1), (q, idx)

        return jax.lax.scan(one, carry, idxs)

    run = shard_block_fn(chain_block, devices=jax.devices())
    chains = 16
    keys = jax.random.split(jax.random.PRNGKey(0), chains)
    q0 = jnp.zeros((chains, 3))
    st0 = jnp.zeros((chains,), jnp.int32)
    carry = (keys, q0, st0)
    carry, (q_blk1, idx1) = run(carry, jnp.arange(0, 5, dtype=jnp.int32))
    carry, (q_blk2, idx2) = run(carry, jnp.arange(5, 10, dtype=jnp.int32))
    np.testing.assert_allclose(np.asarray(carry[1]), 10.0)
    assert np.all(np.asarray(carry[2]) == 10)
    # outputs are (chains, block, ...) and consecutive across blocks
    np.testing.assert_allclose(np.asarray(q_blk1)[:, -1], 5.0)
    np.testing.assert_allclose(np.asarray(q_blk2)[:, 0], 6.0)
    assert np.all(np.asarray(idx2)[:, 0] == 5)


class TestShardedSMC:
    """Particle-sharded SMC over the mesh (SURVEY §2.4 "SMC particle
    parallelism"; replaces the reference's mp.Pool at smc/smc.py:156)."""

    def test_evidence_sharded_matches_closed_form(self):
        data = np.repeat([1, 0], [50, 50]).astype(np.int32)
        a_prior, b_prior = 1.0, 1.0
        with pm.Model() as model:
            a = pm.Beta("a", a_prior, b_prior)
            pm.Bernoulli("y", a, observed=data)
        trace = pm.sample_smc(2048, model=model, random_seed=2,
                              devices=jax.devices())
        from scipy.special import betaln
        expected = betaln(a_prior + 50, b_prior + 50) - betaln(a_prior,
                                                               b_prior)
        assert abs(trace.report.log_marginal_likelihood - expected) < 1.0

    def test_draws_must_divide_devices(self):
        with pm.Model() as model:
            pm.Normal("x", 0.0, 1.0)
            with pytest.raises(ValueError, match="multiple of the device"):
                pm.sample_smc(1000, model=model, devices=jax.devices()[:3])

    def test_million_particles_multimodal(self):
        """1M particles sharded across the virtual mesh resolve a bimodal
        target's mass split (BASELINE target 5 correctness config)."""
        with pm.Model() as model:
            pm.NormalMixture("x", w=[0.3, 0.7], mu=[-4.0, 4.0],
                             sigma=[1.0, 1.0])
        trace = pm.sample_smc(1_000_000, n_steps=3, model=model,
                              random_seed=5, devices=jax.devices())
        x = np.asarray(trace.get_values("x")).ravel()
        assert x.shape[0] == 1_000_000
        frac_hi = float(np.mean(x > 0))
        assert 0.6 < frac_hi < 0.8, frac_hi
        # both modes located correctly
        assert abs(np.median(x[x > 0]) - 4.0) < 0.5
        assert abs(np.median(x[x < 0]) + 4.0) < 0.5


def test_pooled_psum_both_axes():
    """psum over ``pooled_axes(CHAIN_AXIS)`` spans local vmap chains AND the
    mesh axis: the total equals the global chain count."""
    devices = jax.devices()

    def chain_fn(key, q):
        total = jax.lax.psum(jnp.asarray(1.0), pooled_axes(CHAIN_AXIS))
        return q * 0 + total, total

    run = shard_chain_fn(chain_fn, devices=devices)
    chains = 16
    keys = jax.random.split(jax.random.PRNGKey(0), chains)
    q0 = jnp.zeros((chains, 2))
    out, totals = run(keys, q0)
    np.testing.assert_allclose(np.asarray(totals), float(chains))
