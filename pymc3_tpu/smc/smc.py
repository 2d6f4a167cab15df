"""Sequential Monte Carlo kernel (cf. ``pymc3/smc/smc.py``).

Tempered-posterior SMC with **device-resident particle state**: the
``(draws, dim)`` particle array and its per-particle statistics
(prior/likelihood logp, per-chain acceptance, proposal scalings) live in
device memory for the whole run — between stages the host sees only scalars
(β, acceptance rate, log-evidence increment). Stage math maps to the
hardware as:

- β-bisection targeting ESS = threshold·N (reference
  ``update_weights_beta``, ``smc.py:169``) is a ``lax.while_loop`` of
  logsumexp reductions — one jitted call per stage.
- systematic resampling (reference multinomial, ``smc.py:201-213``) is a
  sorted-uniform ``searchsorted`` + gather, entirely on device.
- the MVN proposal covariance (``update_proposal``, ``smc.py:215``) is a
  centered ``XᵀX`` matmul + device cholesky.
- IMH mutation (``metrop_kernel``, ``smc.py:316``) is one jitted
  ``fori_loop`` chain vmapped over all particles, with β/chol/n_steps as
  runtime arguments so the program compiles ONCE for the whole run.

For multi-chip scale the particle axis shards over the mesh
(``pymc3_tpu.parallel``): per-particle logp and mutation run on the owning
chip, reductions become cross-device collectives, and cross-device data
movement happens only inside the resampling gather (SURVEY §2.4 "SMC
particle parallelism").
"""
from __future__ import annotations

import logging
from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

from ..config import floatX
from ..model import Point, modelcontext
from ..vartypes import discrete_types

logger = logging.getLogger("pymc3_tpu")

__all__ = ["SMC"]


# ---------------------------------------------------------------------------
# jitted stage kernels (module-level so the compile caches across SMC runs)
# ---------------------------------------------------------------------------
@jax.jit
def _beta_stage(ll_raw, old_beta, rN):
    """Bisect the next inverse temperature and build importance weights.

    Device analog of the reference's host loop (``smc.py:169-197``):
    carries (low, up, mid, ess) through a ``while_loop``; each iteration is
    two logsumexp reductions over the particle axis. Returns
    ``(new_beta, normalized weights, log-marginal-likelihood increment)``
    — two scalars and one device vector; nothing else leaves the chip.
    """
    dtype = ll_raw.dtype
    big_neg = jnp.asarray(-1e30, dtype)
    ll = jnp.where(jnp.isfinite(ll_raw), ll_raw, big_neg)
    n = ll.shape[0]

    def ess_int(nb):
        lw_un = (nb - old_beta) * ll
        lw = lw_un - logsumexp(lw_un)
        return jnp.floor(jnp.exp(-logsumexp(2.0 * lw))).astype(jnp.int32)

    def cond(c):
        low, up, _, e = c
        return ((up - low) > 1e-6) & (e != rN)

    def body(c):
        low, up, _, _ = c
        mid = 0.5 * (low + up)
        e = ess_int(mid)
        # ESS too small -> step too big -> shrink from above; too large ->
        # raise from below; exact hit exits via cond
        low2 = jnp.where(e > rN, mid, low)
        up2 = jnp.where(e < rN, mid, up)
        return (low2, up2, mid, e)

    low0 = jnp.asarray(old_beta, dtype)
    up0 = jnp.asarray(2.0, dtype)
    init = (low0, up0, low0, jnp.asarray(-1, jnp.int32))
    _, _, mid, _ = jax.lax.while_loop(cond, body, init)

    new_beta = jnp.where(mid >= 1.0, jnp.asarray(1.0, dtype), mid)
    lw_un = (new_beta - old_beta) * ll
    lse = logsumexp(lw_un)
    lml_inc = lse - jnp.log(jnp.asarray(n, dtype))
    w = jnp.exp(lw_un - lse)
    w = w / w.sum()
    return new_beta, w, lml_inc


@partial(jax.jit, static_argnums=(2,))
def _systematic_indices(key, weights, sharding=None):
    """Systematic resampling indices: one uniform offset, a cumsum, and a
    vectorized ``searchsorted`` — all on device (reference host path:
    ``np.searchsorted`` over the full particle set, ``smc.py:201-213``).

    Sharded case: the weight vector is REPLICATED first (one all-gather,
    4 MB at 1M f32 particles) so the cumsum runs locally — GSPMD lowers a
    cumsum ALONG a sharded axis into a collective-permute chain with a
    rendezvous per window (measured 82 s vs 13 ms at 1M x 2 CPU devices,
    round-5 scaling leg). The query positions stay sharded, so each
    device binary-searches only its own output rows and the returned
    index vector is sharded like the particle axis."""
    n = weights.shape[0]
    dtype = weights.dtype
    if sharding is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        rep = NamedSharding(sharding.mesh, P())
        weights = jax.lax.with_sharding_constraint(weights, rep)
    u = jax.random.uniform(key, (), dtype)
    positions = (u + jnp.arange(n, dtype=dtype)) / n
    if sharding is not None:
        positions = jax.lax.with_sharding_constraint(positions, sharding)
    cum = jnp.cumsum(weights)
    cum = cum / cum[-1]
    idx = jnp.searchsorted(cum, positions)
    return jnp.clip(idx, 0, n - 1)


from functools import partial as _partial


@_partial(jax.jit, static_argnums=(3,))
def _resample_gather(key, weights, arrays, sharding=None):
    """Gather every per-particle array through the systematic indices in a
    single jitted program (cross-device movement happens here and only
    here when the particle axis is mesh-sharded).

    Sharded case: replicate the SOURCE (one all-gather — 8 MB for 1M x 2
    f32 particles), keep the index vector sharded, and let each device
    gather its own output rows locally. Without the explicit constraints
    GSPMD lowers a take along the sharded axis into per-element
    cross-device collectives — measured 85 s/stage at 1M particles on a
    2-device mesh vs 6 ms for the local gather (round-5 scaling leg)."""
    idx = _systematic_indices(key, weights, sharding)
    if sharding is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        rep = NamedSharding(sharding.mesh, P())
        idx = jax.lax.with_sharding_constraint(idx, sharding)

        def g(a):
            a_rep = jax.lax.with_sharding_constraint(a, rep)
            return jax.lax.with_sharding_constraint(
                jnp.take(a_rep, idx, axis=0), sharding)

        return jax.tree_util.tree_map(g, arrays)
    return jax.tree_util.tree_map(lambda a: jnp.take(a, idx, axis=0), arrays)


@jax.jit
def _particle_cov_chol(X):
    """Proposal covariance of the (resampled, equally-weighted) particles
    as a centered Gram matmul + device cholesky
    (cf. ``np.cov`` + host cholesky, ``smc.py:215-224``)."""
    n = X.shape[0]
    mu = jnp.mean(X, axis=0)
    Xc = X - mu
    cov = (Xc.T @ Xc) / n
    cov = jnp.atleast_2d(cov) + 1e-6 * jnp.eye(X.shape[1], dtype=X.dtype)
    chol = jnp.linalg.cholesky(cov)
    # A float32 Gram matrix can be finite yet numerically indefinite beyond
    # the jitter, giving a NaN factor from a finite cov — validate BOTH so
    # update_proposal raises like the reference instead of silently
    # proposing NaN deltas (cf. np.linalg.cholesky raise, ``smc.py:215``).
    ok = jnp.isfinite(cov).all() & jnp.isfinite(chol).all()
    return cov, chol, ok


@jax.jit
def _tune_scalings(scalings, acc_per_chain):
    """Per-particle proposal-scale update toward the 0.234 acceptance
    target (cf. ``tune``, ``smc.py:226``), as device elementwise math."""
    target = jnp.asarray(0.234, scalings.dtype)
    ave = jnp.exp(jnp.log(scalings.mean()) + (acc_per_chain.mean() - target))
    return 0.5 * (ave + jnp.exp(jnp.log(scalings) +
                                (acc_per_chain - target)))


class SMC:
    """cf. ``smc/smc.py:42``."""

    def __init__(self, draws=1000, kernel="metropolis", n_steps=25,
                 parallel=False, start=None, cores=None, tune_steps=True,
                 p_acc_rate=0.99, threshold=0.5, epsilon=1.0, dist_func=None,
                 sum_stat=False, progressbar=False, model=None,
                 random_seed=-1, devices=None, mesh=None):
        self.draws = int(draws)
        # -- particle sharding over a device mesh (SURVEY §2.4 "SMC particle
        # parallelism"; replaces the reference's mp.Pool, smc/smc.py:156) ---
        self.sharding = None
        if mesh is None and devices is not None:
            from ..parallel import make_mesh
            mesh = make_mesh(devices, axis_name="particles")
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            n_dev = int(np.prod(mesh.devices.shape))
            if self.draws % n_dev != 0:
                raise ValueError(
                    f"draws ({self.draws}) must be a multiple of the device "
                    f"count ({n_dev}) for particle sharding")
            self.mesh = mesh
            self.sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
        self.kernel = kernel
        self.n_steps = int(n_steps)
        self.start = start
        self.tune_steps = tune_steps
        self.p_acc_rate = p_acc_rate
        self.threshold = threshold
        self.epsilon = epsilon
        self.model = modelcontext(model)
        if random_seed != -1 and random_seed is not None:
            np.random.seed(int(random_seed))
        self._key = jax.random.PRNGKey(np.random.randint(0, 2**31 - 1))

        self.beta = 0.0
        self.max_steps = n_steps
        self.proposed = self.draws * self.n_steps
        self.acc_rate = 1.0
        self.acc_per_chain = self._shard(jnp.ones(self.draws, floatX()))
        self.variables = self.model.free_RVs
        self.dimension = self.model.ordering.size
        self.scalings = self._shard(jnp.full(
            self.draws, min(1, 2.38 ** 2 / self.dimension), floatX()))
        self.discrete = np.concatenate([
            np.full(int(np.prod(v.unconstrained_shape, dtype=int)),
                    str(np.dtype(v.distribution.dtype)) in discrete_types)
            for v in self.variables]) if self.variables else np.array([])
        self.any_discrete = bool(self.discrete.any())
        self.all_discrete = bool(self.discrete.all())
        self.log_marginal_likelihood = 0.0

    def _split(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def _shard(self, x, axis_leading=True):
        """Place a particle-leading array on the mesh (no-op single-device).

        With a sharding set, jitted vmapped particle functions run SPMD:
        XLA partitions the particle axis across devices, per-particle logp
        and mutation execute on the owning device, and cross-device
        movement happens only at the resampling gather — the replacement
        for the reference's ``mp.Pool.starmap`` (``smc/smc.py:156-272``)."""
        arr = jnp.asarray(x)
        if self.sharding is None:
            return arr
        return jax.device_put(arr, self.sharding)

    # -- stages (cf. smc.py:101-330) -----------------------------------------
    def initialize_population(self):
        """Draw initial particles from the prior (cf. ``smc.py:101``)."""
        model = self.model
        if self.start is not None:
            pts = self.start if isinstance(self.start, list) else \
                [self.start] * self.draws
            self.posterior = self._shard(np.stack(
                [model.dict_to_array({k: p[k] for k in
                                      model.ordering.by_name})
                 for p in pts]).astype(floatX()))
            return
        fwd = model.sample_forward(self.draws)
        cols = []
        for vm in model.ordering.vmap:
            cols.append(np.asarray(fwd[vm.var]).reshape(self.draws, -1))
        self.posterior = self._shard(
            np.concatenate(cols, axis=1).astype(floatX()))

    def setup_kernel(self):
        """Compile tempered logp terms (cf. ``smc.py:127``; the reference's
        ``logp_forw`` compile boundary becomes jitted vmapped fns). The
        mutation chain compiles once here — β, chol, scalings and n_steps
        enter as runtime arguments, so retempering/retuning between stages
        does NOT retrace."""
        model = self.model
        prior_fn = model.varlogpt_fn()
        if self.kernel.lower() == "abc":
            like_fn = _make_abc_loglike(model, self.epsilon)
        else:
            like_fn = model.datalogpt_fn()
        self.prior_logp_fn = jax.jit(jax.vmap(prior_fn))
        self.likelihood_logp_fn = jax.jit(jax.vmap(like_fn))

        def particle_chain(key, q0, scaling, pl0, ll0, beta, chol, n_steps):
            dim = q0.shape[0]
            dtype = q0.dtype

            def body(_, carry):
                q, pl, ll, accs, key = carry
                key, k1, k2 = jax.random.split(key, 3)
                delta = (chol @ jax.random.normal(k1, (dim,), dtype)) \
                    * scaling
                q_prop = q + delta
                pl_p = prior_fn(q_prop)
                ll_p = like_fn(q_prop)
                mr = (pl_p + beta * ll_p) - (pl + beta * ll)
                mr = jnp.where(jnp.isnan(mr), -jnp.inf, mr)
                accept = jnp.log(jax.random.uniform(k2, (), dtype)) < mr
                q = jnp.where(accept, q_prop, q)
                pl = jnp.where(accept, pl_p, pl)
                ll = jnp.where(accept, ll_p, ll)
                return (q, pl, ll, accs + accept.astype(dtype), key)

            q, pl, ll, accs, _ = jax.lax.fori_loop(
                0, n_steps, body,
                (q0, pl0, ll0, jnp.zeros((), dtype), key))
            return q, pl, ll, accs / n_steps.astype(dtype)

        self._mutate_fn = jax.jit(jax.vmap(
            particle_chain, in_axes=(0, 0, 0, 0, 0, None, None, None)))

    def initialize_logp(self):
        """cf. ``smc.py:152`` — particle-sharded logp evaluation; results
        stay in device memory."""
        self.prior_logp = self.prior_logp_fn(self.posterior)
        self.likelihood_logp = self.likelihood_logp_fn(self.posterior)

    def update_weights_beta(self):
        """Bisection for the next β targeting ESS=threshold·N and accumulate
        the marginal likelihood (cf. ``smc.py:169-197``) — one jitted
        device program; only β and the evidence increment reach the host."""
        rN = int(self.draws * self.threshold)
        new_beta, weights, lml_inc = _beta_stage(
            self.likelihood_logp, jnp.asarray(self.beta, floatX()),
            jnp.asarray(rN, jnp.int32))
        self.beta = float(new_beta)
        self.weights = weights
        self.log_marginal_likelihood += float(lml_inc)

    def resample(self):
        """Systematic resampling as a device searchsorted-gather
        (cf. ``smc.py:201-213``)."""
        arrays = (self.posterior, self.prior_logp, self.likelihood_logp,
                  self.acc_per_chain, self.scalings)
        (self.posterior, self.prior_logp, self.likelihood_logp,
         self.acc_per_chain, self.scalings) = _resample_gather(
            self._split(), self.weights, arrays, self.sharding)
        self.tempered_posterior_logp = self.prior_logp + \
            self.beta * self.likelihood_logp

    def update_proposal(self):
        """MVN proposal from the particle covariance, computed as a centered
        Gram matmul + cholesky on device (cf. ``smc.py:215``)."""
        self.cov, self.chol, ok = _particle_cov_chol(self.posterior)
        if not bool(ok):
            raise ValueError('Sample covariances not valid! Likely "draws" '
                             "is too small!")

    def tune(self):
        """Tune scaling (device) and n_steps (host scalar)
        (cf. ``smc.py:226``: 0.234 acceptance target)."""
        self.scalings = _tune_scalings(self.scalings, self.acc_per_chain)
        if self.tune_steps:
            acc_rate = max(1.0 / self.proposed, self.acc_rate)
            self.n_steps = min(
                self.max_steps,
                max(2, int(np.log(1 - self.p_acc_rate) /
                           np.log(1 - acc_rate))))
        self.proposed = self.draws * self.n_steps

    def mutate(self):
        """Independent-MH mutation chains: one pre-compiled vmapped
        ``fori_loop`` over n_steps (cf. ``metrop_kernel``, ``smc.py:316``).
        Particle state stays on device; only the mean acceptance rate is
        pulled for the n_steps tuning heuristic."""
        keys = self._shard(jax.random.split(self._split(), self.draws))
        q, pl, ll, acc = self._mutate_fn(
            keys, self.posterior, self.scalings, self.prior_logp,
            self.likelihood_logp, jnp.asarray(self.beta, floatX()),
            self.chol.astype(floatX()),
            jnp.asarray(self.n_steps, jnp.int32))
        self.posterior = q
        self.prior_logp = pl
        self.likelihood_logp = ll
        self.acc_per_chain = acc
        self.acc_rate = float(acc.mean())

    def posterior_to_trace(self):
        """cf. ``smc.py:295`` — the run's single full device→host pull."""
        from ..backends.base import MultiTrace
        from ..backends.ndarray import NDArray
        model = self.model
        unobserved = model.unobserved_RVs
        from ..node import _ev

        @jax.jit
        def decode(q):
            env = model._env_from_q(q)
            memo = {}
            return [jnp.asarray(_ev(v, env, memo)) for v in unobserved]

        vals = jax.vmap(decode)(jnp.asarray(self.posterior))
        varnames = [v.name for v in unobserved]
        strace = NDArray(model=model, vars=unobserved)
        strace.setup(self.draws, 0)
        strace.record_batch({n: np.asarray(v)
                             for n, v in zip(varnames, vals)}, self.draws)
        strace.close()
        return MultiTrace([strace])


def _make_abc_loglike(model, epsilon):
    """Gaussian-kernel pseudo-likelihood over simulator distance
    (cf. ``PseudoLikelihood``, ``smc.py:386-461``).

    The simulator function must be jax-traceable for the on-device path; a
    numpy simulator falls back to ``jax.pure_callback``.
    """
    from ..distributions.simulator import Simulator
    sims = [rv for rv in model.observed_RVs
            if isinstance(rv.distribution, Simulator)]
    if not sims:
        raise ValueError("SMC-ABC requires a pm.Simulator observed variable")
    rv = sims[0]
    observed = jnp.asarray(rv.data, floatX())
    fn = rv.distribution.function
    params = rv.distribution.params
    from ..node import _ev

    def loglike(q):
        env = model._env_from_q(q)
        memo = {}
        vals = [_ev(p, env, memo) for p in params]
        try:
            sim = fn(*vals)
        except Exception:
            sim = jax.pure_callback(
                lambda *a: np.asarray(fn(*[np.asarray(x) for x in a]),
                                      dtype=floatX()),
                jax.ShapeDtypeStruct(observed.shape, observed.dtype), *vals)
        dist2 = jnp.mean((jnp.asarray(sim, floatX()) - observed) ** 2)
        return -dist2 / (2.0 * epsilon ** 2)
    return loglike
