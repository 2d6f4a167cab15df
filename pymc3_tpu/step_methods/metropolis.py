"""Metropolis samplers (cf. ``pymc3/step_methods/metropolis.py``).

Each stepper is a pure kernel over the flat vector: proposals are drawn with
``jax.random``, the accept ratio uses the traced joint logp (the reference's
compiled ``delta_logp``, ``metropolis.py:833``), and proposal-scale tuning
(``tune``, ``metropolis.py:211``) runs as branchless arithmetic every
``tune_interval`` draws inside the scan. Population methods (DEMetropolis)
operate on the full ``(chains, dim)`` array — the population is one device
array, crossover is a gather along the chain axis (SURVEY §2.4).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import floatX
from ..model import modelcontext
from ..vartypes import discrete_types
from .arraystep import ArrayStepShared, Competence, TuneContext

__all__ = [
    "Metropolis", "BinaryMetropolis", "BinaryGibbsMetropolis",
    "CategoricalGibbsMetropolis", "DEMetropolis", "DEMetropolisZ",
    "NormalProposal", "UniformProposal", "CauchyProposal", "LaplaceProposal",
    "PoissonProposal", "MultivariateNormalProposal",
]


# ---------------------------------------------------------------------------
# Proposal distributions (cf. metropolis.py:33-79)
# ---------------------------------------------------------------------------
class Proposal:
    def __init__(self, s):
        self.s = np.asarray(s)


class NormalProposal(Proposal):
    def sample(self, key, shape):
        return jax.random.normal(key, shape, floatX()) * jnp.asarray(
            self.s, floatX())


class UniformProposal(Proposal):
    def sample(self, key, shape):
        s = jnp.asarray(self.s, floatX())
        return jax.random.uniform(key, shape, floatX(), -s, s)


class CauchyProposal(Proposal):
    def sample(self, key, shape):
        return jax.random.cauchy(key, shape, floatX()) * jnp.asarray(
            self.s, floatX())


class LaplaceProposal(Proposal):
    def sample(self, key, shape):
        return jax.random.laplace(key, shape, floatX()) * jnp.asarray(
            self.s, floatX())


class PoissonProposal(Proposal):
    def sample(self, key, shape):
        lam = jnp.asarray(self.s, floatX())
        return (jax.random.poisson(key, lam, shape) - lam).astype(floatX())


class MultivariateNormalProposal(Proposal):
    def __init__(self, s):
        n, m = np.asarray(s).shape
        if n != m:
            raise ValueError("Covariance matrix is not symmetric.")
        self.n = n
        self.s = np.asarray(s)
        self.chol = np.linalg.cholesky(s)

    def sample(self, key, shape=None, num_draws=None):
        if num_draws is not None:
            z = jax.random.normal(key, (num_draws, self.n), floatX())
            return z @ jnp.asarray(self.chol.T, floatX())
        z = jax.random.normal(key, (self.n,), floatX())
        return jnp.asarray(self.chol, floatX()) @ z


# ---------------------------------------------------------------------------
# Scaling-tune table (cf. metropolis.py:211-248)
# ---------------------------------------------------------------------------
def tune_scaling(scale, acc_rate):
    """Branchless proposal-scale tuning from the acceptance rate over the
    last tune_interval draws (cf. ``tune``, ``metropolis.py:211``)."""
    factor = jnp.select(
        [acc_rate < 0.001, acc_rate < 0.05, acc_rate < 0.2,
         acc_rate > 0.95, acc_rate > 0.75, acc_rate > 0.5],
        [0.1, 0.5, 0.9, 10.0, 2.0, 1.1],
        1.0,
    ).astype(floatX())
    return scale * factor


class MetropolisState(NamedTuple):
    logp: jnp.ndarray
    scaling: jnp.ndarray
    accept_sum: jnp.ndarray   # accepted draws since last tune
    since_tune: jnp.ndarray   # draws since last tune


class Metropolis(ArrayStepShared):
    """Random-walk Metropolis (cf. ``metropolis.py:81``)."""

    name = "metropolis"
    default_blocked = False
    generates_stats = True
    stats_dtypes = [{
        "accept": np.float64,
        "accepted": bool,
        "tune": bool,
        "scaling": np.float64,
    }]

    def __init__(self, vars=None, S=None, proposal_dist=None, scaling=1.0,
                 tune=True, tune_interval=100, model=None, mode=None,
                 blocked=False, **kwargs):
        model = modelcontext(model)
        if vars is None:
            vars = model.free_RVs
        self._setup_vars(vars, model)
        self.blocked = blocked

        if S is None:
            S = np.ones(self.dim)
        if proposal_dist is not None:
            self.proposal_dist = proposal_dist(S)
        elif np.asarray(S).ndim == 1:
            self.proposal_dist = NormalProposal(S)
        elif np.asarray(S).ndim == 2:
            self.proposal_dist = MultivariateNormalProposal(S)
        else:
            raise ValueError(f"Invalid rank for variance: {np.asarray(S).ndim}")

        self.scaling = float(np.atleast_1d(scaling)[0])
        self.tune = bool(tune)
        self.tune_interval = int(tune_interval)

        # discrete-variable mask: proposals are rounded for discrete dims
        # (cf. metropolis.py:160-176)
        disc = np.zeros(self.dim, dtype=bool)
        off = 0
        for v in self.vars:
            n = int(np.prod(v.unconstrained_shape, dtype=int))
            if str(np.dtype(v.distribution.dtype)) in discrete_types:
                disc[off:off + n] = True
            off += n
        self.discrete = disc
        self.any_discrete = bool(disc.any())
        self.all_discrete = bool(disc.all())

        self._logp_fn = model.make_logp_fn()
        self._sub_idx = jnp.asarray(self.q_indices, jnp.int32)

    def kernel_init(self, q0):
        q0 = jnp.asarray(q0, floatX())
        return MetropolisState(
            logp=self._logp_fn(q0),
            scaling=jnp.asarray(self.scaling, floatX()),
            accept_sum=jnp.asarray(0.0, floatX()),
            since_tune=jnp.asarray(0, jnp.int32),
        )

    def kernel_step(self, key, q, state: MetropolisState, tctx: TuneContext):
        q = jnp.asarray(q, floatX())
        logp0 = self._refresh_logp(q, state.logp)
        k_prop, k_acc = jax.random.split(key)

        delta_sub = self.proposal_dist.sample(k_prop, (self.dim,)) \
            * state.scaling
        delta = jnp.zeros_like(q).at[self._sub_idx].set(delta_sub)

        if self.any_discrete:
            disc = jnp.zeros(q.shape, bool).at[self._sub_idx].set(
                jnp.asarray(self.discrete))
            q_prop = jnp.where(disc, jnp.round(q + delta), q + delta)
        else:
            q_prop = q + delta

        logp_prop = self._logp_fn(q_prop)
        mr = logp_prop - logp0
        mr = jnp.where(jnp.isnan(mr), -jnp.inf, mr)
        accepted = jnp.log(jax.random.uniform(k_acc, (), floatX())) < mr
        q_new = jnp.where(accepted, q_prop, q)
        logp_new = jnp.where(accepted, logp_prop, logp0)

        # scale tuning every tune_interval draws during warmup
        since = state.since_tune + 1
        acc_sum = state.accept_sum + accepted.astype(floatX())
        do_tune = tctx.tune & self.tune & (since >= self.tune_interval)
        acc_rate = acc_sum / since.astype(floatX())
        scaling = jnp.where(do_tune, tune_scaling(state.scaling, acc_rate),
                            state.scaling)
        since = jnp.where(do_tune, 0, since)
        acc_sum = jnp.where(do_tune, 0.0, acc_sum)

        stats = {
            "accept": jnp.exp(jnp.minimum(mr, 0.0)),
            "accepted": accepted,
            "tune": tctx.tune,
            "scaling": scaling,
        }
        return q_new, MetropolisState(logp_new, scaling, acc_sum, since), stats

    @staticmethod
    def competence(var, has_grad=False):
        return Competence.COMPATIBLE


class BinaryState(NamedTuple):
    logp: jnp.ndarray


class BinaryMetropolis(ArrayStepShared):
    """Metropolis for binary variables (cf. ``metropolis.py:248``):
    flips each included dimension with probability scaling/dim."""

    name = "binary_metropolis"
    generates_stats = True
    stats_dtypes = [{
        "accept": np.float64,
        "tune": bool,
        "p_jump": np.float64,
    }]

    def __init__(self, vars, scaling=1.0, tune=True, tune_interval=100,
                 model=None, **kwargs):
        model = modelcontext(model)
        self._setup_vars(vars, model)
        self.scaling = float(scaling)
        self.tune = bool(tune)
        self._logp_fn = model.make_logp_fn()
        self._sub_idx = jnp.asarray(self.q_indices, jnp.int32)
        for v in self.vars:
            if not _is_binary(v):
                raise ValueError("All variables must be Bernoulli for "
                                 "BinaryMetropolis")

    def kernel_init(self, q0):
        return BinaryState(logp=self._logp_fn(jnp.asarray(q0, floatX())))

    def kernel_step(self, key, q, state, tctx):
        q = jnp.asarray(q, floatX())
        k_flip, k_acc = jax.random.split(key)
        # flip each dim w.p. p_jump
        p_jump = jnp.minimum(0.5, self.scaling / self.dim) * 2
        flips = jax.random.bernoulli(k_flip, p_jump, (self.dim,))
        sub = q[self._sub_idx]
        sub_prop = jnp.where(flips, 1.0 - sub, sub)
        q_prop = q.at[self._sub_idx].set(sub_prop)
        logp0 = self._refresh_logp(q, state.logp)
        logp_prop = self._logp_fn(q_prop)
        mr = logp_prop - logp0
        mr = jnp.where(jnp.isnan(mr), -jnp.inf, mr)
        accepted = jnp.log(jax.random.uniform(k_acc, (), floatX())) < mr
        q_new = jnp.where(accepted, q_prop, q)
        logp_new = jnp.where(accepted, logp_prop, logp0)
        stats = {
            "accept": jnp.exp(jnp.minimum(mr, 0.0)),
            "tune": tctx.tune,
            "p_jump": p_jump,
        }
        return q_new, BinaryState(logp_new), stats

    @staticmethod
    def competence(var, has_grad=False):
        if _is_binary(var):
            return Competence.COMPATIBLE
        return Competence.INCOMPATIBLE


class BinaryGibbsMetropolis(ArrayStepShared):
    """Gibbs-style scan over binary dimensions in (shuffled) order
    (cf. ``metropolis.py:328``)."""

    name = "binary_gibbs_metropolis"
    generates_stats = True
    stats_dtypes = [{"tune": bool}]

    def __init__(self, vars, order="random", transit_p=0.8, model=None,
                 **kwargs):
        model = modelcontext(model)
        self._setup_vars(vars, model)
        self.transit_p = float(transit_p)
        self.shuffle = (order == "random")
        self._order = np.arange(self.dim) if order == "random" \
            else np.asarray(order)
        self._logp_fn = model.make_logp_fn()
        self._sub_idx = jnp.asarray(self.q_indices, jnp.int32)
        for v in self.vars:
            if not _is_binary(v):
                raise ValueError("All variables must be Bernoulli for "
                                 "BinaryGibbsMetropolis")

    def kernel_init(self, q0):
        return BinaryState(logp=self._logp_fn(jnp.asarray(q0, floatX())))

    def kernel_step(self, key, q, state, tctx):
        q = jnp.asarray(q, floatX())
        k_perm, k_scan = jax.random.split(key)
        order = jnp.asarray(self._order, jnp.int32)
        if self.shuffle:
            order = jax.random.permutation(k_perm, order)

        def body(carry, i):
            q, logp, key = carry
            key, k_t, k_a = jax.random.split(key, 3)
            gidx = self._sub_idx[i]
            curr = q[gidx]
            do_prop = jax.random.bernoulli(k_t, self.transit_p)
            q_prop = q.at[gidx].set(jnp.where(do_prop, 1.0 - curr, curr))
            logp_prop = self._logp_fn(q_prop)
            mr = jnp.where(jnp.isnan(logp_prop - logp), -jnp.inf,
                           logp_prop - logp)
            accepted = do_prop & (
                jnp.log(jax.random.uniform(k_a, (), floatX())) < mr)
            q = jnp.where(accepted, q_prop, q)
            logp = jnp.where(accepted, logp_prop, logp)
            return (q, logp, key), None

        (q_new, logp_new, _), _ = jax.lax.scan(
            body, (q, self._refresh_logp(q, state.logp), k_scan), order)
        return q_new, BinaryState(logp_new), {"tune": tctx.tune}

    @staticmethod
    def competence(var, has_grad=False):
        if _is_binary(var):
            return Competence.IDEAL
        return Competence.INCOMPATIBLE


class CategoricalGibbsMetropolis(ArrayStepShared):
    """Gibbs scan over categorical dimensions with proportional or
    uniform-jump proposals (cf. ``metropolis.py:406``)."""

    name = "categorical_gibbs_metropolis"
    generates_stats = True
    stats_dtypes = [{"tune": bool}]

    def __init__(self, vars, proposal="uniform", order="random", model=None,
                 **kwargs):
        model = modelcontext(model)
        self._setup_vars(vars, model)
        # number of categories per flat dim
        ks = []
        for v in self.vars:
            dist = v.distribution
            k = getattr(dist, "k", None)
            if k is None:
                p = getattr(dist, "p", None)
                k = int(np.shape(p.test_value)[-1]) if p is not None else 2
            k = int(np.asarray(k).item()) if np.ndim(k) == 0 else int(k)
            if k < 2:
                raise ValueError("All variables must be categorical or "
                                 "binary for CategoricalGibbsMetropolis")
            n = int(np.prod(v.unconstrained_shape, dtype=int))
            ks.extend([k] * n)
        self._k = np.asarray(ks, dtype=np.int32)
        self.max_k = int(self._k.max()) if len(ks) else 2
        self.proposal = proposal
        self.shuffle = (order == "random")
        self._order = np.arange(self.dim)
        self._logp_fn = model.make_logp_fn()
        self._sub_idx = jnp.asarray(self.q_indices, jnp.int32)

    def kernel_init(self, q0):
        return BinaryState(logp=self._logp_fn(jnp.asarray(q0, floatX())))

    def kernel_step(self, key, q, state, tctx):
        q = jnp.asarray(q, floatX())
        k_perm, k_scan = jax.random.split(key)
        order = jnp.asarray(self._order, jnp.int32)
        if self.shuffle:
            order = jax.random.permutation(k_perm, order)
        kvec = jnp.asarray(self._k, jnp.int32)

        def body(carry, i):
            q, logp, key = carry
            key, k_p, k_a = jax.random.split(key, 3)
            gidx = self._sub_idx[i]
            k_cat = kvec[i]
            curr = q[gidx].astype(jnp.int32)
            # uniform jump to one of the other k-1 categories
            jump = jax.random.randint(k_p, (), 1, self.max_k)
            jump = 1 + jump % (k_cat - 1)
            prop = (curr + jump) % k_cat
            q_prop = q.at[gidx].set(prop.astype(floatX()))
            logp_prop = self._logp_fn(q_prop)
            mr = jnp.where(jnp.isnan(logp_prop - logp), -jnp.inf,
                           logp_prop - logp)
            accepted = jnp.log(jax.random.uniform(k_a, (), floatX())) < mr
            q = jnp.where(accepted, q_prop, q)
            logp = jnp.where(accepted, logp_prop, logp)
            return (q, logp, key), None

        (q_new, logp_new, _), _ = jax.lax.scan(
            body, (q, self._refresh_logp(q, state.logp), k_scan), order)
        return q_new, BinaryState(logp_new), {"tune": tctx.tune}

    @staticmethod
    def competence(var, has_grad=False):
        dist = _effective_dist(var)
        if type(dist).__name__ == "Categorical":
            k = getattr(dist, "k", None)
            try:
                k = int(np.asarray(k if not hasattr(k, "test_value")
                                   else k.test_value).item())
            except Exception:
                k = 3
            return Competence.IDEAL if k > 2 else Competence.COMPATIBLE
        if _is_binary(var):
            return Competence.COMPATIBLE
        return Competence.INCOMPATIBLE


def _effective_dist(var_or_dist):
    """The distribution that determines sampler competence — imputation
    placeholders (NoDistribution, model.py:278) defer to their parent."""
    dist = getattr(var_or_dist, "distribution", var_or_dist)
    parent = getattr(dist, "parent_dist", None)
    return parent if parent is not None else dist


def _is_binary(var):
    dist = _effective_dist(var)
    return type(dist).__name__ == "Bernoulli" or \
        (type(dist).__name__ == "Categorical" and
         _cat_k(dist) == 2)


def _cat_k(dist):
    k = getattr(dist, "k", None)
    try:
        return int(np.asarray(k if not hasattr(k, "test_value")
                              else k.test_value).item())
    except Exception:
        return 0


# ---------------------------------------------------------------------------
# Differential evolution (population) methods
# ---------------------------------------------------------------------------
class DEMState(NamedTuple):
    logp: jnp.ndarray       # (chains,)
    scaling: jnp.ndarray
    accept_sum: jnp.ndarray
    since_tune: jnp.ndarray


class DEMetropolis(ArrayStepShared):
    """Differential-evolution Metropolis over a chain population
    (cf. ``metropolis.py:524``).

    The kernel steps the FULL population at once: the population lives as one
    ``(chains, dim)`` device array and crossover is a random gather along the
    chain axis — the vectorized analog of the reference's cross-process
    ``link_population`` broadcast (``arraystep.py:216``).
    """

    name = "DEMetropolis"
    population_based = True
    generates_stats = True
    stats_dtypes = [{
        "accept": np.float64,
        "accepted": bool,
        "tune": bool,
        "scaling": np.float64,
        "lambda": np.float64,
    }]

    def __init__(self, vars=None, S=None, proposal_dist=None, lamb=None,
                 scaling=0.001, tune=None, tune_interval=100, model=None,
                 **kwargs):
        model = modelcontext(model)
        if vars is None:
            vars = model.cont_vars
        self._setup_vars(vars, model)
        self.scaling = float(np.atleast_1d(scaling)[0])
        if lamb is None:
            lamb = 2.38 / np.sqrt(2 * self.dim)
        self.lamb = float(lamb)
        if tune not in {None, "scaling", "lambda"}:
            raise ValueError(
                'The parameter "tune" must be one of {None, scaling, lambda}')
        self.tune_target = tune
        self.tune = True
        self.tune_interval = int(tune_interval)
        self._logp_fn = model.make_logp_fn()
        self._sub_idx = jnp.asarray(self.q_indices, jnp.int32)

    def kernel_init(self, Q0):
        Q0 = jnp.asarray(Q0, floatX())
        logp = jax.vmap(self._logp_fn)(Q0)
        return DEMState(logp=logp,
                        scaling=jnp.asarray(self.scaling, floatX()),
                        accept_sum=jnp.asarray(0.0, floatX()),
                        since_tune=jnp.asarray(0, jnp.int32))

    def population_kernel_step(self, key, Q, state: DEMState,
                               tctx: TuneContext):
        """Step all chains at once. ``Q`` is (chains, dim)."""
        Q = jnp.asarray(Q, floatX())
        nchains = Q.shape[0]
        k_r1, k_r2, k_eps, k_acc = jax.random.split(key, 4)

        # pick two distinct random other chains per chain
        i = jnp.arange(nchains)
        r1 = jax.random.randint(k_r1, (nchains,), 0, nchains - 1)
        r1 = jnp.where(r1 >= i, r1 + 1, r1)
        r2 = jax.random.randint(k_r2, (nchains,), 0, nchains - 1)
        r2 = jnp.where(r2 >= i, r2 + 1, r2)

        eps = jax.random.normal(k_eps, Q.shape, floatX()) * state.scaling
        delta = self.lamb * (Q[r1] - Q[r2]) + eps
        mask = jnp.zeros(Q.shape[-1], floatX()).at[self._sub_idx].set(1.0)
        Q_prop = Q + delta * mask

        logp0 = jax.vmap(self._logp_fn)(Q) if self.is_partial else state.logp
        logp_prop = jax.vmap(self._logp_fn)(Q_prop)
        mr = logp_prop - logp0
        mr = jnp.where(jnp.isnan(mr), -jnp.inf, mr)
        u = jax.random.uniform(k_acc, (nchains,), floatX())
        accepted = jnp.log(u) < mr
        Q_new = jnp.where(accepted[:, None], Q_prop, Q)
        logp_new = jnp.where(accepted, logp_prop, logp0)

        since = state.since_tune + 1
        acc_sum = state.accept_sum + jnp.mean(accepted.astype(floatX()))
        do_tune = tctx.tune & (self.tune_target == "scaling") & \
            (since >= self.tune_interval)
        acc_rate = acc_sum / since.astype(floatX())
        scaling = jnp.where(do_tune, tune_scaling(state.scaling, acc_rate),
                            state.scaling)
        since = jnp.where(do_tune, 0, since)
        acc_sum = jnp.where(do_tune, 0.0, acc_sum)

        stats = {
            "accept": jnp.exp(jnp.minimum(mr, 0.0)),
            "accepted": accepted,
            "tune": jnp.broadcast_to(tctx.tune, (nchains,)),
            "scaling": jnp.broadcast_to(scaling, (nchains,)),
            "lambda": jnp.full((nchains,), self.lamb, floatX()),
        }
        return Q_new, DEMState(logp_new, scaling, acc_sum, since), stats

    @staticmethod
    def competence(var, has_grad=False):
        dist = getattr(var, "distribution", None)
        from ..vartypes import continuous_types
        dtype = getattr(dist, "dtype", None) or getattr(var, "dtype", None)
        if str(np.dtype(dtype)) in continuous_types:
            return Competence.COMPATIBLE
        return Competence.INCOMPATIBLE


class DEMZState(NamedTuple):
    logp: jnp.ndarray
    scaling: jnp.ndarray
    lamb: jnp.ndarray
    accept_sum: jnp.ndarray
    since_tune: jnp.ndarray
    history: jnp.ndarray    # (capacity, dim) preallocated past samples
    hist_len: jnp.ndarray   # int32


class DEMetropolisZ(ArrayStepShared):
    """DE-MCMC-Z: differential evolution against the chain's own history
    (cf. ``metropolis.py:648``)."""

    name = "DEMetropolisZ"
    generates_stats = True
    stats_dtypes = [{
        "accept": np.float64,
        "accepted": bool,
        "tune": bool,
        "scaling": np.float64,
        "lambda": np.float64,
    }]

    def __init__(self, vars=None, S=None, proposal_dist=None, lamb=None,
                 scaling=0.001, tune="lambda", tune_interval=100,
                 tune_drop_fraction=0.9, model=None, history_capacity=5000,
                 **kwargs):
        model = modelcontext(model)
        if vars is None:
            vars = model.cont_vars
        self._setup_vars(vars, model)
        self.scaling = float(np.atleast_1d(scaling)[0])
        if lamb is None:
            lamb = 2.38 / np.sqrt(2 * self.dim)
        self.lamb = float(lamb)
        if tune not in {None, "scaling", "lambda"}:
            raise ValueError(
                'The parameter "tune" must be one of {None, scaling, lambda}')
        self.tune_target = tune
        self.tune = True
        self.tune_interval = int(tune_interval)
        self.tune_drop_fraction = float(tune_drop_fraction)
        self.capacity = int(history_capacity)
        self._logp_fn = model.make_logp_fn()
        self._sub_idx = jnp.asarray(self.q_indices, jnp.int32)

    def kernel_init(self, q0):
        q0 = jnp.asarray(q0, floatX())
        return DEMZState(
            logp=self._logp_fn(q0),
            scaling=jnp.asarray(self.scaling, floatX()),
            lamb=jnp.asarray(self.lamb, floatX()),
            accept_sum=jnp.asarray(0.0, floatX()),
            since_tune=jnp.asarray(0, jnp.int32),
            history=jnp.zeros((self.capacity, q0.shape[-1]), floatX()),
            hist_len=jnp.asarray(0, jnp.int32),
        )

    def kernel_step(self, key, q, state: DEMZState, tctx: TuneContext):
        q = jnp.asarray(q, floatX())
        k_i1, k_i2, k_eps, k_acc = jax.random.split(key, 4)

        eps = jax.random.normal(k_eps, q.shape, floatX()) * state.scaling
        # DE term from two random history points once we have >= 2
        hl = jnp.maximum(state.hist_len, 1)
        i1 = jax.random.randint(k_i1, (), 0, hl)
        i2 = jax.random.randint(k_i2, (), 0, hl)
        z1 = state.history[i1]
        z2 = state.history[i2]
        de = jnp.where(state.hist_len >= 2, state.lamb * (z1 - z2), 0.0)
        delta = de + eps
        mask = jnp.zeros(q.shape[-1], floatX()).at[self._sub_idx].set(1.0)
        q_prop = q + delta * mask

        logp0 = self._refresh_logp(q, state.logp)
        logp_prop = self._logp_fn(q_prop)
        mr = logp_prop - logp0
        mr = jnp.where(jnp.isnan(mr), -jnp.inf, mr)
        accepted = jnp.log(jax.random.uniform(k_acc, (), floatX())) < mr
        q_new = jnp.where(accepted, q_prop, q)
        logp_new = jnp.where(accepted, logp_prop, logp0)

        # record into ring buffer
        slot = state.hist_len % self.capacity
        history = state.history.at[slot].set(q_new)
        hist_len = jnp.minimum(state.hist_len + 1, 2**30)

        since = state.since_tune + 1
        acc_sum = state.accept_sum + accepted.astype(floatX())
        do_tune = tctx.tune & (since >= self.tune_interval)
        acc_rate = acc_sum / since.astype(floatX())
        scaling = jnp.where(do_tune & (self.tune_target == "scaling"),
                            tune_scaling(state.scaling, acc_rate),
                            state.scaling)
        lamb = jnp.where(do_tune & (self.tune_target == "lambda"),
                         tune_scaling(state.lamb, acc_rate), state.lamb)
        since = jnp.where(do_tune, 0, since)
        acc_sum = jnp.where(do_tune, 0.0, acc_sum)

        stats = {
            "accept": jnp.exp(jnp.minimum(mr, 0.0)),
            "accepted": accepted,
            "tune": tctx.tune,
            "scaling": scaling,
            "lambda": lamb,
        }
        return q_new, DEMZState(logp_new, scaling, lamb, acc_sum, since,
                                history, hist_len), stats

    @staticmethod
    def competence(var, has_grad=False):
        return DEMetropolis.competence(var, has_grad)
