"""No-U-Turn Sampler (cf. ``pymc3/step_methods/hmc/nuts.py``).

The reference builds the trajectory tree by *Python recursion* with
data-dependent control flow (``_Tree.extend`` / ``_build_subtree``,
``nuts.py:220-389``) — up to 1023 leapfrog calls per draw, each crossing the
Python/C boundary. That cannot run on an accelerator.

This build uses the standard iterative reformulation: the outer doubling loop
is a ``lax.while_loop`` over tree depth, and each subtree of ``2^depth``
leaves is built by an inner ``lax.while_loop`` that advances an
**(even, odd) leaf pair per iteration** with **O(log) memory U-turn
checkpointing** — the even leaf stores (momentum, cumulative momentum sum)
into a ``max_treedepth+2``-row stack via a dense one-hot blend (instead of
a vmapped dynamic-index scatter), and the odd leaf checks the
generalized U-turn criterion against the contiguous checkpoint range
identified by its index's binary structure. Pairing halves the loop trip
count and runs the checkpoint/U-turn row math once per pair instead of
masked every leaf (see ``scripts/bench_nuts_decompose.py``). Proposal
selection is progressive multinomial within subtrees and biased across
doublings (Stan-style, matching the reference's ``logbern`` scheme at
``nuts.py:254-307``). Divergences trigger at ``ΔE > Emax``
(``nuts.py:326-345``); the first 200 tuning draws cap the depth at 8
(``nuts.py:169-172``).

Everything is a pure function of pytrees, so the driver ``lax.scan``s draws,
``vmap``s chains, and ``shard_map``s the chain axis over a device mesh.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ...config import floatX
from ...model import modelcontext
from ..arraystep import Competence, GradientSharedStep, TuneContext
from ..step_sizes import DAState, da_init, da_update, da_current
from .integration import IntegrationState, leapfrog, compute_state
from .quadpotential import (
    DiagAdaptState, diag_adapt_init, diag_adapt_update, diag_random,
    DenseAdaptState, dense_adapt_update, mass_velocity, kernel_mass,
    kernel_momentum, QuadPotentialDiagAdapt,
)

__all__ = ["NUTS"]


def _popcount(x):
    """SWAR popcount for int32 (static-shape friendly)."""
    x = x.astype(jnp.uint32)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24).astype(jnp.int32)


def _trailing_ones(x):
    """Number of trailing 1-bits of int32 ``x``."""
    x = x.astype(jnp.uint32)
    mask = (x ^ (x + 1)) >> 1  # mask of the trailing ones
    return _popcount(mask)


def _is_turning(var, p_left, p_right, rho):
    """Generalized U-turn criterion (cf. ``nuts.py:299-307``):
    the trajectory turns if the momentum sum points against the velocity at
    either end."""
    v_left = mass_velocity(var, p_left)
    v_right = mass_velocity(var, p_right)
    return (jnp.dot(rho, v_left) <= 0) | (jnp.dot(rho, v_right) <= 0)


class _Proposal(NamedTuple):
    q: jnp.ndarray
    logp: jnp.ndarray
    grad: jnp.ndarray
    energy: jnp.ndarray


class _SubtreeState(NamedTuple):
    edge: IntegrationState        # current trajectory endpoint
    prop: _Proposal               # subtree's multinomial proposal
    p_first: jnp.ndarray          # momentum of first computed leaf
    lsw: jnp.ndarray              # log sum of leaf weights
    p_sum: jnp.ndarray            # momentum sum over computed leaves
    sum_accept: jnp.ndarray       # Σ min(1, exp(-ΔE)) over leaves
    max_eerr: jnp.ndarray         # signed ΔE with max |ΔE|
    leaf_idx: jnp.ndarray         # int32, leaves computed so far
    turning: jnp.ndarray          # bool
    diverging: jnp.ndarray        # bool
    r_ckpts: jnp.ndarray          # (D+1, n) checkpoint momenta
    s_ckpts: jnp.ndarray          # (D+1, n) checkpoint cumulative sums
    key: jnp.ndarray


def _build_subtree(key, edge0, eps_signed, n_leaves, h0, var, logp_dlogp_fn,
                   emax, max_treedepth):
    """Build one subtree of ``n_leaves`` (=2^depth) leaves from ``edge0``
    (cf. the recursive ``_build_subtree``, ``nuts.py:347``). Returns the
    final _SubtreeState; the caller must check ``turning | diverging``."""
    n = edge0.q.shape[-1]
    zero_prop = _Proposal(edge0.q, edge0.model_logp, edge0.q_grad,
                          edge0.energy)
    init = _SubtreeState(
        edge=edge0,
        prop=zero_prop,
        p_first=edge0.p,
        lsw=jnp.asarray(-jnp.inf, floatX()),
        p_sum=jnp.zeros((n,), floatX()),
        sum_accept=jnp.asarray(0.0, floatX()),
        max_eerr=jnp.asarray(0.0, floatX()),
        leaf_idx=jnp.asarray(0, jnp.int32),
        turning=jnp.asarray(False),
        diverging=jnp.asarray(False),
        r_ckpts=jnp.zeros((max_treedepth + 2, n), floatX()),
        s_ckpts=jnp.zeros((max_treedepth + 2, n), floatX()),
        key=key,
    )

    rows = jnp.arange(max_treedepth + 2, dtype=jnp.int32)
    zero = jnp.asarray(0.0, floatX())

    def leaf_weight(edge):
        """(energy error, diverging, log weight, accept stat) of a leaf."""
        eerr = edge.energy - h0
        eerr = jnp.where(jnp.isnan(eerr), jnp.inf, eerr)
        acc = jnp.exp(jnp.minimum(zero, -eerr))
        return eerr, eerr > emax, -eerr, jnp.where(jnp.isnan(acc), 0.0, acc)

    def take_prop(k_take, lsw, lw, edge, prop, gate):
        """Progressive multinomial proposal update, masked by ``gate``."""
        new_lsw = jnp.where(gate, jnp.logaddexp(lsw, lw), lsw)
        take = gate & (jnp.log(jax.random.uniform(k_take, (), floatX()))
                       < lw - new_lsw)
        new_prop = jax.tree_util.tree_map(
            lambda a, b: jnp.where(take, a, b),
            _Proposal(edge.q, edge.model_logp, edge.q_grad, edge.energy),
            prop)
        return new_lsw, new_prop

    def cond(s: _SubtreeState):
        return (s.leaf_idx < n_leaves) & ~s.turning & ~s.diverging

    def body(s: _SubtreeState):
        # Two leaves per iteration: leaf A (even — stores its checkpoint,
        # no U-turn possible) then leaf B (odd — runs the U-turn check).
        # Halves the while-loop trip count AND runs the checkpoint/U-turn
        # row math once per pair instead of masked every leaf. B is masked
        # out when A diverges or the subtree is a single leaf (depth 0).
        key, k_take_a, k_take_b = jax.random.split(s.key, 3)
        leaf = s.leaf_idx  # even by construction

        # -- leaf A (even) --------------------------------------------------
        edge_a = leapfrog(logp_dlogp_fn, var, eps_signed, s.edge)
        eerr_a, div_a, lw_a, acc_a = leaf_weight(edge_a)
        lsw, prop = take_prop(k_take_a, s.lsw, lw_a, edge_a, s.prop,
                              jnp.asarray(True))
        p_sum_a = s.p_sum + edge_a.p
        p_first = jnp.where(leaf == 0, edge_a.p, s.p_first)

        # checkpoint store via dense one-hot blend: a vmapped dynamic
        # .at[].set() lowers to a per-lane scatter; the blend is dense
        # elementwise math at a fixed O(depth·n) cost per leaf pair
        row = _popcount(leaf >> 1)
        onehot = (rows == row).astype(floatX())[:, None]
        r_ckpts = s.r_ckpts * (1.0 - onehot) + onehot * edge_a.p[None, :]
        s_ckpts = s.s_ckpts * (1.0 - onehot) + onehot * p_sum_a[None, :]

        # -- leaf B (odd) ---------------------------------------------------
        active_b = (leaf + 1 < n_leaves) & ~div_a
        edge_b = leapfrog(logp_dlogp_fn, var, eps_signed, edge_a)
        eerr_b, div_b, lw_b, acc_b = leaf_weight(edge_b)
        lsw, prop = take_prop(k_take_b, lsw, lw_b, edge_b, prop, active_b)
        p_sum_b = p_sum_a + edge_b.p

        # U-turn for every complete sub-subtree ending at this odd leaf
        idx_max = row
        idx_min = idx_max - _trailing_ones(leaf + 1) + 1
        active_rows = active_b & (rows >= idx_min) & (rows <= idx_max)
        span_sums = p_sum_b[None, :] - s_ckpts + r_ckpts
        v_l = mass_velocity(var, r_ckpts)
        v_r = mass_velocity(var, edge_b.p)
        t_rows = (jnp.einsum("dn,dn->d", span_sums, v_l) <= 0) | \
                 (span_sums @ v_r <= 0)
        turning = jnp.any(active_rows & t_rows)

        # -- merge the pair -------------------------------------------------
        edge = jax.tree_util.tree_map(
            lambda b_, a_: jnp.where(active_b, b_, a_), edge_b, edge_a)
        p_sum = jnp.where(active_b, p_sum_b, p_sum_a)
        eerr_big = jnp.where(active_b & (jnp.abs(eerr_b) > jnp.abs(eerr_a)),
                             eerr_b, eerr_a)
        new_max = jnp.where(jnp.abs(eerr_big) > jnp.abs(s.max_eerr),
                            eerr_big, s.max_eerr)
        return _SubtreeState(
            edge=edge, prop=prop, p_first=p_first, lsw=lsw, p_sum=p_sum,
            sum_accept=s.sum_accept + acc_a
            + jnp.where(active_b, acc_b, zero),
            max_eerr=new_max,
            leaf_idx=leaf + 1 + active_b.astype(jnp.int32),
            turning=turning,
            diverging=div_a | (active_b & div_b),
            r_ckpts=r_ckpts, s_ckpts=s_ckpts, key=key)

    return lax.while_loop(cond, body, init)


class _TreeState(NamedTuple):
    left: IntegrationState
    right: IntegrationState
    prop: _Proposal
    lsw: jnp.ndarray
    rho: jnp.ndarray
    depth: jnp.ndarray
    n_leapfrog: jnp.ndarray
    sum_accept: jnp.ndarray
    max_eerr: jnp.ndarray
    turning: jnp.ndarray
    diverging: jnp.ndarray
    key: jnp.ndarray


def nuts_draw(key, start: IntegrationState, h0, step_size, var,
              logp_dlogp_fn, max_treedepth_t, emax, max_treedepth_static):
    """One NUTS transition from ``start`` with drawn momentum already in the
    state (cf. ``NUTS._hamiltonian_step``, ``nuts.py:168``).

    ``max_treedepth_t`` is the *traced* depth cap (8 during early tuning);
    ``max_treedepth_static`` bounds the checkpoint stack size.
    """
    init = _TreeState(
        left=start, right=start,
        prop=_Proposal(start.q, start.model_logp, start.q_grad, start.energy),
        lsw=jnp.asarray(0.0, floatX()),
        rho=start.p,
        depth=jnp.asarray(0, jnp.int32),
        n_leapfrog=jnp.asarray(0, jnp.int32),
        sum_accept=jnp.asarray(0.0, floatX()),
        max_eerr=jnp.asarray(0.0, floatX()),
        turning=jnp.asarray(False),
        diverging=jnp.asarray(False),
        key=key,
    )

    def cond(t: _TreeState):
        return (t.depth < max_treedepth_t) & ~t.turning & ~t.diverging

    def body(t: _TreeState):
        key, k_dir, k_tree, k_swap = jax.random.split(t.key, 4)
        go_right = jax.random.bernoulli(k_dir)
        eps_signed = jnp.where(go_right, step_size, -step_size)
        edge0 = jax.tree_util.tree_map(
            lambda l, r: jnp.where(go_right, r, l), t.left, t.right)

        n_leaves = jnp.left_shift(jnp.asarray(1, jnp.int32), t.depth)
        sub = _build_subtree(k_tree, edge0, eps_signed, n_leaves, h0, var,
                             logp_dlogp_fn, emax, max_treedepth_static)

        ok = ~sub.turning & ~sub.diverging

        # biased progressive proposal merge across the doubling
        accept_p = jnp.exp(jnp.minimum(jnp.asarray(0.0, floatX()),
                                       sub.lsw - t.lsw))
        swap = ok & (jax.random.uniform(k_swap, (), floatX()) < accept_p)
        prop = jax.tree_util.tree_map(
            lambda a, b: jnp.where(swap, a, b), sub.prop, t.prop)

        lsw = jnp.where(ok, jnp.logaddexp(t.lsw, sub.lsw), t.lsw)
        rho = t.rho + sub.p_sum
        left = jax.tree_util.tree_map(
            lambda l, e: jnp.where(go_right, l, e), t.left, sub.edge)
        right = jax.tree_util.tree_map(
            lambda r, e: jnp.where(go_right, e, r), t.right, sub.edge)

        # Merged-tree turning checks (cf. nuts.py:299-307,361-370 — the three
        # boundary combinations, Stan-style):
        #   old tree = [t.left, t.right] with momentum sum t.rho,
        #   new subtree boundaries in trajectory order:
        p_sub_near = sub.p_first     # leaf adjacent to the old tree
        p_sub_far = sub.edge.p       # new outermost leaf
        p_ll = jnp.where(go_right, t.left.p, p_sub_far)
        p_lr = jnp.where(go_right, t.right.p, p_sub_near)
        p_rl = jnp.where(go_right, p_sub_near, t.left.p)
        p_rr = jnp.where(go_right, p_sub_far, t.right.p)
        rho_left = jnp.where(go_right, t.rho, sub.p_sum)
        rho_right = jnp.where(go_right, sub.p_sum, t.rho)
        turn_full = _is_turning(var, p_ll, p_rr, rho)
        turn_c1 = _is_turning(var, p_ll, p_rl, rho_left + p_rl)
        turn_c2 = _is_turning(var, p_lr, p_rr, rho_right + p_lr)
        merged_turning = ok & (turn_full | turn_c1 | turn_c2)

        return _TreeState(
            left=left, right=right, prop=prop, lsw=lsw, rho=rho,
            depth=t.depth + 1,
            n_leapfrog=t.n_leapfrog + sub.leaf_idx,
            sum_accept=t.sum_accept + sub.sum_accept,
            max_eerr=jnp.where(jnp.abs(sub.max_eerr) > jnp.abs(t.max_eerr),
                               sub.max_eerr, t.max_eerr),
            turning=sub.turning | merged_turning,
            diverging=sub.diverging,
            key=key)

    return lax.while_loop(cond, body, init)


def find_reasonable_eps(step, q0_batch, seed):
    """Stan-style "find reasonable step size" probe (Hoffman & Gelman
    2014 Alg. 4 / Stan's ``init_stepsize``): geometric search for an eps
    whose ONE-leapfrog acceptance, pooled over all chains, lands in
    [0.25, 0.9].

    Dual averaging seeded from the dimension heuristic 0.25 d^-1/4
    overshoots small on tightly-scaled posteriors; at 8192 lockstep
    chains the first tuning block then runs hundreds of max-depth
    (2^10-leapfrog) trees before the first kept draw. One vmapped
    leapfrog per probe
    iteration (<=30) costs milliseconds and starts the bar where the
    posterior actually lives. Returns a float eps (the input step_size
    unchanged if probing is not applicable)."""
    if getattr(step, "_partial", False):
        return step.step_size
    q0 = jnp.asarray(q0_batch, floatX())
    pot = step.potential.init_kernel_state()
    var = kernel_mass(pot)
    logp_fn = step._logp_fn

    @jax.jit
    def probe(q0, key):
        lp = jax.vmap(jax.value_and_grad(logp_fn))
        logp0, grad0 = lp(q0)
        keys = jax.random.split(key, q0.shape[0])
        p0 = jax.vmap(lambda k: kernel_momentum(k, pot))(keys)
        v0 = jax.vmap(lambda p: mass_velocity(var, p))(p0)
        h0 = 0.5 * jnp.sum(p0 * v0, axis=-1) - logp0

        def accept_at(eps):
            p_half = p0 + 0.5 * eps * grad0
            q1 = q0 + eps * jax.vmap(lambda p: mass_velocity(var, p))(p_half)
            logp1, grad1 = lp(q1)
            p1 = p_half + 0.5 * eps * grad1
            v1 = jax.vmap(lambda p: mass_velocity(var, p))(p1)
            h1 = 0.5 * jnp.sum(p1 * v1, axis=-1) - logp1
            de = h0 - h1
            a = jnp.where(jnp.isfinite(de),
                          jnp.exp(jnp.minimum(de, 0.0)), 0.0)
            return jnp.mean(a)

        def cond(c):
            eps, a, it = c
            return ((a > 0.9) | (a < 0.25)) & (it < 30) & \
                (eps > 1e-10) & (eps < 1e4)

        def body(c):
            eps, a, it = c
            eps2 = jnp.where(a > 0.9, eps * 2.0, eps * 0.5)
            return eps2, accept_at(eps2), it + 1

        eps0 = jnp.asarray(step.step_size, floatX())
        eps, a, _ = lax.while_loop(
            cond, body, (eps0, accept_at(eps0), jnp.asarray(0, jnp.int32)))
        return eps, a

    eps, a = probe(q0, jax.random.PRNGKey((int(seed) ^ 0x5EED) & 0x7FFFFFFF))
    eps = float(eps)
    if np.isfinite(eps) and 1e-10 < eps < 1e4:
        # The shrinkage target stays at the standard 10x (da_init): a
        # 2x target biased the tuned eps high on short tunes, while the
        # warmup depth caps already bound the cost of the 10x overshoot.
        return eps
    return step.step_size


class NutsKernelState(NamedTuple):
    """Per-chain NUTS state threaded through the draw scan."""

    q: jnp.ndarray
    logp: jnp.ndarray
    grad: jnp.ndarray
    da: DAState
    pot: DiagAdaptState
    rescue_cnt: jnp.ndarray     # divergences in the current tuning window
    eps_scale: jnp.ndarray      # per-lane step-size multiplier (<=1)


class NUTS(GradientSharedStep):
    """Adaptive No-U-Turn sampler (cf. ``nuts.py:36``)."""

    name = "nuts"
    default_blocked = True
    generates_stats = True
    stats_dtypes = [{
        "depth": np.int64,
        "step_size": np.float64,
        "tune": bool,
        "mean_tree_accept": np.float64,
        "step_size_bar": np.float64,
        "tree_size": np.float64,
        "diverging": bool,
        "energy_error": np.float64,
        "energy": np.float64,
        "max_energy_error": np.float64,
        "model_logp": np.float64,
        "step_size_scale": np.float64,
        "rescued": bool,
    }]

    def __init__(self, vars=None, max_treedepth=10, early_max_treedepth=8,
                 target_accept=0.8, step_scale=0.25, Emax=1000,
                 adapt_step_size=True, step_rand=None, potential=None,
                 model=None, scaling=None, is_cov=False,
                 gamma=0.05, k=0.75, t0=10, axis_name=None,
                 rescue_stuck=True, **kwargs):
        model = modelcontext(model)
        if vars is None:
            vars = model.cont_vars
        kwargs.pop("blocked", None)
        super().__init__(vars, model=model, blocked=True, **kwargs)

        self.max_treedepth = int(max_treedepth)
        self.early_max_treedepth = int(early_max_treedepth)
        self.target_accept = float(target_accept)
        self.Emax = float(Emax)
        self.adapt_step_size = bool(adapt_step_size)
        self.gamma, self.k, self.t0 = gamma, k, t0
        self.tune = True
        self.axis_name = axis_name
        # warmup-phase stuck-lane rescue (pooled runs only): at >=8k
        # jittered chains the odd lane lands in a region where the POOLED
        # step size diverges every draw and never recovers — one constant
        # chain craters cross-chain ESS (seen at 8192 chains). Failure
        # detection per SURVEY §5, done on device:
        # lanes whose tuning window is ~all divergences teleport to the
        # pooled best-logp lane at window boundaries (tuning is already
        # non-Markovian, post-tune draws are untouched).
        self.rescue_stuck = bool(rescue_stuck)

        size = self.dim
        self.step_size = float(step_scale) / (size ** 0.25)

        if scaling is not None:
            from .quadpotential import quad_potential
            potential = quad_potential(scaling, is_cov)
        if potential is not None:
            self.potential = potential
        else:
            mean = np.asarray(
                np.concatenate([np.ravel(v.test_value) for v in self.vars])
                if self.vars else np.zeros(size), dtype=floatX())
            self.potential = QuadPotentialDiagAdapt(size, mean)

        self._partial = self.q_indices.size != model.ordering.size
        self._sub_idx = jnp.asarray(self.q_indices, jnp.int32)
        full_logp = self._logp_fn

        if self._partial:
            idx = self._sub_idx

            def sub_logp(x, q_ctx):
                return full_logp(q_ctx.at[idx].set(x))
            self._kernel_logp = sub_logp
        else:
            self._kernel_logp = lambda x, q_ctx: full_logp(x)

    # -- functional kernel ---------------------------------------------------
    def kernel_init(self, q0):
        q0 = jnp.asarray(q0, floatX())
        x0 = q0[self._sub_idx] if self._partial else q0
        lp_fn = lambda x: self._kernel_logp(x, q0)
        logp, grad = jax.value_and_grad(lp_fn)(x0)
        da = da_init(jnp.asarray(self.step_size, floatX()),
                     target=self.target_accept,
                     mu_scale=getattr(self, "_da_mu_scale", 10.0))
        pot = self.potential.init_kernel_state()
        return NutsKernelState(q=x0, logp=logp, grad=grad, da=da, pot=pot,
                               rescue_cnt=jnp.asarray(0, jnp.int32),
                               eps_scale=jnp.asarray(1.0, floatX()))

    def kernel_step(self, key, q, state: NutsKernelState, tctx: TuneContext):
        q = jnp.asarray(q, floatX())
        lp_fn = jax.value_and_grad(lambda x: self._kernel_logp(x, q))
        k_mom, k_tree = jax.random.split(key)

        eps = da_current(state.da, tctx.tune)
        # Per-lane step-size fallback under POOLED adaptation: a lane
        # trapped in a high-curvature pocket (funnel bottom) diverges at
        # the pooled eps every draw and would otherwise never move — the
        # 8192-chain stuck-lane pathology. Its lane
        # multiplier halves on divergence and decays back toward 1 on
        # clean draws, so the bulk runs at exactly the pooled eps while a
        # trapped lane gets the small eps it needs to escape. NUTS is
        # valid at ANY eps, so post-tune draws with a residual scale < 1
        # remain exact.
        eps = eps * state.eps_scale
        # inverse mass: (n,) diagonal or (n,n) dense — resolved at trace
        # time from the potential's kernel-state type
        var = kernel_mass(state.pot)
        p0 = kernel_momentum(k_mom, state.pot)

        x0 = q[self._sub_idx] if self._partial else q
        if self._partial:
            # other steppers moved the context coords since our last call —
            # the cached logp/grad no longer describe (x0, q): recompute
            logp0, grad0 = lp_fn(x0)
        else:
            logp0, grad0 = state.logp, state.grad
        v0 = mass_velocity(var, p0)
        kinetic = 0.5 * jnp.dot(p0, v0)
        start = IntegrationState(q=x0, p=p0, v=v0, q_grad=grad0,
                                 energy=kinetic - logp0,
                                 model_logp=logp0)
        h0 = start.energy

        early = tctx.tune & (tctx.step_idx < 200)
        mtd = jnp.where(
            early,
            jnp.asarray(min(self.early_max_treedepth, self.max_treedepth),
                        jnp.int32),
            jnp.asarray(self.max_treedepth, jnp.int32))
        if self.axis_name is not None:
            # Harder cap while the POOLED mass matrix is still warming
            # (first promotions at draws 3/10/25, quadpotential.py): on an
            # ill-conditioned target the first ~25 draws otherwise run
            # 2^8-leapfrog trees in lockstep across every lane, with zero
            # divergences. Truncated early trajectories
            # cost mixing per chain, but the mass estimate pools across
            # thousands of jittered chains, so cross-chain spread — not
            # within-chain mixing — carries the early adaptation.
            # Lockstep cost is the MAX lane depth per draw, not the mean:
            # during the eps ramp a straggler lane at the cap charges
            # every lane 2^cap leapfrogs. Cap 6 through the early phase bounds
            # the straggler tax at 4x the steady-state depth-4 draw.
            mtd = jnp.where(
                tctx.tune & (tctx.step_idx < 32),
                jnp.asarray(min(5, self.max_treedepth), jnp.int32),
                jnp.where(early,
                          jnp.asarray(min(6, self.max_treedepth),
                                      jnp.int32),
                          mtd))

        tree = nuts_draw(k_tree, start, h0, eps, var, lp_fn, mtd,
                         jnp.asarray(self.Emax, floatX()),
                         self.max_treedepth)

        n_leaf = jnp.maximum(tree.n_leapfrog, 1)
        mean_accept = tree.sum_accept / n_leaf.astype(floatX())

        # pooled step-size adaptation: averaging the accept statistic over
        # the (vmapped/sharded) chain axis gives every chain the same eps.
        # On lockstep SPMD hardware this also equalizes tree depths across
        # vmap lanes, cutting the max-over-chains cost of each draw.
        da_accept = mean_accept
        pool = None
        if self.axis_name is not None:
            # In a mesh-sharded run the chains on each device are vmapped
            # under LOCAL_CHAIN_AXIS inside the shard_map over the mesh
            # axis — pool over both so every chain everywhere shares eps.
            # Lanes on a reduced per-lane step (eps_scale < 1, the stuck-
            # lane fallback below) report acceptance at a SMALLER eps than
            # the bar being adapted; including them inflates the pooled
            # accept-prob and biases eps upward for everyone else. Pool
            # over the unscaled lanes only, falling back to the plain mean
            # in the (pathological) all-lanes-scaled case.
            from ...parallel import pooled_axes
            pool = pooled_axes(self.axis_name)
            unscaled = state.eps_scale >= 1.0
            n_unscaled = jax.lax.psum(unscaled.astype(floatX()), pool)
            # where (not *) so a NaN accept on a scaled lane can't poison
            # the psum through 0 * NaN
            masked = jnp.where(unscaled, mean_accept, 0.0)
            da_accept = jnp.where(
                n_unscaled > 0,
                jax.lax.psum(masked, pool) / jnp.maximum(n_unscaled, 1.0),
                jax.lax.pmean(mean_accept, pool))

        da_new = da_update(state.da, da_accept,
                           tctx.tune & self.adapt_step_size,
                           target=self.target_accept, gamma=self.gamma,
                           k=self.k, t0=self.t0)
        if not getattr(self.potential, "adapts", False):
            pot_new = state.pot
        elif isinstance(state.pot, DenseAdaptState):
            pot_new = dense_adapt_update(
                state.pot, tree.prop.q, tctx.tune,
                window_multiplier=getattr(
                    self.potential, "adaptation_window_multiplier", 2.0),
                axis_name=pool)
        else:
            pot_new = diag_adapt_update(
                state.pot, tree.prop.q, tctx.tune,
                adaptation_window=getattr(
                    self.potential, "adaptation_window", 101),
                axis_name=pool)

        new_q, new_logp, new_grad = tree.prop.q, tree.prop.logp, \
            tree.prop.grad
        rescued = jnp.asarray(False)
        eps_scale = state.eps_scale
        if pool is not None:
            eps_scale = jnp.where(
                tctx.tune,
                jnp.clip(jnp.where(tree.diverging, eps_scale * 0.5,
                                   eps_scale * 1.12),
                         2.0 ** -8, 1.0),
                eps_scale)
        rescue_cnt = state.rescue_cnt
        if pool is not None and self.rescue_stuck and not self._partial:
            win, thresh = 100, 90
            rescue_cnt = jnp.where(
                tctx.tune,
                rescue_cnt + tree.diverging.astype(jnp.int32),
                jnp.asarray(0, jnp.int32))
            boundary = tctx.tune & (((tctx.step_idx + 1) % win) == 0)
            stuck = boundary & (rescue_cnt >= thresh)
            # donor = first pooled lane attaining the best FINITE logp.
            # Exact ties (symmetric posteriors in f32) are broken by global
            # lane index so q/logp/grad all come from ONE consistent lane,
            # and a NaN/-inf lane can never poison the pmax or be teleport
            # target material.
            axes = pool if isinstance(pool, tuple) else (pool,)
            lane = jnp.asarray(0, jnp.int32)
            for a in axes:
                lane = lane * jax.lax.psum(jnp.asarray(1, jnp.int32), a) \
                    + jax.lax.axis_index(a)
            finite = jnp.isfinite(new_logp)
            score = jnp.where(finite, new_logp, -jnp.inf)
            best = jax.lax.pmax(score, pool)
            sentinel = jnp.iinfo(jnp.int32).max
            cand = jnp.where(finite & (score == best), lane, sentinel)
            donor_lane = jax.lax.pmin(cand, pool)
            is_best = (lane == donor_lane).astype(floatX())
            have_donor = jnp.isfinite(best) & (donor_lane != sentinel)
            apply = stuck & have_donor

            def donor(x):
                # where (not *) so a NaN on a non-donor lane can't poison
                # the psum through 0 * NaN
                return jax.lax.psum(jnp.where(is_best > 0, x, 0.), pool)

            new_q = jnp.where(apply, donor(new_q), new_q)
            new_logp = jnp.where(apply, donor(new_logp), new_logp)
            new_grad = jnp.where(apply, donor(new_grad), new_grad)
            rescue_cnt = jnp.where(boundary, 0, rescue_cnt)
            rescued = apply

        q_new = q.at[self._sub_idx].set(new_q) if self._partial else new_q
        new_state = NutsKernelState(q=new_q, logp=new_logp,
                                    grad=new_grad, da=da_new,
                                    pot=pot_new, rescue_cnt=rescue_cnt,
                                    eps_scale=eps_scale)
        stats = {
            "depth": tree.depth,
            "step_size": eps,
            "tune": tctx.tune,
            "mean_tree_accept": mean_accept,
            "step_size_bar": jnp.exp(da_new.log_bar_step),
            "tree_size": tree.n_leapfrog.astype(floatX()),
            "diverging": tree.diverging & ~tctx.tune,
            "energy_error": tree.prop.energy - h0,
            "energy": tree.prop.energy,
            "max_energy_error": tree.max_eerr,
            "model_logp": tree.prop.logp,
            "step_size_scale": eps_scale,
            "rescued": rescued,
        }
        return q_new, new_state, stats

    @staticmethod
    def competence(var, has_grad=False):
        """cf. ``nuts.py:195``."""
        dist = getattr(var, "distribution", None)
        dtype = getattr(dist, "dtype", None) or getattr(var, "dtype", None)
        from ...vartypes import continuous_types
        if str(np.dtype(dtype)) in continuous_types and has_grad:
            return Competence.IDEAL
        return Competence.INCOMPATIBLE

    def warnings(self):
        return []
