"""Mass matrices (cf. ``pymc3/step_methods/hmc/quadpotential.py``).

The adaptive diagonal potential (``QuadPotentialDiagAdapt``,
``quadpotential.py:140``) keeps two Welford variance estimators (foreground /
background) and refreshes the foreground from the background every
``adaptation_window`` (=101) tuning draws. Here that state is a pytree of jnp
arrays so it lives inside the jitted warmup scan, vmaps over chains, and —
for pooled cross-chain adaptation — can be merged with an exact ``psum`` of
the (count, mean, M2) triples over the device mesh
(cf. ``_WeightedVariance.add_sample``, ``quadpotential.py:336-342``; SURVEY
§5 "Distributed communication backend").
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ...config import floatX

__all__ = [
    "QuadPotential", "QuadPotentialDiag", "QuadPotentialDiagAdapt",
    "QuadPotentialDiagAdaptGrad", "QuadPotentialFull", "QuadPotentialFullInv",
    "QuadPotentialFullAdapt", "quad_potential", "PositiveDefiniteError",
    "WelfordState", "welford_init", "welford_add", "welford_var",
    "DiagAdaptState", "diag_adapt_init", "diag_adapt_update",
    "DenseState", "DenseAdaptState", "dense_adapt_init",
    "dense_adapt_update", "mass_velocity", "kernel_mass", "kernel_momentum",
    "isquadpotential",
]


class PositiveDefiniteError(ValueError):
    """cf. ``quadpotential.py:48``."""

    def __init__(self, msg, idx):
        super().__init__(msg)
        self.idx = idx
        self.msg = msg

    def __str__(self):
        return f"Scaling is not positive definite: {self.msg}. Check indexes {self.idx}."


def partial_check_positive_definite(C):
    """Make a simple but partial pos-def check (cf. ``quadpotential.py:67``)."""
    C_ = np.asarray(C)
    if C_.ndim == 1:
        d = C_
    else:
        d = np.diag(C_)
    (i,) = np.nonzero(np.logical_or(np.isnan(d), d <= 0))
    if len(i):
        raise PositiveDefiniteError("Simple check failed. Diagonal contains negatives", i)


# ---------------------------------------------------------------------------
# Functional Welford variance (cf. _WeightedVariance, quadpotential.py:313)
# ---------------------------------------------------------------------------
class WelfordState(NamedTuple):
    w: jnp.ndarray      # total weight (scalar)
    mean: jnp.ndarray   # running mean (n,)
    m2: jnp.ndarray     # sum of squared deviations (n,)


def welford_init(n, init_mean=None, init_var=None, init_weight=0.0):
    mean = jnp.zeros((n,), floatX()) if init_mean is None \
        else jnp.asarray(init_mean, floatX())
    if init_var is None:
        m2 = jnp.zeros((n,), floatX())
    else:
        m2 = jnp.asarray(init_var, floatX()) * init_weight
    return WelfordState(jnp.asarray(float(init_weight), floatX()), mean, m2)


def welford_add(state: WelfordState, x, weight=1.0) -> WelfordState:
    """cf. ``_WeightedVariance.add_sample`` (``quadpotential.py:336-342``)."""
    w = state.w + weight
    prop = weight / w
    delta = x - state.mean
    mean = state.mean + prop * delta
    m2 = state.m2 + weight * delta * (x - mean)
    return WelfordState(w, mean, m2)


def welford_var(state: WelfordState):
    """Current variance estimate (requires w > 1)."""
    return state.m2 / state.w


def welford_merge_psum(state: WelfordState, axis_name: str) -> WelfordState:
    """Exact cross-device pooled merge of Welford states via ``psum`` over the
    chain-sharding mesh axis — the replacement for per-process
    adaptation (SURVEY §5)."""
    w_tot = jax.lax.psum(state.w, axis_name)
    mean_tot = jax.lax.psum(state.w * state.mean, axis_name) / w_tot
    # parallel-variance combination: M2_tot = sum(M2_i + w_i*(mean_i-mean)^2)
    m2_tot = jax.lax.psum(
        state.m2 + state.w * (state.mean - mean_tot) ** 2, axis_name)
    return WelfordState(w_tot, mean_tot, m2_tot)


# ---------------------------------------------------------------------------
# Functional adaptive diagonal potential
# ---------------------------------------------------------------------------
class DiagAdaptState(NamedTuple):
    """State of QuadPotentialDiagAdapt as a pytree (one copy per chain)."""

    var: jnp.ndarray        # current M^{-1} diagonal (posterior var estimate)
    inv_stds: jnp.ndarray   # 1/sqrt(var), used for momentum draws
    fg: WelfordState
    bg: WelfordState
    n_samples: jnp.ndarray  # tuning draws seen


def diag_adapt_init(initial_mean, initial_diag=None, initial_weight=10.0):
    """cf. ``QuadPotentialDiagAdapt.__init__`` (``quadpotential.py:140-186``)."""
    initial_mean = jnp.asarray(initial_mean, floatX())
    n = initial_mean.shape[-1]
    if initial_diag is None:
        initial_diag = jnp.ones((n,), floatX())
        initial_weight = 1.0
    else:
        initial_diag = jnp.asarray(initial_diag, floatX())
    fg = welford_init(n, init_mean=initial_mean, init_var=initial_diag,
                      init_weight=initial_weight)
    bg = welford_init(n)
    var = fg.m2 / fg.w
    return DiagAdaptState(var=var, inv_stds=1.0 / jnp.sqrt(var),
                          fg=fg, bg=bg,
                          n_samples=jnp.asarray(0, jnp.int32))


def diag_adapt_update(state: DiagAdaptState, sample, tune,
                      adaptation_window=101,
                      axis_name: Optional[str] = None) -> DiagAdaptState:
    """One adaptation step (cf. ``QuadPotentialDiagAdapt.update``,
    ``quadpotential.py:211-233``): add the sample to both estimators, refresh
    ``var`` from the foreground, and at window boundaries promote background
    to foreground. With ``axis_name`` the variance is estimated from the
    pooled cross-chain Welford state (exact ``psum`` merge)."""
    fg = welford_add(state.fg, sample)
    bg = welford_add(state.bg, sample)

    fg_for_var = fg if axis_name is None else welford_merge_psum(fg, axis_name)
    var = fg_for_var.m2 / fg_for_var.w

    n = state.n_samples + 1
    window_end = (n % adaptation_window) == 0
    if axis_name is not None:
        # Early window promotions for POOLED adaptation: with C pooled
        # chains every draw contributes C mass-matrix samples, so by
        # draw 3 the background estimator is already excellent at large
        # C — while the foreground still carries the init prior (weight
        # 10 PER CHAIN = 10 C pooled) and the reference's first promotion
        # waits 101 draws. On an ill-conditioned target that means ~100
        # draws of max-depth trees on a near-identity mass, in lockstep
        # across every chain. Promote at n = 3/10/25 once
        # the pooled sample count clears 1024. lax.psum of a constant
        # folds at compile time (axis sizes are static), so this costs
        # nothing per draw.
        pooled_n = jax.lax.psum(jnp.asarray(1.0, floatX()), axis_name)
        early = (n == 3) | (n == 10) | (n == 25)
        window_end = window_end | (
            early & (pooled_n * n.astype(floatX()) >= 1024.0))

    zero = welford_init(state.var.shape[-1])
    # promote bg -> fg at window end, reset bg
    fg_new = jax.tree_util.tree_map(
        lambda a, b: jnp.where(window_end, a, b), bg, fg)
    bg_new = jax.tree_util.tree_map(
        lambda a, b: jnp.where(window_end, a, b), zero, bg)

    tune = jnp.asarray(tune)

    def sel(new, old):
        return jnp.where(tune, new, old)

    return DiagAdaptState(
        var=sel(var, state.var),
        inv_stds=sel(1.0 / jnp.sqrt(var), state.inv_stds),
        fg=jax.tree_util.tree_map(sel, fg_new, state.fg),
        bg=jax.tree_util.tree_map(sel, bg_new, state.bg),
        n_samples=jnp.where(tune, n, state.n_samples),
    )


def diag_velocity(var, p):
    """v = M^{-1} p (elementwise)."""
    return var * p


def diag_kinetic(var, p):
    return 0.5 * jnp.dot(p, var * p)


def diag_random(key, inv_stds):
    """Momentum draw p ~ N(0, M) (cf. ``quadpotential.py:200``)."""
    return inv_stds * jax.random.normal(key, inv_stds.shape, dtype=floatX())


# ---------------------------------------------------------------------------
# Dense (full) mass matrices in the jitted kernels
# ---------------------------------------------------------------------------
def mass_velocity(mass, p):
    """v = M^{-1} p for a diagonal (1-D ``mass``) or dense (2-D) inverse
    mass matrix. Accepts batched momenta of shape (..., n)."""
    if mass.ndim == 2:
        return p @ mass  # M^{-1} symmetric
    return p * mass


def dense_random(key, chol):
    """Momentum draw p ~ N(0, M) with M = cov^{-1} and cov = L Lᵀ:
    p = L^{-T} z has covariance L^{-T} L^{-1} = cov^{-1}
    (cf. ``QuadPotentialFull.random``, ``quadpotential.py:465``)."""
    z = jax.random.normal(key, (chol.shape[0],), dtype=floatX())
    return jax.scipy.linalg.solve_triangular(chol.T, z, lower=False)


def kernel_mass(pot_state):
    """The inverse-mass array a kernel threads through its leapfrog/tree:
    the (n,) diagonal or the (n,n) dense matrix."""
    if isinstance(pot_state, (DenseState, DenseAdaptState)):
        return pot_state.cov
    return pot_state.var


def kernel_momentum(key, pot_state):
    """Momentum draw dispatching on the potential's kernel-state type
    (resolved at trace time — the state type is static under jit)."""
    if isinstance(pot_state, (DenseState, DenseAdaptState)):
        return dense_random(key, pot_state.chol)
    return diag_random(key, pot_state.inv_stds)


class WelfordCovState(NamedTuple):
    """Weighted covariance accumulator (cf. ``_WeightedCovariance``,
    ``quadpotential.py:575``) as a pytree: m2 is the (n,n) sum of outer
    products of deviations."""

    w: jnp.ndarray
    mean: jnp.ndarray   # (n,)
    m2: jnp.ndarray     # (n, n)


def welford_cov_init(n, init_mean=None, init_cov=None, init_weight=0.0):
    mean = jnp.zeros((n,), floatX()) if init_mean is None \
        else jnp.asarray(init_mean, floatX())
    m2 = jnp.zeros((n, n), floatX()) if init_cov is None \
        else jnp.asarray(init_cov, floatX()) * init_weight
    return WelfordCovState(jnp.asarray(float(init_weight), floatX()),
                           mean, m2)


def welford_cov_add(state: WelfordCovState, x, weight=1.0):
    w = state.w + weight
    delta = x - state.mean
    mean = state.mean + (weight / w) * delta
    m2 = state.m2 + weight * jnp.outer(delta, x - mean)
    return WelfordCovState(w, mean, m2)


def welford_cov_merge_psum(state: WelfordCovState, axis_name):
    """Exact pooled cross-chain covariance merge (parallel combination of
    (w, mean, M2) with the rank-1 mean-shift term)."""
    w_tot = jax.lax.psum(state.w, axis_name)
    mean_tot = jax.lax.psum(state.w * state.mean, axis_name) / w_tot
    d = state.mean - mean_tot
    m2_tot = jax.lax.psum(state.m2 + state.w * jnp.outer(d, d), axis_name)
    return WelfordCovState(w_tot, mean_tot, m2_tot)


class DenseAdaptState(NamedTuple):
    """State of QuadPotentialFullAdapt as a pytree (Stan-style doubling
    windows, cf. ``quadpotential.py:482-569``)."""

    cov: jnp.ndarray          # current M^{-1}
    chol: jnp.ndarray         # lower cholesky of cov
    fg: WelfordCovState
    bg: WelfordCovState
    window: jnp.ndarray       # current adaptation window length (int32)
    prev_update: jnp.ndarray  # n_samples at the last window promotion
    n_samples: jnp.ndarray


def dense_adapt_init(initial_mean, initial_cov=None, initial_weight=0.0,
                     adaptation_window=101):
    initial_mean = jnp.asarray(initial_mean, floatX())
    n = initial_mean.shape[-1]
    if initial_cov is None:
        initial_cov = jnp.eye(n, dtype=floatX())
        initial_weight = 1.0
    else:
        initial_cov = jnp.asarray(initial_cov, floatX())
    fg = welford_cov_init(n, init_mean=initial_mean, init_cov=initial_cov,
                          init_weight=initial_weight)
    bg = welford_cov_init(n)
    return DenseAdaptState(
        cov=initial_cov, chol=jnp.linalg.cholesky(initial_cov),
        fg=fg, bg=bg,
        window=jnp.asarray(int(adaptation_window), jnp.int32),
        prev_update=jnp.asarray(0, jnp.int32),
        n_samples=jnp.asarray(0, jnp.int32))


def dense_adapt_update(state: DenseAdaptState, sample, tune,
                       window_multiplier=2.0,
                       axis_name: Optional[str] = None) -> DenseAdaptState:
    """One dense-adaptation step (cf. ``QuadPotentialFullAdapt.update``,
    ``quadpotential.py:542-569``): add the sample to both covariance
    estimators, refresh cov/chol from the foreground (the reference's
    ``update_window=1`` default), and at window boundaries promote
    background→foreground and double the window. A non-PD foreground
    estimate (NaN cholesky) leaves the previous factor in place — the
    branchless analog of the reference catching ``LinAlgError``."""
    fg = welford_cov_add(state.fg, sample)
    bg = welford_cov_add(state.bg, sample)
    n = state.n_samples + 1
    delta = state.n_samples - state.prev_update

    fg_est = fg if axis_name is None \
        else welford_cov_merge_psum(fg, axis_name)
    cov_est = fg_est.m2 / jnp.maximum(fg_est.w - 1.0, 1.0)
    chol_est = jnp.linalg.cholesky(cov_est)
    ok = (fg_est.w > 2.0) & jnp.isfinite(chol_est).all()
    cov = jnp.where(ok, cov_est, state.cov)
    chol = jnp.where(ok, chol_est, state.chol)

    window_end = delta >= state.window
    zero = welford_cov_init(state.cov.shape[-1])
    fg_new = jax.tree_util.tree_map(
        lambda a, b: jnp.where(window_end, a, b), bg, fg)
    bg_new = jax.tree_util.tree_map(
        lambda a, b: jnp.where(window_end, a, b), zero, bg)
    window_new = jnp.where(
        window_end,
        (state.window.astype(floatX()) * window_multiplier).astype(jnp.int32),
        state.window)
    prev_new = jnp.where(window_end, state.n_samples, state.prev_update)

    tune = jnp.asarray(tune)

    def sel(new, old):
        return jnp.where(tune, new, old)

    return DenseAdaptState(
        cov=sel(cov, state.cov), chol=sel(chol, state.chol),
        fg=jax.tree_util.tree_map(sel, fg_new, state.fg),
        bg=jax.tree_util.tree_map(sel, bg_new, state.bg),
        window=jnp.where(tune, window_new, state.window),
        prev_update=jnp.where(tune, prev_new, state.prev_update),
        n_samples=jnp.where(tune, n, state.n_samples))


# ---------------------------------------------------------------------------
# Class wrappers (API parity with the reference)
# ---------------------------------------------------------------------------
class QuadPotential:
    """Interface (cf. ``quadpotential.py:91``)."""

    dtype = None

    def velocity(self, x, out=None):
        raise NotImplementedError

    def energy(self, x, velocity=None):
        raise NotImplementedError

    def random(self):
        raise NotImplementedError

    def velocity_energy(self, x, v_out):
        raise NotImplementedError

    def update(self, sample, grad, tune):
        pass

    def raise_ok(self, vmap=None):
        pass

    def reset(self):
        pass


def isquadpotential(value):
    return isinstance(value, QuadPotential)


class _JaxPotentialMixin:
    """numpy-facing helpers shared by the class wrappers."""

    def velocity(self, x, out=None):
        v = np.asarray(self._velocity(np.asarray(x, dtype=floatX())))
        if out is not None:
            np.copyto(out, v)
            return None
        return v

    def energy(self, x, velocity=None):
        x = np.asarray(x, dtype=floatX())
        if velocity is None:
            velocity = self.velocity(x)
        return 0.5 * float(np.dot(x, velocity))

    def velocity_energy(self, x, v_out):
        self.velocity(x, out=v_out)
        return 0.5 * float(np.dot(x, v_out))


class QuadPotentialDiag(_JaxPotentialMixin, QuadPotential):
    """Fixed diagonal M^{-1}=v (cf. ``quadpotential.py:356``)."""

    def __init__(self, v, dtype=None):
        self.dtype = dtype or floatX()
        v = np.asarray(v)
        partial_check_positive_definite(v)
        self.v = v.astype(self.dtype)
        self.s = np.sqrt(v).astype(self.dtype)
        self.inv_s = (1.0 / self.s).astype(self.dtype)

    def _velocity(self, x):
        return self.v * x

    def random(self):
        return (np.random.normal(size=self.s.shape) * self.inv_s).astype(self.dtype)

    # functional view --------------------------------------------------------
    def init_kernel_state(self):
        return DiagAdaptState(
            var=jnp.asarray(self.v), inv_stds=jnp.asarray(self.inv_s),
            fg=welford_init(self.v.shape[-1]),
            bg=welford_init(self.v.shape[-1]),
            n_samples=jnp.asarray(0, jnp.int32))

    adapts = False


class QuadPotentialDiagAdapt(_JaxPotentialMixin, QuadPotential):
    """Adaptive diagonal (cf. ``quadpotential.py:140``)."""

    adapts = True

    def __init__(self, n, initial_mean, initial_diag=None, initial_weight=0,
                 adaptation_window=101, dtype=None):
        if initial_diag is not None and np.ndim(initial_diag) != 1:
            raise ValueError("Initial diagonal must be one-dimensional.")
        if np.ndim(initial_mean) != 1:
            raise ValueError("Initial mean must be one-dimensional.")
        if initial_diag is not None and len(initial_diag) != n:
            raise ValueError(f"Wrong shape for initial_diag: expected {n} got "
                             f"{len(initial_diag)}")
        if len(initial_mean) != n:
            raise ValueError(f"Wrong shape for initial_mean: expected {n} got "
                             f"{len(initial_mean)}")
        self.dtype = dtype or floatX()
        self.n = n
        self.adaptation_window = int(adaptation_window)
        self._initial_mean = np.asarray(initial_mean, dtype=self.dtype)
        self._initial_diag = None if initial_diag is None else \
            np.asarray(initial_diag, dtype=self.dtype)
        self._initial_weight = float(initial_weight)
        self.reset()

    def reset(self):
        self._state = diag_adapt_init(
            self._initial_mean, self._initial_diag,
            self._initial_weight if self._initial_diag is not None else 1.0)

    def init_kernel_state(self) -> DiagAdaptState:
        return self._state

    def _velocity(self, x):
        return np.asarray(self._state.var) * x

    def random(self):
        vals = np.random.normal(size=self.n).astype(self.dtype)
        return np.asarray(self._state.inv_stds) * vals

    def update(self, sample, grad, tune):
        if not tune:
            return
        self._state = jax.jit(
            lambda s, x: diag_adapt_update(
                s, x, True, self.adaptation_window))(
                    self._state, jnp.asarray(sample, dtype=floatX()))

    def raise_ok(self, vmap=None):
        """cf. ``quadpotential.py:227-269`` — name the offending RV elements."""
        var = np.asarray(self._state.var)
        if np.any(var == 0):
            index = np.where(var == 0)[0]
            errmsg = ["Mass matrix contains zeros on the diagonal. "]
            for ii in index:
                name = _name_for_index(vmap, ii)
                errmsg.append(f"The derivative of RV `{name}`.ravel()[{ii}] is zero.")
            raise ValueError("\n".join(errmsg))
        if np.any(~np.isfinite(var)):
            index = np.where(~np.isfinite(var))[0]
            errmsg = ["Mass matrix contains non-finite values on the diagonal. "]
            for ii in index:
                name = _name_for_index(vmap, ii)
                errmsg.append(
                    f"The derivative of RV `{name}`.ravel()[{ii}] is non-finite.")
            raise ValueError("\n".join(errmsg))


def _name_for_index(vmap, ii):
    if vmap is None:
        return "?"
    for vm in vmap:
        if vm.slc.start <= ii < vm.slc.stop:
            return vm.var
    return "?"


class QuadPotentialDiagAdaptGrad(QuadPotentialDiagAdapt):
    """Experimental grad-based adaptation (cf. ``quadpotential.py:272``).

    Uses a variance estimate from gradients; here we keep the sample-based
    estimator but track gradients too, matching the reference's documented
    behavior of being an experimental alternative.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._grad_state = welford_init(self.n)

    def update(self, sample, grad, tune):
        if not tune:
            return
        self._grad_state = welford_add(
            self._grad_state, jnp.asarray(grad, floatX()) ** 2)
        super().update(sample, grad, tune)


class QuadPotentialFull(_JaxPotentialMixin, QuadPotential):
    """Fixed dense mass matrix M=A (cf. ``quadpotential.py:440``)."""

    adapts = False

    def __init__(self, A, dtype=None):
        self.dtype = dtype or floatX()
        self._cov = np.asarray(A, dtype=self.dtype)
        import scipy.linalg
        self._chol = scipy.linalg.cholesky(self._cov, lower=True)
        self._n = len(self._cov)

    def _velocity(self, x):
        return np.dot(self._cov, x)

    def random(self):
        import scipy.linalg
        vals = np.random.normal(size=self._n).astype(self.dtype)
        return scipy.linalg.solve_triangular(self._chol.T, vals,
                                             overwrite_b=True)

    def init_kernel_state(self):
        return DenseState(cov=jnp.asarray(self._cov, floatX()),
                          chol=jnp.asarray(self._chol, floatX()))

    def energy(self, x, velocity=None):
        x = np.asarray(x, dtype=self.dtype)
        if velocity is None:
            velocity = self.velocity(x)
        return 0.5 * float(x.dot(velocity))


class QuadPotentialFullInv(QuadPotentialFull):
    """Fixed dense M^{-1} (cf. ``quadpotential.py:400``)."""

    def __init__(self, A, dtype=None):
        import scipy.linalg
        A = np.asarray(A)
        cov = scipy.linalg.cho_solve(
            (scipy.linalg.cholesky(A, lower=True), True), np.eye(len(A)))
        super().__init__(cov, dtype=dtype)


class DenseState(NamedTuple):
    cov: jnp.ndarray   # M^{-1}
    chol: jnp.ndarray  # lower cholesky of cov (momentum draws solve Lᵀp=z)


class QuadPotentialFullAdapt(QuadPotentialFull):
    """Adapt a dense mass matrix using the sample covariances
    (cf. ``quadpotential.py:482``). Stan-style doubling windows."""

    adapts = True

    def __init__(self, n, initial_mean, initial_cov=None, initial_weight=0,
                 adaptation_window=101, adaptation_window_multiplier=2,
                 update_window=1, dtype=None):
        if initial_cov is not None and initial_cov.ndim != 2:
            raise ValueError("Initial covariance must be two-dimensional.")
        if np.ndim(initial_mean) != 1:
            raise ValueError("Initial mean must be one-dimensional.")
        self.dtype = dtype or floatX()
        self._n = n
        if initial_cov is None:
            initial_cov = np.eye(n, dtype=self.dtype)
            initial_weight = 1
        self._initial_mean = np.asarray(initial_mean, self.dtype)
        self._initial_cov = np.asarray(initial_cov, self.dtype)
        self._initial_weight = initial_weight
        self.adaptation_window = int(adaptation_window)
        self.adaptation_window_multiplier = float(adaptation_window_multiplier)
        self._update_window = int(update_window)
        self.reset()

    def reset(self):
        self._previous_update = 0
        self._cov_mean = np.array(self._initial_mean, copy=True)
        self._cov_w = float(self._initial_weight)
        self._cov_m2 = self._initial_cov * self._initial_weight
        self._set_cov(self._initial_cov)
        self._n_samples = 0

    def init_kernel_state(self) -> DenseAdaptState:
        return dense_adapt_init(
            self._initial_mean, self._initial_cov, self._initial_weight,
            adaptation_window=self.adaptation_window)

    def _set_cov(self, cov):
        import scipy.linalg
        self._cov = np.asarray(cov, self.dtype)
        self._chol = scipy.linalg.cholesky(self._cov, lower=True)

    def update(self, sample, grad, tune):
        if not tune:
            return
        x = np.asarray(sample, self.dtype)
        self._cov_w += 1
        delta = x - self._cov_mean
        self._cov_mean += delta / self._cov_w
        self._cov_m2 += np.outer(delta, x - self._cov_mean)

        delta_w = self._n_samples - self._previous_update
        if delta_w >= self.adaptation_window and \
                self._n_samples % self._update_window == 0:
            w = self._cov_w
            cov = self._cov_m2 / (w - 1 + 1e-8)
            # regularize toward diag (Stan-style shrinkage)
            n = w
            shrink = n / (n + 5.0)
            cov = shrink * cov + (1 - shrink) * 1e-3 * np.eye(self._n)
            self._set_cov(cov)
            self._cov_mean = np.array(x, copy=True)
            self._cov_w = 1.0
            self._cov_m2 = np.zeros_like(self._cov_m2)
            self._previous_update = self._n_samples
            self.adaptation_window = int(
                self.adaptation_window * self.adaptation_window_multiplier)
        self._n_samples += 1


def quad_potential(C, is_cov):
    """Build a QuadPotential from a scaling array (cf. ``quadpotential.py:28``)."""
    partial_check_positive_definite(C)
    C = np.asarray(C)
    if C.ndim == 1:
        if is_cov:
            return QuadPotentialDiag(C)
        else:
            return QuadPotentialDiag(1.0 / C)
    else:
        if is_cov:
            return QuadPotentialFull(C)
        else:
            return QuadPotentialFullInv(C)
