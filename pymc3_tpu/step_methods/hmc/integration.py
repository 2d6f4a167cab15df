"""Leapfrog integration (cf. ``pymc3/step_methods/hmc/integration.py``).

The reference's ``CpuLeapfrogIntegrator`` calls BLAS ``axpy`` kicks around a
compiled-C logp+grad call per step (``integration.py:81-109``) — the hot
inner loop. Here the whole step is one traced JAX function: XLA fuses the
kicks/drift into the logp+grad computation, and under ``vmap`` the step runs
for thousands of chains at once.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax.numpy as jnp

from ...config import floatX
from .quadpotential import mass_velocity

__all__ = ["IntegrationState", "leapfrog", "compute_state", "IntegrationError"]


class IntegrationError(RuntimeError):
    pass


class IntegrationState(NamedTuple):
    """cf. the ``State`` namedtuple (``integration.py:16``)."""

    q: jnp.ndarray       # position
    p: jnp.ndarray       # momentum
    v: jnp.ndarray       # velocity M^{-1} p
    q_grad: jnp.ndarray  # dlogp/dq
    energy: jnp.ndarray  # H = kinetic - logp
    model_logp: jnp.ndarray


def compute_state(logp_dlogp_fn: Callable, var, q, p) -> IntegrationState:
    """Compute Hamiltonian state at (q, p) (cf. ``integration.py:39``)."""
    logp, grad = logp_dlogp_fn(q)
    v = mass_velocity(var, p)
    kinetic = 0.5 * jnp.dot(p, v)
    return IntegrationState(q=q, p=p, v=v, q_grad=grad,
                            energy=kinetic - logp, model_logp=logp)


def leapfrog(logp_dlogp_fn: Callable, var, epsilon,
             state: IntegrationState) -> IntegrationState:
    """One leapfrog step (cf. ``CpuLeapfrogIntegrator._step``,
    ``integration.py:81-109``): half kick, drift, half kick.

    ``epsilon`` may be negative (backwards integration for the NUTS left
    expansion). ``var`` is the inverse mass — an (n,) diagonal or an (n,n)
    dense matrix (``mass_velocity`` dispatches). Fully traceable; when the
    caller vmaps over chains every chain advances in lockstep.
    """
    epsilon = jnp.asarray(epsilon, dtype=floatX())
    axpy = lambda a, x, y: y + a * x

    p_half = axpy(0.5 * epsilon, state.q_grad, state.p)       # half kick
    v_half = mass_velocity(var, p_half)
    q_new = axpy(epsilon, v_half, state.q)                    # drift
    logp, q_grad_new = logp_dlogp_fn(q_new)
    p_new = axpy(0.5 * epsilon, q_grad_new, p_half)           # half kick
    v_new = mass_velocity(var, p_new)
    kinetic = 0.5 * jnp.dot(p_new, v_new)
    return IntegrationState(q=q_new, p=p_new, v=v_new, q_grad=q_grad_new,
                            energy=kinetic - logp, model_logp=logp)


class CpuLeapfrogIntegrator:
    """Host-facing wrapper with the reference's class API
    (cf. ``integration.py:28``)."""

    def __init__(self, potential, logp_dlogp_func):
        self._potential = potential
        self._logp_dlogp_func = logp_dlogp_func

    def _var(self):
        import numpy as np
        import jax.numpy as jnp
        from .quadpotential import kernel_mass
        st = self._potential.init_kernel_state()
        return jnp.asarray(kernel_mass(st))

    def compute_state(self, q, p):
        import jax
        import numpy as np
        fn = jax.jit(lambda q, p: compute_state(
            self._logp_dlogp_func, self._var(), q, p))
        return fn(jnp.asarray(q, floatX()), jnp.asarray(p, floatX()))

    def step(self, epsilon, state):
        import jax
        fn = jax.jit(lambda eps, s: leapfrog(
            self._logp_dlogp_func, self._var(), eps, s))
        out = fn(jnp.asarray(epsilon, floatX()), state)
        if not bool(jnp.isfinite(out.energy)):
            raise IntegrationError(
                f"Energy is not finite after leapfrog: {out.energy}")
        return out
