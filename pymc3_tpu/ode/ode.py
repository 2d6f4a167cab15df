"""Bayesian ODEs (cf. ``pymc3/ode/ode.py``).

The reference wraps ``scipy.integrate.odeint`` (LSODA) in a Theano Op whose
gradient comes from forward sensitivities integrated alongside the state
(``ode/ode.py:27``, ``augment_system``, ``ode/utils.py:60``). Here the
solver itself is traced JAX: a fixed-grid RK4 integrator written with
``lax.scan``, differentiated *natively* by JAX (reverse-mode through the
scan replaces the hand-built sensitivity system) — no host round trip, and
the whole posterior logp including the ODE solve is one XLA program.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..config import floatX
from ..node import Node, apply as node_apply, as_node

__all__ = ["DifferentialEquation"]


def _rk4_step(func, y, t, dt, theta):
    k1 = func(y, t, theta)
    k2 = func(y + 0.5 * dt * k1, t + 0.5 * dt, theta)
    k3 = func(y + 0.5 * dt * k2, t + 0.5 * dt, theta)
    k4 = func(y + dt * k3, t + dt, theta)
    return y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


# Dormand-Prince 4(5) tableau (the embedded pair behind RK45 / ode45 — the
# on-device replacement for LSODA's adaptivity, cf. ``ode/ode.py:115``).
_DP_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_DP_A = np.zeros((7, 7))
_DP_A[1, 0] = 1 / 5
_DP_A[2, :2] = [3 / 40, 9 / 40]
_DP_A[3, :3] = [44 / 45, -56 / 15, 32 / 9]
_DP_A[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
_DP_A[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176,
                -5103 / 18656]
_DP_A[6, :6] = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
_DP_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784,
                   11 / 84, 0.0])
_DP_B4 = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
                   -92097 / 339200, 187 / 2100, 1 / 40])


def _dopri5_step(f, y, t, dt, theta):
    """One embedded DOPRI5 step: returns (y5, y5 - y4 error estimate)."""
    ks = []
    for i in range(7):
        yi = y
        for j in range(i):
            aij = _DP_A[i, j]
            if aij != 0.0:
                yi = yi + dt * aij * ks[j]
        ks.append(f(yi, t + _DP_C[i] * dt, theta))
    y5 = y + dt * sum(b * k for b, k in zip(_DP_B5, ks) if b != 0.0)
    y4 = y + dt * sum(b * k for b, k in zip(_DP_B4, ks) if b != 0.0)
    return y5, y5 - y4


class DifferentialEquation:
    """Specify an ODE solved on a fixed time grid (cf. ``ode/ode.py:27``).

    Parameters
    ----------
    func : callable
        ``func(y, t, p)`` returning dy/dt (jax-traceable; list/tuple returns
        are stacked).
    times : array
        Output times (must be increasing; t0 prepended).
    n_states : int
    n_theta : int
    t0 : float
    n_substeps : int
        RK4 substeps between consecutive output times (accuracy knob —
        replaces LSODA's adaptivity with a static-shape grid XLA can fuse).
    """

    def __init__(self, func, times, n_states, n_theta, t0=0,
                 n_substeps=4, method="rk45", rtol=None, atol=None,
                 max_steps=None):
        if not callable(func):
            raise ValueError("Argument func must be callable.")
        if n_states < 1:
            raise ValueError("Argument n_states must be at least 1.")
        if n_theta <= 0:
            raise ValueError("Argument n_theta must be positive.")
        if method not in ("rk45", "rk4"):
            raise ValueError("method must be 'rk45' (adaptive) or 'rk4' "
                             "(fixed grid)")
        self.func = func
        self.t0 = float(t0)
        self.times = np.asarray(times, dtype=np.float64)
        # t0 == times[0] is allowed (the reference's freefall asv benchmark
        # uses it, ``benchmarks.py:225``): the first observation then IS
        # the initial condition
        if np.any(np.diff(self.times) <= 0) or t0 > self.times[0]:
            raise ValueError("The initial time t0 must be less than or "
                             "equal to the first observation time, and "
                             "times must be strictly increasing.")
        if t0 == self.times[0] and len(self.times) < 2:
            raise ValueError("With t0 == times[0] at least two observation "
                             "times are required.")
        self.n_states = int(n_states)
        self.n_theta = int(n_theta)
        self.n_times = len(self.times)
        self.n_substeps = int(n_substeps)
        self.method = method
        wide = floatX() == "float64"
        self.rtol = float(rtol) if rtol is not None else \
            (1e-8 if wide else 1e-4)
        self.atol = float(atol) if atol is not None else \
            (1e-8 if wide else 1e-6)
        # bounded-scan length: every logp (and its reverse pass) costs
        # max_steps DOPRI5 stages whether or not the controller needed
        # them, so an oversized blanket bound taxes each of NUTS's ~1e3
        # leapfrogs per draw. When not given explicitly, the first
        # ``__call__`` calibrates the bound from the measured attempt
        # count at the test point (margin 3x, see ``calibrate``).
        self._auto_max_steps = max_steps is None
        if max_steps is None:
            max_steps = int(np.clip(16 * self.n_times, 256, 4096))
        self.max_steps = int(max_steps)

    def _wrap_func(self):
        func = self.func

        def f(y, t, p):
            out = func(y, t, p)
            if isinstance(out, (list, tuple)):
                out = jnp.stack([jnp.asarray(o, floatX()).reshape(())
                                 for o in out])
            return jnp.asarray(out, floatX()).reshape(y.shape)
        return f

    def _solve_adaptive(self, y0, theta):
        """(n_times, n_states) adaptive DOPRI5 solution with PI step-size
        control.

        The step loop is a *bounded* ``lax.scan`` of ``max_steps``
        iterations with done-masking rather than a ``lax.while_loop`` —
        scans are reverse-differentiable, so the whole posterior gradient
        flows through the accepted steps natively (the reference instead
        integrates a hand-built forward-sensitivity system through LSODA,
        ``ode/ode.py:110-120`` / ``ode/utils.py:60``).
        """
        f = self._wrap_func()
        y0 = jnp.asarray(y0, floatX()).reshape((self.n_states,))
        theta = jnp.asarray(theta, floatX()).reshape((self.n_theta,))
        times = jnp.asarray(self.times, floatX())
        n_out = self.n_times
        rtol = jnp.asarray(self.rtol, floatX())
        atol = jnp.asarray(self.atol, floatX())
        t_end = float(self.times[-1])

        # initial step: a conservative fraction of the first nonzero
        # segment; with t0 == times[0] the first output is y0 itself
        t0_is_first = bool(self.times[0] == self.t0)
        first_end = self.times[1] if t0_is_first else self.times[0]
        dt0 = jnp.asarray((first_end - self.t0) / 8.0, floatX())

        def body(state, _):
            t, y, dt, out_idx, ys = state
            done = out_idx >= n_out
            t_target = times[jnp.minimum(out_idx, n_out - 1)]
            remaining = t_target - t
            h = jnp.minimum(dt, remaining)
            h = jnp.maximum(h, jnp.asarray(1e-10, floatX()))

            y_new, err = _dopri5_step(f, y, t, h, theta)
            scale = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y_new))
            err_norm = jnp.sqrt(jnp.mean((err / scale) ** 2))
            err_norm = jnp.where(jnp.isnan(err_norm), jnp.inf, err_norm)
            # discretize-then-optimize: the accepted step-size sequence is
            # treated as data — gradients flow through the state dynamics,
            # not the controller (avoids NaN-poisoning through the
            # rejected-step/inf-error branches)
            err_norm = lax.stop_gradient(err_norm)
            accept = err_norm <= 1.0

            # I-controller with limiter (cf. Hairer-Norsett-Wanner II.4)
            factor = jnp.clip(
                0.9 * jnp.power(jnp.maximum(err_norm, 1e-10), -0.2),
                0.2, 5.0)
            dt_next = jnp.clip(h * factor, 1e-8, t_end - self.t0)

            step_ok = accept & ~done
            t_new = jnp.where(step_ok, t + h, t)
            y_next = jnp.where(step_ok, y_new, y)
            reached = step_ok & (t + h >= t_target - 1e-9)
            write_idx = jnp.minimum(out_idx, n_out - 1)
            ys = jnp.where(reached,
                           ys.at[write_idx].set(y_new), ys)
            out_next = out_idx + jnp.asarray(reached, out_idx.dtype)
            dt_keep = jnp.where(done, dt, dt_next)
            return (t_new, y_next, dt_keep, out_next, ys), None

        ys0 = jnp.zeros((n_out, self.n_states), floatX())
        out_idx0 = 0
        if t0_is_first:
            ys0 = ys0.at[0].set(y0)
            out_idx0 = 1
        state0 = (jnp.asarray(self.t0, floatX()), y0, dt0,
                  jnp.asarray(out_idx0, jnp.int32), ys0)
        (t_f, y_f, _, out_f, ys), _ = lax.scan(body, state0, None,
                                               length=self.max_steps)
        # if max_steps ran out before all outputs were written, poison the
        # remaining rows with NaN so the logp is -inf rather than silently
        # wrong (cf. `bound()` double-guard discipline)
        incomplete = jnp.arange(n_out) >= out_f
        ys = jnp.where(incomplete[:, None], jnp.nan, ys)
        return ys

    def _count_steps(self, y0, theta):
        """Attempted/accepted DOPRI5 step counts at concrete (y0, theta)
        — the calibration measurement behind auto ``max_steps``."""
        f = self._wrap_func()
        y0 = jnp.asarray(y0, floatX()).reshape((self.n_states,))
        theta = jnp.asarray(theta, floatX()).reshape((self.n_theta,))
        times = jnp.asarray(self.times, floatX())
        n_out = self.n_times
        rtol = jnp.asarray(self.rtol, floatX())
        atol = jnp.asarray(self.atol, floatX())
        t_end = float(self.times[-1])
        t0_is_first = bool(self.times[0] == self.t0)
        first_end = self.times[1] if t0_is_first else self.times[0]
        dt0 = jnp.asarray((first_end - self.t0) / 8.0, floatX())

        def body(state, _):
            t, y, dt, out_idx, n_att, n_acc = state
            done = out_idx >= n_out
            t_target = times[jnp.minimum(out_idx, n_out - 1)]
            h = jnp.maximum(jnp.minimum(dt, t_target - t),
                            jnp.asarray(1e-10, floatX()))
            y_new, err = _dopri5_step(f, y, t, h, theta)
            scale = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y_new))
            err_norm = jnp.sqrt(jnp.mean((err / scale) ** 2))
            err_norm = jnp.where(jnp.isnan(err_norm), jnp.inf, err_norm)
            accept = err_norm <= 1.0
            factor = jnp.clip(
                0.9 * jnp.power(jnp.maximum(err_norm, 1e-10), -0.2),
                0.2, 5.0)
            dt_next = jnp.clip(h * factor, 1e-8, t_end - self.t0)
            step_ok = accept & ~done
            t_new = jnp.where(step_ok, t + h, t)
            y_next = jnp.where(step_ok, y_new, y)
            reached = step_ok & (t + h >= t_target - 1e-9)
            out_next = out_idx + jnp.asarray(reached, out_idx.dtype)
            return (t_new, y_next, jnp.where(done, dt, dt_next), out_next,
                    n_att + jnp.asarray(~done, jnp.int32),
                    n_acc + jnp.asarray(step_ok, jnp.int32)), None

        out_idx0 = 1 if t0_is_first else 0
        state0 = (jnp.asarray(self.t0, floatX()), y0, dt0,
                  jnp.asarray(out_idx0, jnp.int32),
                  jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))
        (_, _, _, out_f, n_att, n_acc), _ = lax.scan(
            body, state0, None, length=max(4096, self.max_steps))
        return {"attempts": int(n_att), "accepted": int(n_acc),
                "outputs_written": int(out_f), "complete":
                bool(int(out_f) >= n_out)}

    def calibrate(self, y0, theta, margin=3.0, probe_scales=(0.5, 1.0, 2.0)):
        """Set ``max_steps`` from measured DOPRI5 attempt counts with a
        safety margin. Called automatically on first ``__call__`` when
        ``max_steps`` was not given.

        Posterior draws land away from the test point, often in stiffer
        parameter regions that need more controller steps; a bound sized
        from the test point alone silently rejects those draws (NaN
        poisoning -> -inf logp), truncating the posterior toward easy-ODE
        regions. So the bound covers a 4x span of parameter magnitudes
        (``theta`` scaled by each of ``probe_scales``) and takes the worst
        probe. If any probe fails to finish within the probe budget the
        pre-calibration blanket bound (``clip(16*n_times, 256, 4096)``)
        is kept. An undersized bound is still never silently wrong for a
        single draw — unfinished solves are NaN-poisoned and rejected."""
        y0 = np.asarray(y0, dtype=np.float64)
        theta = np.asarray(theta, dtype=np.float64)
        attempts = []
        for s in probe_scales:
            stats = self._count_steps(y0, theta * s)
            if not stats["complete"]:
                return stats
            attempts.append(stats["attempts"])
        self.max_steps = max(int(np.ceil(margin * max(attempts))),
                             4 * self.n_times, 64)
        return stats

    def _solve(self, y0, theta):
        """(n_times, n_states) solution, fully traceable."""
        if self.method == "rk45":
            return self._solve_adaptive(y0, theta)
        f = self._wrap_func()

        y0 = jnp.asarray(y0, floatX()).reshape((self.n_states,))
        theta = jnp.asarray(theta, floatX()).reshape((self.n_theta,))

        grid = np.concatenate([[self.t0], self.times])
        # substep time points between outputs, shape (n_times, n_substeps)
        starts = grid[:-1]
        ends = grid[1:]
        dts = ((ends - starts) / self.n_substeps).astype(floatX())
        sub_ts = (starts[:, None] +
                  np.arange(self.n_substeps)[None, :] *
                  ((ends - starts) / self.n_substeps)[:, None]).astype(
                      floatX())

        def advance(y, inp):
            ts_i, dt_i = inp

            def sub(y, t):
                return _rk4_step(f, y, t, dt_i, theta), None
            y, _ = lax.scan(sub, y, ts_i)
            return y, y

        _, ys = lax.scan(advance, y0, (jnp.asarray(sub_ts),
                                       jnp.asarray(dts)))
        return ys

    def __call__(self, y0, theta, return_sens=False, **kwargs):
        """Build the symbolic solution node (cf. ``ode/ode.py:84``)."""
        if isinstance(y0, (list, tuple)) and len(y0) != self.n_states:
            raise ValueError(f"Length of y0 is wrong. Expected {self.n_states}"
                             f", got {len(y0)}.")
        if isinstance(theta, (list, tuple)) and len(theta) != self.n_theta:
            raise ValueError(f"Length of theta is wrong. Expected "
                             f"{self.n_theta}, got {len(theta)}.")

        def pack(*vals):
            return jnp.stack([jnp.asarray(v, floatX()).reshape(())
                              for v in vals]) if len(vals) > 1 else \
                jnp.asarray(vals[0], floatX()).reshape(-1)

        if isinstance(y0, (list, tuple)):
            y0_node = node_apply(pack, *y0)
        else:
            y0_node = as_node(y0)
        if isinstance(theta, (list, tuple)):
            theta_node = node_apply(pack, *theta)
        else:
            theta_node = as_node(theta)

        if self._auto_max_steps and self.method == "rk45":
            # size the bounded scan from the test-point step count once
            # (margin 3x; see ``calibrate``) — the blanket 16*n_times
            # bound taxed every leapfrog ~5x on smooth problems
            self._auto_max_steps = False
            self.calibrate(np.asarray(y0_node.test_value, np.float64),
                           np.asarray(theta_node.test_value, np.float64))

        sol = node_apply(lambda y0_, th_: self._solve(y0_, th_),
                         y0_node, theta_node)
        return sol

    def __repr__(self):
        return (f"DifferentialEquation(n_states={self.n_states}, "
                f"n_theta={self.n_theta})")
