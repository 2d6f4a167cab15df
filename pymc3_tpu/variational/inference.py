"""VI inference drivers (cf. ``pymc3/variational/inference.py``).

``Inference.fit`` (``inference.py:101``) runs the optimization; here the hot
loop is a jitted ``lax.scan`` over blocks of steps (callbacks fire between
blocks), so one host call advances hundreds of fused XLA update steps.
Drivers: ADVI (``:323``), FullRankADVI (``:471``), SVGD (``:522``), ASVGD
(``:596``), NFVI (``:679``), dispatcher ``fit()`` (``:734``).
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..config import floatX
from ..model import modelcontext
from .approximations import (
    Empirical, FullRank, MeanField, NormalizingFlow,
)
from .operators import KL, KSD
from .opvi import Approximation
from .updates import adagrad_window

logger = logging.getLogger("pymc3_tpu")

__all__ = ["ADVI", "FullRankADVI", "SVGD", "ASVGD", "NFVI", "Inference",
           "ImplicitGradient", "KLqp", "fit"]

State = None


class Inference:
    """Base inference class (cf. ``inference.py:50``)."""

    def __init__(self, op, approx, tf, **kwargs):
        self.hist = np.asarray(())
        self.objective = op(approx, **kwargs)(tf)
        self.state = None

    @property
    def approx(self) -> Approximation:
        return self.objective.approx

    def run_profiling(self, n=1000, score=None, **kwargs):
        """Time the fused step (cf. ``inference.py:86``)."""
        import time
        step, opt = self.objective.step_function(**kwargs)
        params = self.approx.params
        opt_state = opt.init(params)
        key = jax.random.PRNGKey(0)
        jitted = jax.jit(step)
        t0 = time.perf_counter()
        jitted(params, opt_state, key)
        compile_time = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(n):
            key, sub = jax.random.split(key)
            params, opt_state, _ = jitted(params, opt_state, sub)
        jax.block_until_ready(params)
        total = time.perf_counter() - t0
        return {"n": n, "compile_time_s": compile_time,
                "per_step_us": total / n * 1e6}

    def fit(self, n=10000, score=None, callbacks=None, progressbar=True,
            obj_n_mc=1, obj_optimizer=None, block=1000, random_seed=None,
            total_grad_norm_constraint=None, **kwargs) -> Approximation:
        """Run optimization (cf. ``inference.py:101``).

        The loop is chunked: ``block`` jitted steps per ``lax.scan`` call,
        callbacks between chunks. The default 1000 amortizes the host's
        per-dispatch latency over many steps; pass a smaller ``block`` for
        finer callback granularity.
        """
        if callbacks is None:
            callbacks = []
        # Cache the compiled step across fit()/refine() calls: rebuilding
        # the jit wrapper re-traces the whole objective, and re-tracing
        # re-uploads the model's data constants to the device (a large
        # design matrix is copied again on every fit() call).
        # The model's pm.Data values are baked into the trace as constants,
        # so the key includes every shared container's version counter —
        # set_data() between fit() calls forces a retrace (the reference
        # gets this for free from Theano shared variables). The optimizer
        # is held strongly and compared with `is`: an id() of a collected
        # object can be recycled by a different optimizer.
        data_versions = tuple(
            (name, node.version)
            for name, node in sorted(self.approx.model.named_vars.items())
            if hasattr(node, "version") and hasattr(node, "set_value"))
        cache_key = (obj_n_mc, total_grad_norm_constraint, data_versions)
        # refine() replays the previous fit's objective settings
        self._refine_kwargs = dict(
            obj_n_mc=obj_n_mc, obj_optimizer=obj_optimizer, block=block,
            total_grad_norm_constraint=total_grad_norm_constraint)
        cached = getattr(self, "_step_cache", None)
        if cached is not None and cached[0] == cache_key \
                and cached[1] is obj_optimizer:
            _, _, step, opt, run_block = cached
        else:
            passed_optimizer = obj_optimizer
            if obj_optimizer is None:
                obj_optimizer = adagrad_window()
            step, opt = self.objective.step_function(
                obj_n_mc=obj_n_mc, obj_optimizer=obj_optimizer,
                total_grad_norm_constraint=total_grad_norm_constraint)

            def scan_block(carry, _):
                params, opt_state, key = carry
                key, sub = jax.random.split(key)
                params, opt_state, loss = step(params, opt_state, sub)
                return (params, opt_state, key), loss

            from functools import partial

            @partial(jax.jit, static_argnums=(3,))
            def run_block(params, opt_state, key, nsteps):
                (params, opt_state, key), losses = jax.lax.scan(
                    scan_block, (params, opt_state, key), None,
                    length=nsteps)
                return params, opt_state, key, losses

            self._step_cache = (cache_key, passed_optimizer, step, opt,
                                run_block)

        params = self.approx.params
        # a carried-over optimizer state is only valid with the optimizer
        # that produced it: a rebuilt step with a different optimizer
        # (different object, different algorithm) re-initializes
        if self.state is None or getattr(self, "_state_opt", None) is not opt:
            opt_state = opt.init(params)
        else:
            opt_state = self.state
        self._state_opt = opt

        if random_seed is None:
            random_seed = np.random.randint(0, 2**31 - 1)
        key = jax.random.PRNGKey(int(random_seed))

        hist = list(self.hist)
        i = 0
        try:
            while i < n:
                nsteps = min(block, n - i)
                # run_block is static in nsteps; a final partial block
                # compiles one extra variant through the same wrapper
                params, opt_state, key, losses = run_block(
                    params, opt_state, key, nsteps)
                losses = np.asarray(losses)
                hist.extend(losses.tolist())
                i += nsteps
                self.approx.params = params
                self.state = opt_state
                if not np.isfinite(losses[-1]):
                    logger.warning(
                        f"NaN/inf loss at iteration {i}; continuing "
                        "(gradients are masked for non-finite steps)")
                for cb in callbacks:
                    cb(self.approx, np.asarray(hist), i)
        except (KeyboardInterrupt, StopIteration) as e:
            if isinstance(e, StopIteration):
                logger.info(str(e))
        self.hist = np.asarray(hist)
        self.approx.hist = self.hist
        return self.approx

    def refine(self, n, progressbar=True):
        """Refine the solution using the last compiled step function and
        the last fit's objective settings — optimizer included, so the
        carried optimizer state stays valid (cf. ``inference.py:277``)."""
        kwargs = getattr(self, "_refine_kwargs", {})
        return self.fit(n, progressbar=progressbar, **kwargs)


class KLqp(Inference):
    """KL-divergence VI (cf. ``inference.py:294``)."""

    def __init__(self, approx, beta=1.0):
        super().__init__(KL, approx, None, beta=beta)


def _build_local_approx(model, local_rv, global_family, start=None):
    """Approximation = one local (AEVB) mean-field group per entry of
    ``local_rv`` + one global group over the remaining free RVs
    (cf. reference ``Inference.__init__`` local_rv plumbing,
    ``inference.py:55-66``)."""
    from .approximations import MeanFieldGroup, FullRankGroup
    groups = []
    local_names = set()
    for var, spec in local_rv.items():
        if isinstance(spec, (tuple, list)):
            spec = dict(mu=spec[0], rho=spec[1])
        g = MeanFieldGroup([var], local=True, params=dict(spec), model=model)
        groups.append(g)
        local_names.update(v.name for v in g.group_vars)
    rest = [v for v in model.free_RVs if v.name not in local_names]
    if rest:
        fam = {"mean_field": MeanFieldGroup,
               "full_rank": FullRankGroup}[global_family]
        groups.append(fam(rest, model=model))
    return Approximation(groups, model=model)


class ADVI(KLqp):
    """Automatic Differentiation Variational Inference
    (cf. ``inference.py:323``). ``local_rv={rv: dict(mu=..., rho=...)}``
    enables AEVB local groups (cf. ``test_vae``/``test_aevb`` in the
    reference suite)."""

    def __init__(self, *args, model=None, random_seed=None, start=None,
                 local_rv=None, **kwargs):
        model = modelcontext(model)
        if local_rv:
            approx = _build_local_approx(model, local_rv, "mean_field",
                                         start=start)
        else:
            approx = MeanField(model=model, start=start)
        super().__init__(approx, **{k: v for k, v in kwargs.items()
                                    if k == "beta"})


class FullRankADVI(KLqp):
    """Full-rank ADVI (cf. ``inference.py:471``)."""

    def __init__(self, *args, model=None, random_seed=None, start=None,
                 local_rv=None, **kwargs):
        model = modelcontext(model)
        if local_rv:
            approx = _build_local_approx(model, local_rv, "full_rank",
                                         start=start)
        else:
            approx = FullRank(model=model)
        super().__init__(approx, **{k: v for k, v in kwargs.items()
                                    if k == "beta"})


class ImplicitGradient(Inference):
    """Base for particle methods (cf. ``inference.py:506``)."""

    def __init__(self, approx, estimator=KSD, kernel=None, **kwargs):
        from .test_functions import RBF
        if kernel is None:
            kernel = RBF()
        super().__init__(op=estimator, approx=approx, tf=kernel, **kwargs)


class SVGD(ImplicitGradient):
    """Stein Variational Gradient Descent (cf. ``inference.py:522``)."""

    def __init__(self, n_particles=100, jitter=1, model=None, start=None,
                 random_seed=None, estimator=KSD, kernel=None,
                 temperature=1.0, **kwargs):
        if random_seed is not None:
            np.random.seed(int(random_seed))
        model = modelcontext(model)
        approx = Empirical(size=n_particles, model=model)
        super().__init__(approx=approx, estimator=estimator, kernel=kernel,
                         temperature=temperature, **kwargs)


class ASVGD(ImplicitGradient):
    """Amortized SVGD (cf. ``inference.py:596``): a parametric sampler
    (default FullRank, matching the reference) trained under the
    kernelized Stein discrepancy. Each step reparameterizes ``obj_n_mc``
    draws, computes the Stein direction ``phi*`` over them, and pulls it
    back through the sampler's VJP (``Delta theta = (1/n) sum_i
    phi*(x_i)^T dx_i/dtheta`` — Wang & Liu 2016, arXiv:1611.01722).
    Temperature caveats of the reference apply (posterior variance is
    often underestimated at temperature 1)."""

    def __init__(self, approx=None, estimator=KSD, kernel=None,
                 model=None, random_seed=None, **kwargs):
        if random_seed is not None:
            np.random.seed(int(random_seed))
        if approx is None:
            approx = FullRank(model=modelcontext(model))
        super().__init__(approx=approx, estimator=estimator, kernel=kernel,
                         **kwargs)

    def fit(self, n=10000, score=None, callbacks=None, progressbar=True,
            obj_n_mc=100, **kwargs):
        """cf. the reference's obj_n_mc=500 default (``inference.py:660``);
        100 keeps the O(n^2) kernel matrix cheap at equal quality for the
        low-dimensional targets this estimator suits."""
        return super().fit(n=n, score=score, callbacks=callbacks,
                           progressbar=progressbar, obj_n_mc=obj_n_mc,
                           **kwargs)


class NFVI(KLqp):
    """Normalizing-flow VI (cf. ``inference.py:679``)."""

    def __init__(self, flow="scale-loc", model=None, **kwargs):
        model = modelcontext(model)
        approx = NormalizingFlow(flow=flow, model=model)
        super().__init__(approx, **{k: v for k, v in kwargs.items()
                                    if k == "beta"})


def fit(n=10000, local_rv=None, method="advi", model=None, random_seed=None,
        start=None, inf_kwargs=None, **kwargs) -> Approximation:
    """Fit a variational approximation (cf. ``fit``, ``inference.py:734``).

    method : str | Inference
        'advi' | 'fullrank_advi' | 'svgd' | 'asvgd' | 'nfvi' |
        'nfvi=<formula>'
    """
    if inf_kwargs is None:
        inf_kwargs = dict()
    else:
        inf_kwargs = dict(inf_kwargs)
    if local_rv is not None:
        if not (isinstance(method, str)
                and method in ("advi", "fullrank_advi")):
            raise NotImplementedError(
                "local_rv (AEVB) is only supported for advi/fullrank_advi "
                "(cf. reference op_err on non-KLqp operators)")
        inf_kwargs["local_rv"] = local_rv
    if random_seed is not None:
        inf_kwargs["random_seed"] = random_seed
    if start is not None:
        inf_kwargs["start"] = start
    if model is None:
        model = modelcontext(model)
    _select = dict(advi=ADVI, fullrank_advi=FullRankADVI, svgd=SVGD,
                   asvgd=ASVGD, nfvi=NFVI)
    if isinstance(method, str):
        method = method.lower()
        if method.startswith("nfvi="):
            formula = method[len("nfvi="):]
            inference = NFVI(formula, model=model, **inf_kwargs)
        elif method in _select:
            inference = _select[method](model=model, **inf_kwargs)
        else:
            raise KeyError(f"method should be one of "
                           f"{set(_select.keys())} or Inference instance")
    elif isinstance(method, Inference):
        inference = method
    else:
        raise TypeError(f"method should be one of "
                        f"{set(_select.keys())} or Inference instance")
    fit_kwargs = {k: v for k, v in kwargs.items()
                  if k not in ("random_seed", "start",
                               "obj_optimizer_kwargs")}
    if "random_seed" in inf_kwargs:
        fit_kwargs["random_seed"] = inf_kwargs["random_seed"]
    return inference.fit(n, **fit_kwargs)
