"""Sampling orchestration (cf. ``pymc3/sampling.py``).

``sample()`` keeps the reference's surface (``sampling.py:230-579``) but the
execution model is vectorized: instead of one OS process per chain with a
pipe protocol (``_mp_sample``, ``sampling.py:1305``; ``parallel_sampling.py``),
ALL chains advance in lockstep as a ``vmap`` batch axis of one jitted
``lax.scan`` program — warmup + draws compile to a single XLA executable, and
the chain axis can shard over a device mesh (``pymc3_tpu.parallel``).
Sampler statistics come back as device arrays and are flushed to the trace
backend once, replacing the per-draw pipe round-trip.
"""
from __future__ import annotations

import logging
import os
import time
import warnings
from collections import defaultdict
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import jax
import jax.numpy as jnp

from .backends.base import BaseTrace, MultiTrace
from .backends.ndarray import NDArray
from .backends.report import SamplerReport, SamplerWarning, WarningType
from .blocking import DictToArrayBijection
from .config import floatX
from .distributions.distribution import draw_values
from .exceptions import SamplingError
from .model import Point, all_continuous, modelcontext
from .step_methods import (
    NUTS, HamiltonianMC, Metropolis, BinaryMetropolis, BinaryGibbsMetropolis,
    CategoricalGibbsMetropolis, DEMetropolis, DEMetropolisZ, Slice,
    CompoundStep, STEP_METHODS,
)
from .step_methods.arraystep import BlockedStep, TuneContext
from .step_methods.hmc.quadpotential import (
    QuadPotentialDiag, QuadPotentialDiagAdapt, QuadPotentialFull,
    QuadPotentialFullAdapt,
)
from .util import get_default_varnames, get_var_name, update_start_vals
from .vartypes import discrete_types

__all__ = [
    "sample", "iter_sample", "sample_posterior_predictive",
    "sample_posterior_predictive_w", "init_nuts", "sample_prior_predictive",
    "fast_sample_posterior_predictive", "stop_tuning",
    "assign_step_methods", "instantiate_steppers",
]

_log = logging.getLogger("pymc3_tpu")


def instantiate_steppers(model, steps: List[BlockedStep], selected_steps,
                         step_kwargs=None) -> Union[BlockedStep, List]:
    """Instantiate appropriate steppers for groups of variables
    (cf. ``sampling.py:96-139``)."""
    if step_kwargs is None:
        step_kwargs = {}
    used_keys = set()
    for step_class, vars in selected_steps.items():
        if len(vars) == 0:
            continue
        args = step_kwargs.get(step_class.name, {})
        used_keys.add(step_class.name)
        step = step_class(vars=vars, model=model, **args)
        steps.append(step)

    unused_args = set(step_kwargs).difference(used_keys)
    if unused_args:
        raise ValueError(f"Unused step method arguments: {unused_args}")

    if len(steps) == 1:
        return steps[0]
    return steps


def assign_step_methods(model, step=None, methods=STEP_METHODS,
                        step_kwargs=None):
    """Assign model variables to appropriate step methods
    (cf. ``sampling.py:142-208``): per-RV max competence, with a gradient
    probe replacing the reference's ``tg.grad`` try/except."""
    steps = []
    assigned_vars = set()

    if step is not None:
        try:
            steps += list(step)
        except TypeError:
            steps.append(step)
        for s in steps:
            assigned_vars = assigned_vars.union(set(get_var_name(v)
                                                    for v in s.vars))

    # Use competence classmethods to select step methods for remaining vars
    selected_steps = defaultdict(list)
    for var in model.free_RVs:
        if get_var_name(var) in assigned_vars:
            continue
        # determine if the variable participates in a differentiable density
        has_grad = _has_grad(model, var)
        selected = max(methods,
                       key=lambda method: method.competence(var, has_grad))
        selected_steps[selected].append(var)

    return instantiate_steppers(model, steps, selected_steps, step_kwargs)


def _has_grad(model, var):
    """Gradient probe: is d logp/d var finite at the test point?"""
    if str(np.dtype(var.distribution.dtype)) in discrete_types:
        return False
    try:
        g = model.dlogp()
        vm = model.ordering.by_name[var.name]
        return bool(np.all(np.isfinite(g[vm.slc])))
    except Exception:
        return False


def _empty_model_error(model):
    if not model.free_RVs:
        raise ValueError("The model does not contain any free variables.")


def sample(draws=500, step=None, init="auto", n_init=200000, start=None,
           trace=None, chain_idx=0, chains=None, cores=None, tune=500,
           progressbar=True, model=None, random_seed=None,
           discard_tuned_samples=True, compute_convergence_checks=True,
           callback=None, return_inferencedata=None, idata_kwargs=None,
           mp_ctx=None, pickle_backend="pickle", target_accept=None,
           axis_name=None, devices=None, **kwargs):
    """Draw samples from the posterior (cf. ``sample``, ``sampling.py:230``).

    Semantics: ``chains`` is a vmap batch axis (default 4; use
    thousands freely), ``cores`` is accepted for API parity but ignored —
    parallelism comes from the device, not processes. Pass ``devices``/
    ``axis_name`` to shard chains over a ``jax.sharding.Mesh``
    (see ``pymc3_tpu.parallel``).
    """
    model = modelcontext(model)
    _empty_model_error(model)

    # keep the None sentinel: resume_from validation below must be able to
    # tell "user passed chains=4" from "defaulted to 4"
    chains_requested = chains
    if chains is None:
        chains = max(4, cores or 0)
    if target_accept is not None:
        kwargs.setdefault("nuts", {})["target_accept"] = target_accept

    if random_seed is None:
        random_seed = np.random.randint(0, 2**30)
    if isinstance(random_seed, (list, tuple, np.ndarray)):
        random_seed = int(np.asarray(random_seed).ravel()[0])
    random_seed = int(random_seed)

    start = _check_start_shape(model, start, chains)

    draws = int(draws)
    tune = int(tune)
    if draws + tune <= 0:
        raise ValueError("Argument `draws` must be greater than 0.")

    # -- step method selection (cf. sampling.py:486-538) ---------------------
    _stepper_names = ("nuts", "hmc", "metropolis", "slice", "DEMetropolis",
                      "DEMetropolisZ", "binary_metropolis",
                      "binary_gibbs_metropolis",
                      "categorical_gibbs_metropolis")
    step_kwargs = {}
    for name in _stepper_names:
        if name in kwargs:
            step_kwargs[name] = kwargs.pop(name)
    # list-valued stats subset: only these sampler stats cross the
    # device->host link (plus "diverging", always kept for the report)
    record_stats = kwargs.pop("record_stats", None)
    # warm resume (an extension, SURVEY §5 "Checkpoint/resume"): continue
    # a previous run from its last points AND its checkpointed kernel
    # state (mass matrix, step size) — typically with tune=0
    resume_from = kwargs.pop("resume_from", None)
    # legacy spelling: sample(step_kwargs={'nuts': {...}}) — keys must name
    # known steppers (cf. the reference's validation, tested at
    # ``tests/test_sampling.py:99``)
    legacy = kwargs.pop("step_kwargs", None)
    if legacy:
        bad = set(legacy) - set(_stepper_names)
        if bad:
            raise ValueError(
                f"Unknown step method(s) in step_kwargs: {sorted(bad)!r}; "
                f"valid names are {list(_stepper_names)}")
        step_kwargs.update(legacy)
    block_size = kwargs.pop("block_size", None)
    if kwargs:
        raise ValueError(
            f"Unknown keyword argument(s) for sample: {sorted(kwargs)!r}. "
            f"Step-method arguments are passed by stepper name, e.g. "
            f"sample(..., nuts={{'target_accept': 0.9}}).")

    start_points = None
    if step is None and init is not None and all_continuous(model.free_RVs):
        try:
            # NUTS initialization (cf. init_nuts, sampling.py:1837)
            start_points, step = init_nuts(
                init=init, chains=chains, n_init=n_init, model=model,
                random_seed=random_seed, progressbar=progressbar,
                axis_name=axis_name,
                **step_kwargs.get("nuts", {}))
        except (AttributeError, NotImplementedError) as e:
            _log.info(f"NUTS init failed ({e}); falling back to "
                      "auto-assignment")
            step = assign_step_methods(model, step,
                                       step_kwargs=step_kwargs)
    else:
        step = assign_step_methods(model, step, step_kwargs=step_kwargs)

    if isinstance(step, list):
        step = CompoundStep(step)

    # population-size validation (cf. ``sampling.py:512-531``)
    from .step_methods.metropolis import DEMetropolis as _DEM
    methods = step.methods if isinstance(step, CompoundStep) else [step]
    if any(isinstance(m, _DEM) for m in methods):
        ndim = int(sum(np.size(v.test_value) for v in model.free_RVs))
        if chains < 3:
            raise ValueError(
                f"DEMetropolis requires at least 3 chains. For this "
                f"{ndim}-dimensional model you should use >= {ndim + 1} "
                f"chains")
        if chains <= ndim:
            warnings.warn(
                f"DEMetropolis should be used with more chains than "
                f"dimensions! (The model has {ndim} dimensions.)",
                UserWarning)

    # -- start points per chain ----------------------------------------------
    warm_states = None
    if resume_from is not None:
        if chains_requested is not None \
                and resume_from.nchains != chains_requested:
            raise ValueError(
                f"resume_from has {resume_from.nchains} chains but "
                f"chains={chains_requested} was requested")
        chains = resume_from.nchains
        chain_starts = [resume_from.point(-1, chain=c)
                        for c in resume_from.chains]
        warm_states = [getattr(resume_from._straces[c], "warmup_state",
                               None) for c in resume_from.chains]
        if any(w is None for w in warm_states):
            _log.warning("resume_from trace carries no warmup-state "
                         "checkpoint; resuming from last points with "
                         "fresh adaptation state")
            warm_states = None
    elif start is not None:
        chain_starts = start
    elif start_points is not None:
        chain_starts = start_points
    else:
        chain_starts = [model.test_point] * chains

    q0 = np.stack([model.dict_to_array(_complete_point(model, p))
                   for p in chain_starts]).astype(floatX())

    _check_bad_init(model, chain_starts[0])

    # -- run the fused sampler ----------------------------------------------
    # a list-valued `trace` selects the variables to record (reference
    # semantics, ``sampling.py:268-271``); only those are decoded and
    # streamed device->host, which also slashes transfer volume
    trace, trace_vars = _resolve_trace_vars(model, trace)

    keep_from = tune if discard_tuned_samples else 0
    t_start = time.time()
    result = _device_sample(
        model=model, step=step, q0=q0, draws=draws, tune=tune,
        random_seed=random_seed, progressbar=progressbar,
        axis_name=axis_name, devices=devices, callback=callback,
        block_size=block_size, keep_from=keep_from,
        trace_vars=trace_vars, record_stats=record_stats,
        warm_states=warm_states)
    t_sampling = time.time() - t_start

    if result["interrupted"]:
        n_kept = max(0, result["completed"] - keep_from)
        if n_kept == 0:
            raise KeyboardInterrupt(
                "Sampling interrupted before any post-warmup draws "
                "completed.")
        _log.warning(
            f"Sampling interrupted: returning partial trace with {n_kept} "
            f"of {draws + tune - keep_from} draws per chain "
            f"(cf. the reference's partial-trace semantics, "
            f"sampling.py:1409-1443).")

    # -- build traces --------------------------------------------------------
    traces = _flush_to_traces(model, step, result, trace, chain_idx, chains,
                              keep_from, trace_vars=trace_vars)
    mtrace = MultiTrace(traces)
    mtrace._report = SamplerReport()
    mtrace.report._n_tune = tune
    mtrace.report._n_draws = draws
    mtrace.report._t_sampling = t_sampling
    # compile accounting (lower_s + compile_s; a persistent-cache warm
    # start shows up here as compile_s ~ 0)
    mtrace.report._t_compile = result.get("compile_info")

    # divergence warnings (cf. NUTS warnings, nuts.py:420-460)
    _attach_sample_stats_warnings(mtrace, step, tune, model)

    n_diverging = 0
    if "diverging" in (mtrace.stat_names or set()):
        n_diverging = int(np.sum(mtrace.get_sampler_stats("diverging")))
        if n_diverging > 0:
            _log.warning(
                f"There were {n_diverging} divergences after tuning. "
                f"Increase `target_accept` or reparameterize.")

    if compute_convergence_checks:
        if draws - tune < 100:
            warnings.warn("The number of samples is too small to check "
                          "convergence reliably.")
        else:
            mtrace.report._run_convergence_checks(mtrace, model)
    mtrace.report._log_summary()

    if return_inferencedata:
        from .backends.inferencedata import to_inference_data
        idata = to_inference_data(mtrace, model=model,
                                  **(idata_kwargs or {}))
        try:
            idata.report = mtrace.report
        except Exception:
            pass
        return idata
    return mtrace


def _complete_point(model, point):
    """Fill a (possibly partial, possibly untransformed) start point."""
    start = dict(point or {})
    update_start_vals(start, model.test_point, model)
    return {k: v for k, v in start.items()
            if k in model.ordering.by_name}


def _check_start_shape(model, start, chains):
    if start is None:
        return None
    if isinstance(start, dict):
        start = [start] * chains
    e = ""
    for elem in start:
        for var in model.free_RVs:
            name = var.name
            if name in elem:
                var_shape = np.shape(var.test_value)
                start_var_shape = np.shape(elem[name])
                if start_var_shape:
                    if start_var_shape != var_shape:
                        e += f"\nExpected shape {var_shape} for var " \
                             f"'{name}', got: {start_var_shape}"
                elif var_shape:
                    e += f"\nExpected shape {var_shape} for var " \
                         f"'{name}', got scalar {elem[name]}"
    if e:
        raise ValueError(f"Bad shape for start argument:{e}")
    return start


def _check_bad_init(model, start):
    """'Bad initial energy' check with per-RV attribution
    (cf. ``base_hmc.py:138-158`` / ``Model.check_test_point``)."""
    point = _complete_point(model, start)
    logp = model.logp(point)
    if not np.isfinite(logp):
        details = model.check_test_point(point)
        raise SamplingError(
            f"Initial evaluation of model at starting point failed!\n"
            f"Starting values:\n{point}\n\nInitial evaluation results:\n"
            f"{details}")


def _auto_block_size(total, chains, out_width):
    """Pick a draw-block length so one block's device output buffer stays
    within a fixed element budget — the streaming replacement for the
    reference's per-draw pipe flush (``parallel_sampling.py:403-438``):
    device memory holds only kernel state + one block of decoded draws,
    never the
    full sample history."""
    budget = int(5e7)  # elements per block across all chains (~200MB fp32)
    blk = max(16, budget // max(1, chains * max(1, out_width)))
    blk = min(total, blk)
    # equalize block sizes so the (single) compiled program pads < n_blocks
    n_blocks = -(-total // blk)
    return -(-total // n_blocks)


class _BlockProgress:
    """Minimal per-block progress line (draws done, divergences)."""

    def __init__(self, total, chains, enabled):
        self.total = total
        self.chains = chains
        self.enabled = enabled
        self.divergences = 0
        self.t0 = time.time()

    def update(self, done):
        if not self.enabled:
            return
        import sys
        elapsed = time.time() - self.t0
        rate = done * self.chains / max(elapsed, 1e-9)
        msg = (f"\rSampling {self.chains} chains: {done}/{self.total} draws "
               f"({100.0 * done / self.total:.0f}%) "
               f"[{rate:,.0f} draws/s, {self.divergences} divergences]")
        sys.stderr.write(msg)
        if done >= self.total:
            sys.stderr.write("\n")
        sys.stderr.flush()


def _resolve_trace_vars(model, trace):
    """A list-valued ``trace`` argument selects which unobserved variables
    to record (cf. the reference's ``trace`` list semantics,
    ``pymc3/sampling.py:268-271``). Returns ``(trace_backend_arg,
    vars_subset_or_None)``."""
    if not isinstance(trace, (list, tuple)):
        return trace, None
    by_name = {v.name: v for v in model.unobserved_RVs}
    vars_ = []
    for item in trace:
        name = item if isinstance(item, str) else getattr(item, "name", None)
        if name is None or name not in by_name:
            raise ValueError(
                f"trace list entries must name unobserved model variables; "
                f"got {item!r}")
        vars_.append(by_name[name])
    return None, vars_


def _device_sample(model, step, q0, draws, tune, random_seed, progressbar,
                   axis_name=None, devices=None, callback=None,
                   block_size=None, keep_from=0, trace_vars=None,
                   record_stats=None, warm_states=None):
    """Run warmup+draws as a sequence of fixed-size jitted scan blocks,
    vmapped (and optionally mesh-sharded) over chains.

    Memory model: the per-draw q history never materializes — each scan
    step decodes q into constrained variable values on device, and each
    block's (chains, block, ...) output is flushed to host while the next
    block runs (async dispatch double-buffering). A ``KeyboardInterrupt``
    between blocks yields everything flushed so far (cf. the reference's
    partial-trace semantics, ``pymc3/sampling.py:1409-1443``).

    Returns dict with ``values`` {name: (chains, n_kept, ...)}, ``stats``
    (list per sampler of {name: (chains, n_kept)}), ``final_state``,
    ``completed`` (total steps finished) and ``interrupted``.
    """
    chains, dim = q0.shape
    total = draws + tune
    key = jax.random.PRNGKey(random_seed)
    chain_keys = jax.random.split(key, chains)

    unobserved = model.unobserved_RVs if trace_vars is None else trace_vars
    varnames = [v.name for v in unobserved]
    from .node import _ev

    def decode(q):
        env = model._env_from_q(q)
        memo = {}
        return {v.name: jnp.asarray(_ev(v, env, memo)) for v in unobserved}

    out_width = int(sum(
        max(1, int(np.prod(np.shape(v.test_value)))) for v in unobserved))
    # the device block buffer holds the per-draw STATS alongside the
    # decoded values (record_stats trimming happens host-side), so the
    # budget must count them: at 8192 chains a 1000-step block of 13
    # stats alone is ~0.5 GB, and the driver double-buffers blocks
    n_stats = int(sum(len(d) for d in step.stats_dtypes))         if step.generates_stats else 0
    if block_size is None:
        block_size = _auto_block_size(total, chains, out_width + n_stats)
    block = int(min(total, max(1, block_size)))
    n_blocks = -(-total // block)

    population_based = getattr(step, "population_based", False)
    tune_arr = jnp.asarray(tune, jnp.int32)
    total_arr = jnp.asarray(total, jnp.int32)

    # Stan-style step-size probe before warmup (nuts.find_reasonable_eps):
    # dual averaging then starts at an eps matched to the posterior scale
    # instead of spending the first tuning block in max-depth trees
    # recovering from the 0.25 d^-1/4 guess. Skipped on warm resume — the
    # checkpointed DA state already carries the adapted eps.
    if tune > 0 and warm_states is None and \
            not os.environ.get("PYMC3_TPU_NO_EPS_PROBE"):
        from .step_methods.hmc.nuts import find_reasonable_eps
        methods = step.methods if isinstance(step, CompoundStep) else [step]
        for m in methods:
            if getattr(m, "adapt_step_size", False) and \
                    hasattr(m, "step_size") and hasattr(m, "potential"):
                m.step_size = find_reasonable_eps(m, q0, random_seed)

    def _mask_padding(idx, new, old):
        """Freeze carry updates for the equalize-blocks padding steps past
        ``total`` so the checkpointed final_state (and every chain's RNG)
        corresponds exactly to draw ``total``."""
        active = idx < total_arr
        return jax.tree_util.tree_map(
            lambda a, b: jnp.where(active, a, b), new, old)

    if population_based:
        # population methods step the whole (chains, dim) block at once
        init_carry = (key, jnp.asarray(q0), step.kernel_init(jnp.asarray(q0)))

        def run_block(carry, idxs):
            def one_step(c, idx):
                k, Q, st = c
                k2, sub = jax.random.split(k)
                tctx = TuneContext(idx < tune_arr, idx, tune)
                Q2, st2, stats = step.population_kernel_step(sub, Q, st, tctx)
                new_c = _mask_padding(idx, (k2, Q2, st2), c)
                return new_c, (jax.vmap(decode)(Q2), stats)
            return jax.lax.scan(one_step, carry, idxs)

        run_block = jax.jit(run_block)
        time_axis = 0  # outputs are (block, chains, ...)
    else:
        from .parallel import LOCAL_CHAIN_AXIS

        def chain_block(carry, idxs):
            def one_step(c, idx):
                k, q, st = c
                k2, sub = jax.random.split(k)
                tctx = TuneContext(idx < tune_arr, idx, tune)
                q2, st2, stats = step.kernel_step(sub, q, st, tctx)
                new_c = _mask_padding(idx, (k2, q2, st2), c)
                return new_c, (decode(q2), stats)
            return jax.lax.scan(one_step, carry, idxs)

        if (axis_name not in (None, LOCAL_CHAIN_AXIS)) or devices is not None:
            from .parallel import shard_block_fn
            run_block = shard_block_fn(chain_block, devices=devices)
            init_state = jax.vmap(step.kernel_init)(jnp.asarray(q0))
        else:
            run_block = jax.jit(jax.vmap(
                chain_block, in_axes=(0, None), out_axes=(0, 0),
                axis_name=LOCAL_CHAIN_AXIS))
            init_state = jax.jit(jax.vmap(step.kernel_init))(jnp.asarray(q0))
        if warm_states is not None:
            init_state = _restore_warmup_state(init_state, warm_states)
        init_carry = (chain_keys, jnp.asarray(q0), init_state)
        time_axis = 1  # outputs are (chains, block, ...)

    # -- AOT compile, timed apart from the run ---------------------------
    # ``lower()`` traces the block program; ``compile()`` is pure XLA
    # compilation (a persistent-cache hit returns in ~ms — see
    # ``config.enable_compilation_cache``). Keeping these off the first
    # block's wall makes compile cost a first-class, separately reported
    # number instead of being folded into "first run is slow".
    idxs0 = jnp.arange(0, block, dtype=jnp.int32)
    t0 = time.time()
    lowered = run_block.lower(init_carry, idxs0)
    t_lower = time.time() - t0
    t0 = time.time()
    run_block = lowered.compile()
    t_compile = time.time() - t0
    compile_info = {"lower_s": round(t_lower, 3),
                    "compile_s": round(t_compile, 3),
                    "block": block, "n_blocks": n_blocks}

    # -- host streaming loop with async double-buffering ---------------------
    host_vals = {name: [] for name in varnames}
    host_stats = None
    completed = 0
    interrupted = False
    progress = _BlockProgress(total, chains, progressbar)
    carry = init_carry
    pending = None  # (start_idx, device vals, device stats)

    drained = set()  # block start indices already committed to host

    def _drain(start, vals, stats):
        """Move one block's kept slice to host (blocks until ready).

        Idempotent and interrupt-safe: every device->host transfer (where
        the host spends its time blocking) completes BEFORE any host list
        mutates, and an already-drained block is never re-appended — so the
        KeyboardInterrupt handler can safely re-call this on the pending
        block without double-counting chunks."""
        nonlocal host_stats, completed
        if start in drained:
            return
        lo = max(keep_from, start)
        hi = min(start + block, total)
        if hi > lo:
            a, b = lo - start, hi - start
            sl = (slice(None), slice(a, b)) if time_axis == 1 \
                else (slice(a, b),)

            def to_host(x):
                arr = np.asarray(x[sl])
                if time_axis == 0:
                    arr = np.moveaxis(arr, 0, 1)
                return arr

            # interruptible phase: materialize everything on host first
            new_vals = {name: to_host(vals[name]) for name in varnames}
            if isinstance(step, CompoundStep):
                stats_list = stats
            else:
                stats_list = [stats] if step.generates_stats else []
            # list-valued ``record_stats`` selects which sampler stats
            # cross the device->host link (same trimming semantics as the
            # list-valued ``trace`` for values)
            new_stats = [{k: to_host(v) for k, v in s.items()
                          if record_stats is None or k in record_stats
                          or k == "diverging"}
                         for s in stats_list]
            # commit phase: pure list appends, marked done up front
            drained.add(start)
            for name in varnames:
                host_vals[name].append(new_vals[name])
            if host_stats is None:
                host_stats = [defaultdict(list) for _ in new_stats]
            for acc, s in zip(host_stats, new_stats):
                for k, v in s.items():
                    acc[k].append(v)
                    if k == "diverging":
                        progress.divergences += int(v.sum())
        else:
            # block entirely inside discarded warmup: just sync
            jax.block_until_ready(stats if stats else vals)
            drained.add(start)
        completed = max(completed, min(start + block, total))
        progress.update(completed)

    try:
        for b in range(n_blocks):
            start = b * block
            idxs = jnp.arange(start, start + block, dtype=jnp.int32)
            carry, (vals, stats) = run_block(carry, idxs)  # async dispatch
            if pending is not None:
                _drain(*pending)
            pending = (start, vals, stats)
            if callback is not None:
                from types import SimpleNamespace
                callback(trace=None, draw=SimpleNamespace(
                    chain=None, is_last=(b == n_blocks - 1),
                    draw_idx=min(start + block, total),
                    tuning=start + block <= tune, stats=None, point=None))
        if pending is not None:
            _drain(*pending)
            pending = None
    except KeyboardInterrupt:
        interrupted = True
        if pending is not None:
            try:
                _drain(*pending)
            except KeyboardInterrupt:
                pass
        # A mid-commit interrupt can leave unequal chunk counts across
        # series; truncate everything to the common prefix so concatenated
        # chains stay draw-aligned.
        counts = [len(v) for v in host_vals.values()]
        for acc in (host_stats or []):
            counts.extend(len(v) for v in acc.values())
        if counts:
            n_chunks = min(counts)
            for name in varnames:
                del host_vals[name][n_chunks:]
            for acc in (host_stats or []):
                for k in acc:
                    del acc[k][n_chunks:]
            if varnames and host_vals[varnames[0]]:
                kept = sum(c.shape[1] for c in host_vals[varnames[0]])
                completed = min(completed, keep_from + kept)

    def _cat(chunks):
        if not chunks:
            return None
        return np.concatenate(chunks, axis=1)

    values = {k: _cat(v) for k, v in host_vals.items()}
    stats_out = []
    for acc in (host_stats or []):
        stats_out.append({k: _cat(v) for k, v in acc.items()})
    return {"values": values, "stats": stats_out,
            "final_state": carry[2], "completed": completed,
            "interrupted": interrupted, "compile_info": compile_info}


def _flush_to_traces(model, step, result, trace_arg, chain_idx, chains,
                     keep_from, trace_vars=None):
    """Record streamed (chains, n_kept, ...) value blocks into per-chain
    trace backends."""
    unobserved = model.unobserved_RVs if trace_vars is None else trace_vars
    var_values = result["values"]
    any_val = next((v for v in var_values.values() if v is not None), None)
    nkept = 0 if any_val is None else any_val.shape[1]

    stats_dtypes = None
    if step.generates_stats:
        # declare only the stats that actually crossed to the host (a
        # record_stats subset trims them at drain time)
        stats_dtypes = []
        for s_i, dtypes in enumerate(step.stats_dtypes):
            streamed = result["stats"][s_i] if s_i < len(result["stats"]) \
                else None
            if streamed:
                dtypes = {k: dt for k, dt in dtypes.items() if k in streamed}
            stats_dtypes.append(dtypes)
    # Materialize the final kernel state ONCE: np.asarray on a device
    # array is a fresh device->host transfer every call, and doing it
    # per chain per leaf would re-ship the same ~70 MB state once per
    # chain (8192 times at 8192 chains). One transfer per leaf, then
    # zero-copy per-chain views.
    state_leaves = None
    if result.get("final_state") is not None:
        try:
            leaves, _ = jax.tree_util.tree_flatten(result["final_state"])
            state_leaves = [np.asarray(l) for l in leaves]
        except Exception:
            state_leaves = None

    traces = []
    for ci in range(chains):
        if isinstance(trace_arg, BaseTrace):
            if chains > 1:
                raise ValueError("Cannot reuse a single trace for multiple "
                                 "chains")
            strace = trace_arg
        elif isinstance(trace_arg, str):
            from .backends import _shortcuts
            backend = _shortcuts[trace_arg]["backend"]
            strace = backend(_shortcuts[trace_arg]["name"], model=model,
                             vars=unobserved)
        else:
            strace = NDArray(model=model, vars=unobserved)
        # stats go only to backends that store them (cf. the reference's
        # ``supports_sampler_stats`` gate, ``sampling.py:615-620``) — a
        # SQLite trace still records the draws, it just drops the stats
        keep_stats = strace.supports_sampler_stats
        strace.setup(nkept, chain_idx + ci,
                     stats_dtypes if keep_stats else None)
        if nkept:
            chain_vals = {k: v[ci] for k, v in var_values.items()}
            stats_batch = None
            if stats_dtypes and keep_stats:
                stats_batch = []
                for s_i, dtypes in enumerate(step.stats_dtypes):
                    src = result["stats"][s_i]
                    stats_batch.append({
                        k: np.asarray(src[k][ci]).astype(dt)
                        for k, dt in dtypes.items()
                        if src.get(k) is not None})
            strace.record_batch(chain_vals, nkept, stats_batch)
        # warmup-state checkpoint (an extension, SURVEY §5)
        strace.warmup_state = None if state_leaves is None else {
            f"leaf{i}": (leaf[ci] if leaf.ndim > 0 else leaf)
            for i, leaf in enumerate(state_leaves)}
        strace.close()
        traces.append(strace)
    return traces


def _restore_warmup_state(template_state, warm_states):
    """Rebuild the (chains, ...) kernel-state pytree from per-chain
    checkpoints written by ``_flush_to_traces`` (leaf-ordered dict).
    Falls back to the fresh template when the structure does not match
    (e.g. resuming with a different stepper)."""
    leaves, treedef = jax.tree_util.tree_flatten(template_state)
    try:
        stacked = []
        for i, leaf in enumerate(leaves):
            per_chain = [np.asarray(w[f"leaf{i}"]) for w in warm_states]
            arr = jnp.asarray(np.stack(per_chain)).astype(leaf.dtype)
            if arr.shape != leaf.shape:
                raise ValueError(f"leaf{i}: {arr.shape} != {leaf.shape}")
            stacked.append(arr)
    except (KeyError, ValueError) as e:
        _log.warning(f"warmup-state checkpoint does not match the current "
                     f"kernel state ({e}); resuming with fresh adaptation")
        return template_state
    return jax.tree_util.tree_unflatten(treedef, stacked)


def _attach_sample_stats_warnings(mtrace, step, tune, model=None):
    report = mtrace.report
    try:
        # per-chain non-finite-logp detection with per-RV attribution
        # (cf. the reference's "Bad initial energy" per-RV breakdown,
        # base_hmc.py:138-158 — here applied to any draw of the run)
        if model is not None and "model_logp" in mtrace.stat_names:
            for chain in mtrace.chains:
                lp = np.asarray(mtrace.get_sampler_stats(
                    "model_logp", chains=[chain]), dtype=np.float64)
                bad = ~np.isfinite(lp)
                if bad.any():
                    idx = int(np.argmax(bad))
                    try:
                        point = mtrace.point(idx, chain=chain)
                        per_rv = model.check_test_point(point)
                        offenders = [str(k) for k, v in per_rv.items()
                                     if not np.isfinite(v)]
                    except Exception:
                        offenders = []
                    names = ", ".join(offenders) if offenders \
                        else "unattributed"
                    report._add_warnings([SamplerWarning(
                        WarningType.BAD_ENERGY,
                        f"Chain {chain} hit a non-finite model logp at draw "
                        f"{idx} (offending logp terms: {names}).",
                        "warn", idx, None, None)], chain)
    except (KeyError, ValueError):
        pass
    try:
        if "diverging" in mtrace.stat_names:
            for chain in mtrace.chains:
                div = np.asarray(mtrace.get_sampler_stats(
                    "diverging", chains=[chain]))
                n = int(div.sum())
                if n:
                    report._add_warnings([SamplerWarning(
                        WarningType.DIVERGENCES,
                        f"Chain {chain} had {n} diverging samples after "
                        "tuning.", "warn", None, None, None)], chain)
        if "depth" in mtrace.stat_names:
            for chain in mtrace.chains:
                depth = np.asarray(mtrace.get_sampler_stats(
                    "depth", chains=[chain]))
                # early tuning uses a reduced cap; compare to the final cap
                for s in (step.methods if isinstance(step, CompoundStep)
                          else [step]):
                    if hasattr(s, "max_treedepth"):
                        n = int((depth >= s.max_treedepth).sum())
                        if n:
                            report._add_warnings([SamplerWarning(
                                WarningType.TREEDEPTH,
                                f"Chain {chain} reached the maximum tree "
                                f"depth. Increase max_treedepth, increase "
                                f"target_accept or reparameterize.",
                                "warn", None, None, None)], chain)
    except (KeyError, ValueError):
        pass


# ---------------------------------------------------------------------------
# sequential / iterator API (debug path, cf. sampling.py:607-952)
# ---------------------------------------------------------------------------
def iter_sample(draws, step, start=None, trace=None, chain=0, tune=None,
                model=None, random_seed=None, callback=None):
    """Generator that yields a cumulative trace each draw
    (cf. ``iter_sample``, ``sampling.py:581``)."""
    sampling = _iter_sample(draws, step, start, trace, chain, tune, model,
                            random_seed, callback)
    for i, (strace, _) in enumerate(sampling):
        yield MultiTrace([strace[:i + 1]])


def _iter_sample(draws, step, start=None, trace=None, chain=0, tune=None,
                 model=None, random_seed=None, callback=None):
    """Single-chain host-side sampling generator (cf. ``sampling.py:847``)."""
    model = modelcontext(model)
    draws = int(draws)
    tune = int(tune) if tune is not None else 0
    if random_seed is not None:
        np.random.seed(int(np.asarray(random_seed).ravel()[0]))
    if draws < 1:
        raise ValueError("Argument `draws` must be greater than 0.")

    if start is None:
        start = {}
    point = _complete_point(model, start)

    if isinstance(trace, BaseTrace):
        strace = trace
    else:
        strace = NDArray(model=model)

    try:
        step = CompoundStep(step)
    except TypeError:
        pass

    stats_dtypes = step.stats_dtypes if step.generates_stats else None
    strace.setup(draws, chain, stats_dtypes)

    try:
        step.tune = bool(tune)
        if hasattr(step, "reset_tuning"):
            step.reset_tuning()
        for i in range(draws):
            if i == tune:
                step.stop_tuning()
            if step.generates_stats:
                point, stats = step.step(point)
                strace.record(point, stats)
                diverging = i > tune and any(
                    s.get("diverging", False) for s in stats)
            else:
                point = step.step(point)
                strace.record(point)
                diverging = False
            if callback is not None:
                callback(trace=strace, draw=(chain, i == draws - 1, i, i < (tune or 0),
                                             None, point))
            yield strace, diverging
    except KeyboardInterrupt:
        strace.close()
        raise
    except BaseException:
        strace.close()
        raise
    else:
        strace.close()


def stop_tuning(step):
    """Stop tuning the current step method (cf. ``sampling.py:952``)."""
    step.stop_tuning()
    return step


# ---------------------------------------------------------------------------
# NUTS initialization (cf. init_nuts, sampling.py:1837-2014)
# ---------------------------------------------------------------------------
def init_nuts(init="auto", chains=1, n_init=500000, model=None,
              random_seed=None, progressbar=True, axis_name=None, **kwargs):
    """Set up the mass matrix initialization for NUTS
    (cf. ``sampling.py:1837``). Strategies: auto, adapt_diag,
    jitter+adapt_diag, advi+adapt_diag, advi+adapt_diag_grad, advi, advi_map,
    map, nuts, adapt_full, jitter+adapt_full."""
    model = modelcontext(model)
    vars = kwargs.get("vars", model.vars)
    if set(vars) != set(model.vars):
        raise ValueError("Must use init_nuts on all variables of a model.")
    if not all_continuous(vars):
        raise ValueError("init_nuts can only be used for models with only "
                         "continuous variables.")

    if not isinstance(init, str):
        raise TypeError("init must be a string.")
    init = init.lower()
    if init == "auto":
        init = "jitter+adapt_diag"

    _log.info(f"Initializing NUTS using {init}...")

    if random_seed is not None:
        random_seed = int(np.atleast_1d(random_seed)[0])
        np.random.seed(random_seed)

    cb = []  # VI convergence callbacks filled in the advi paths

    q0 = model.dict_to_array(model.test_point).astype(floatX())
    n = q0.shape[0]

    def _jitter_starts():
        starts = []
        for _ in range(chains):
            jitter = np.random.uniform(-1, 1, size=n).astype(floatX())
            starts.append(model.array_to_dict(q0 + jitter))
        return starts

    if init == "adapt_diag":
        start = [model.test_point] * chains
        mean = q0
        var = np.ones_like(mean)
        potential = QuadPotentialDiagAdapt(n, mean, var, 10)
    elif init == "jitter+adapt_diag":
        start = _jitter_starts()
        mean = np.stack([model.dict_to_array(p) for p in start]).mean(axis=0)
        var = np.ones_like(mean)
        potential = QuadPotentialDiagAdapt(n, mean, var, 10)
    elif init in ("advi+adapt_diag", "advi+adapt_diag_grad", "advi",
                  "advi_map"):
        from .variational import fit as vi_fit
        from .variational.callbacks import CheckParametersConvergence
        cb = [CheckParametersConvergence(tolerance=1e-2, diff="absolute"),
              CheckParametersConvergence(tolerance=1e-2, diff="relative")]
        approx = vi_fit(random_seed=random_seed, n=n_init, method="advi",
                        model=model, callbacks=cb,
                        progressbar=progressbar)
        approx_trace = approx.sample(draws=chains)
        start = [{k: np.asarray(approx_trace.point(i)[k]) for k in
                  model.ordering.by_name} for i in range(chains)]
        mean = np.asarray(approx.mean)
        std = np.asarray(approx.std)
        cov = std ** 2
        if init == "advi+adapt_diag" or init == "advi+adapt_diag_grad":
            potential = QuadPotentialDiagAdapt(n, mean, cov, 50)
        else:
            if init == "advi_map":
                from .tuning import find_MAP
                start_map = find_MAP(model=model)
                start = [start_map] * chains
            potential = QuadPotentialDiag(cov)
    elif init == "map":
        from .tuning import find_MAP
        start_map = find_MAP(model=model)
        q_map = model.dict_to_array(start_map)
        import scipy.linalg
        from .tuning import find_hessian
        try:
            H = find_hessian(start_map, model=model)
            cov = np.linalg.inv(H)
            potential = QuadPotentialFull(cov)
        except Exception:
            potential = QuadPotentialDiagAdapt(n, q_map, np.ones(n), 10)
        start = [start_map] * chains
    elif init == "adapt_full":
        start = [model.test_point] * chains
        potential = QuadPotentialFullAdapt(n, q0)
    elif init == "jitter+adapt_full":
        start = _jitter_starts()
        mean = np.stack([model.dict_to_array(p) for p in start]).mean(axis=0)
        potential = QuadPotentialFullAdapt(n, mean)
    elif init == "nuts":
        # short pilot NUTS run to build a diag estimate
        start = _jitter_starts()
        potential = QuadPotentialDiagAdapt(n, q0, np.ones(n), 10)
    else:
        raise ValueError(f"Unknown initializer: {init}.")

    step = NUTS(potential=potential, model=model, axis_name=axis_name,
                **{k: v for k, v in kwargs.items() if k != "vars"})
    return start, step


# ---------------------------------------------------------------------------
# Predictive sampling (cf. sampling.py:1510-1835)
# ---------------------------------------------------------------------------
def sample_prior_predictive(samples=500, model=None, vars=None,
                            var_names=None, random_seed=None) -> Dict[str, np.ndarray]:
    """Generate samples from the prior predictive distribution
    (cf. ``sampling.py:1766``) — a single vmapped pure function over draws
    (the reference's ``draw_values`` DAG interpreter is replaced by forward
    evaluation in declaration order, SURVEY §7.7)."""
    model = modelcontext(model)

    if vars is None and var_names is None:
        prior_pred_vars = model.observed_RVs
        prior_vars = (get_default_varnames(model.unobserved_RVs,
                                           include_transformed=True) +
                      list(model.deterministics))
        vars_: Sequence[str] = [get_var_name(var)
                                for var in prior_vars + prior_pred_vars]
    elif vars is None:
        vars_ = var_names
    elif var_names is None:
        vars_ = [get_var_name(v) for v in vars]
    else:
        raise ValueError("Cannot supply both vars and var_names arguments.")

    if random_seed is not None:
        np.random.seed(int(np.atleast_1d(random_seed)[0]))

    # `samples` may be an int or a size tuple (reference semantics,
    # tests/test_shape_handling.py:212): draws carry a `size`-shaped lead
    # axis, with 1/(1,) collapsing to scalar draws for backwards compat
    from .distributions.shape_utils import to_tuple
    size = to_tuple(samples) if samples is not None else ()
    if size == (1,):
        size = ()
    flat = int(np.prod(size, dtype=int)) if size else 1

    names = [v for v in vars_]
    values = model.sample_forward(flat)

    data = {}
    for name in names:
        if name in values:
            out = np.asarray(values[name])
            data[name] = out.reshape(size + out.shape[1:])
    if data is None:
        raise AssertionError(f"No variables sampled: attempting to sample {names}")
    return data


def sample_posterior_predictive(trace, samples=None, model=None, vars=None,
                                var_names=None, size=None, keep_size=False,
                                random_seed=None, progressbar=True
                                ) -> Dict[str, np.ndarray]:
    """Generate posterior-predictive samples from a model given a trace
    (cf. ``sampling.py:1510``). Vectorized over the whole trace — the
    reference's ``fast_sample_posterior_predictive`` semantics are the only
    path (SURVEY §3.5)."""
    model = modelcontext(model)

    if isinstance(trace, dict):
        points = _dict_trace_to_points(trace, model)
    elif isinstance(trace, MultiTrace):
        points = [trace.point(i, chain=c) for c in trace.chains
                  for i in range(len(trace))]
    elif isinstance(trace, list):
        points = [dict(p) for p in trace]
    else:
        raise TypeError("Unsupported trace type")

    nchain = trace.nchains if isinstance(trace, MultiTrace) else 1
    len_trace = len(points) // max(nchain, 1)

    if keep_size and samples is not None:
        raise IncorrectArgumentsError(
            "Should not specify both keep_size and samples arguments")
    if keep_size and size is not None:
        raise IncorrectArgumentsError(
            "Should not specify both keep_size and size arguments")

    if samples is None:
        samples = len(points)

    if samples < len_trace * nchain:
        warnings.warn("samples parameter is smaller than nchains times "
                      "ndraws, some draws and/or chains may not be "
                      "represented in the returned posterior predictive "
                      "sample")

    if var_names is not None:
        if vars is not None:
            raise IncorrectArgumentsError(
                "Should not specify both vars and var_names arguments.")
        vars = [model[x] for x in var_names]
    elif vars is None:
        vars = model.observed_RVs

    if random_seed is not None:
        np.random.seed(int(np.atleast_1d(random_seed)[0]))

    # choose point indices (cycled / subsampled like the reference)
    idx = np.mod(np.arange(samples), len(points))

    out = model.sample_forward_conditional(points, idx, vars, size=size)

    if keep_size:
        out = {k: np.reshape(v, (nchain, len_trace) + np.shape(v)[1:])
               for k, v in out.items()}
    return out


def fast_sample_posterior_predictive(trace, samples=None, model=None,
                                     var_names=None, keep_size=False,
                                     random_seed=None) -> Dict[str, np.ndarray]:
    """Vectorized posterior predictive
    (cf. ``distributions/posterior_predictive.py:124``). In this build the
    standard path IS vectorized, so this is an alias."""
    return sample_posterior_predictive(
        trace, samples=samples, model=model, var_names=var_names,
        keep_size=keep_size, random_seed=random_seed, progressbar=False)


def sample_posterior_predictive_w(traces, samples=None, models=None,
                                  weights=None, random_seed=None,
                                  progressbar=True):
    """Generate weighted posterior predictive samples from model mixtures
    (cf. ``sampling.py:1636``)."""
    if models is None:
        models = [modelcontext(None)] * len(traces)
    if weights is None:
        weights = [1.0] * len(traces)
    if len(traces) != len(weights) or len(models) != len(weights):
        raise ValueError("The number of traces, models and weights must be "
                         "the same")
    if random_seed is not None:
        np.random.seed(int(np.atleast_1d(random_seed)[0]))

    weights = np.asarray(weights, dtype=float)
    p = weights / weights.sum()

    if samples is None:
        samples = min(len(tr) * tr.nchains for tr in traces)

    ns = np.random.multinomial(samples, p)
    results = defaultdict(list)
    for tr, m, n in zip(traces, models, ns):
        if n == 0:
            continue
        sub = sample_posterior_predictive(tr, samples=int(n), model=m,
                                          progressbar=False)
        for k, v in sub.items():
            results[k].append(v)
    return {k: np.concatenate(v, axis=0) for k, v in results.items()}


class IncorrectArgumentsError(ValueError):
    pass


def _dict_trace_to_points(trace: Dict[str, np.ndarray], model):
    lengths = {len(np.atleast_1d(v)) for v in trace.values()}
    if len(lengths) != 1:
        raise ValueError("Arrays in trace dict must have equal length")
    n = lengths.pop()
    return [{k: np.asarray(v)[i] for k, v in trace.items()}
            for i in range(n)]
