"""JAX-side graph utilities — the JAX analog of ``pymc3/theanof.py``.

The reference exposes symbolic-graph helpers (``gradient/hessian/jacobian``,
``inputvars``, ``join_nonshared_inputs``, ``make_shared_replacements``,
``CallableTensor``, ``generator``, the global symbolic RNG
``tt_rng``/``set_tt_rng``, ``take_along_axis``; ``theanof.py:27-43``) built on
Theano's graph introspection. Here the same surface operates on the pure
``Node`` DAG, and differentiation goes through ``jax.grad``/``jax.jacfwd``/
``jax.hessian`` of the DAG's evaluation function — traced once, compiled by
XLA, with no runtime interpreter.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from .config import floatX, intX
from .node import Node, NamedNode, apply, as_node, evaluate
from .vartypes import continuous_types

__all__ = [
    "gradient",
    "hessian",
    "hessian_diag",
    "inputvars",
    "cont_inputs",
    "floatX",
    "intX",
    "smartfloatX",
    "jacobian",
    "CallableTensor",
    "join_nonshared_inputs",
    "make_shared_replacements",
    "generator",
    "set_tt_rng",
    "tt_rng",
    "take_along_axis",
]


def _walk(node) -> List[Node]:
    """All nodes reachable from ``node`` (or an iterable of nodes)."""
    roots = list(node) if isinstance(node, (list, tuple)) else [node]
    seen, order, stack = set(), [], [r for r in roots if isinstance(r, Node)]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        order.append(n)
        for a in getattr(n, "args", ()):
            if isinstance(a, Node):
                stack.append(a)
    return order


def inputvars(a):
    """Named input variables feeding the graph (cf. ``theanof.py:45``)."""
    out, names = [], set()
    for n in _walk(a):
        if isinstance(n, NamedNode) and n.name is not None \
                and n.name not in names:
            names.add(n.name)
            out.append(n)
    return out


def cont_inputs(a):
    """Continuous-dtype named inputs (cf. ``theanof.py:62``)."""
    return [v for v in inputvars(a)
            if np.asarray(v.test_value).dtype.name in continuous_types
            or np.issubdtype(np.asarray(v.test_value).dtype, np.floating)]


def smartfloatX(x):
    """Cast float arrays to floatX, leave ints alone (``theanof.py:105``)."""
    x = np.asarray(x)
    if np.issubdtype(x.dtype, np.floating):
        return x.astype(floatX())
    return x


def _diff_node(f, vars, mode):
    """Build a Node computing a derivative of scalar node ``f`` w.r.t. the
    flat concatenation of ``vars`` (NamedNodes). ``mode`` in
    {'grad','jac','hess','hess_diag'}. JAX traces straight through the DAG's
    evaluation — one fused XLA program, no symbolic rewrite pass needed."""
    if vars is None:
        vars = cont_inputs(f)
    if not vars:
        raise ValueError("no differentiable inputs found")
    all_vars = inputvars(f)
    dset = {v.name for v in vars}
    rest = [v for v in all_vars if v.name not in dset]
    dnames = [v.name for v in vars]
    shapes = [np.shape(np.asarray(v.test_value)) for v in vars]
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]
    splits = np.cumsum(sizes)[:-1].tolist()

    def run(*vals):
        dvals = vals[:len(vars)]
        env_rest = dict(zip([v.name for v in rest], vals[len(vars):]))

        def fun(flat):
            parts = jnp.split(flat, splits) if splits else [flat]
            env = dict(env_rest)
            for nm, p, s in zip(dnames, parts, shapes):
                env[nm] = jnp.reshape(p, s)
            return evaluate(f, env, {})

        flat0 = jnp.concatenate(
            [jnp.ravel(jnp.asarray(v)) for v in dvals]) if dvals else \
            jnp.zeros((0,), floatX())
        if mode == "grad":
            return jax.grad(fun)(flat0)
        if mode == "jac":
            return jax.jacfwd(fun)(flat0)
        if mode == "hess":
            return jax.hessian(fun)(flat0)
        # hess_diag: forward-over-reverse, diagonal only
        return jnp.diagonal(jax.hessian(fun)(flat0))

    return apply(run, *vars, *rest)


def gradient(f, vars=None):
    """∇f as a Node over the flat-joined vars (cf. ``theanof.py:125``)."""
    return _diff_node(f, vars, "grad")


def jacobian(f, vars=None):
    """Jacobian of (possibly vector) node f (cf. ``theanof.py:146``)."""
    return _diff_node(f, vars, "jac")


def hessian(f, vars=None):
    """Dense Hessian (cf. ``theanof.py:168``)."""
    return _diff_node(f, vars, "hess")


def hessian_diag(f, vars=None):
    """Hessian diagonal (cf. ``theanof.py:193``)."""
    return _diff_node(f, vars, "hess_diag")


class CallableTensor:
    """Make a graph callable on a replacement input
    (cf. ``theanof.py:291``): ``CallableTensor(out_node)(input_node)``
    substitutes ``input_node`` for the single named input of the graph."""

    def __init__(self, tensor):
        self.tensor = as_node(tensor)

    def __call__(self, input):
        ins = inputvars(self.tensor)
        if len(ins) != 1:
            raise ValueError(
                f"graph has {len(ins)} named inputs, need exactly 1")
        name = ins[0].name
        inp = as_node(input)
        return apply(
            lambda x, _t=self.tensor, _n=name: evaluate(_t, {_n: x}, {}), inp)


def join_nonshared_inputs(xs: Sequence, vars: Sequence, shared: Dict,
                          make_shared: bool = False):
    """Flat-join ``vars`` into one vector input (cf. ``theanof.py:243``).

    Returns ``(new_xs, joined)`` where ``joined`` is a NamedNode
    ``'__joined__'`` and each graph in ``xs`` is rewritten to read its vars
    as reshaped slices of it; ``shared`` maps var -> fixed value for inputs
    frozen out of the join (the reference's shared-variable replacement).
    """
    if not vars:
        raise ValueError("Empty list of variables.")
    vars = [as_node(v) for v in vars]
    names = [v.name for v in vars]
    shapes = [np.shape(np.asarray(v.test_value)) for v in vars]
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]
    splits = np.cumsum(sizes)[:-1].tolist()
    tv = np.concatenate([np.ravel(np.asarray(v.test_value, floatX()))
                         for v in vars]) if vars else np.zeros(0, floatX())

    joined = NamedNode.__new__(NamedNode)
    joined.name = "__joined__"
    joined._test_value = tv

    frozen = {getattr(k, "name", k): np.asarray(v)
              for k, v in (shared or {}).items()}

    def rewrite(x):
        x = as_node(x)

        def run(flat, _x=x):
            parts = jnp.split(flat, splits) if splits else [flat]
            env = {nm: jnp.reshape(p, s)
                   for nm, p, s in zip(names, parts, shapes)}
            for nm, v in frozen.items():
                env[nm] = jnp.asarray(v)
            return evaluate(_x, env, {})

        return apply(run, joined)

    return [rewrite(x) for x in xs], joined


def make_shared_replacements(vars, model) -> Dict:
    """Freeze every model var *not* in ``vars`` at its test value
    (cf. ``theanof.py:223``) — the dict plugs into
    ``join_nonshared_inputs(shared=...)``."""
    othervars = set(model.vars) - set(vars)
    return {var: np.asarray(var.test_value) for var in othervars}


def generator(gen, default=None):
    """Node fed from a Python generator per evaluation
    (cf. ``theanof.py:314`` GeneratorOp)."""
    from .data import GeneratorAdapter
    return GeneratorAdapter(gen).make_variable("generator")


class _RandomStream:
    """Global forward-sampling RNG — the JAX stand-in for Theano's
    ``MRG_RandomStreams`` (``theanof.py:398-430``): a counter-based
    ``jax.random`` key split per use, plus a seeded numpy Generator for the
    host-side ``random()`` paths."""

    def __init__(self, seed=42):
        self.seed(seed)

    def seed(self, seed):
        # the device key is created lazily: materializing it here would
        # initialize the XLA backend at import time, which breaks
        # multi-host bring-up (jax.distributed.initialize must run first)
        self._seed = seed
        self._key = None
        self.np_rng = np.random.default_rng(seed)

    def next_key(self):
        if self._key is None:
            self._key = jax.random.PRNGKey(self._seed)
        self._key, sub = jax.random.split(self._key)
        return sub

    def normal(self, size=()):
        return self.np_rng.standard_normal(size=size).astype(floatX())

    def uniform(self, size=()):
        return self.np_rng.uniform(size=size).astype(floatX())


_tt_rng = None


def tt_rng(random_seed=None):
    """Get (or reseed) the global RNG stream (cf. ``theanof.py:401``)."""
    global _tt_rng
    if random_seed is not None:
        _tt_rng = _RandomStream(random_seed)
    elif _tt_rng is None:
        _tt_rng = _RandomStream(42)
    return _tt_rng


def set_tt_rng(new_rng):
    """Set the global RNG stream (cf. ``theanof.py:424``)."""
    global _tt_rng
    if isinstance(new_rng, int):
        new_rng = _RandomStream(new_rng)
    _tt_rng = new_rng


def take_along_axis(arr, indices, axis=0):
    """``np.take_along_axis`` over nodes/arrays (cf. ``theanof.py:519``)."""
    if isinstance(arr, Node) or isinstance(indices, Node):
        return apply(lambda a, i: jnp.take_along_axis(
            jnp.asarray(a), jnp.asarray(i), axis=axis), arr, indices)
    return jnp.take_along_axis(jnp.asarray(arr), jnp.asarray(indices),
                               axis=axis)
