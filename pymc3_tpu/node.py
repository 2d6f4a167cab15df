"""Symbolic expression graph for the model DSL.

The reference delegates its symbolic graph to Theano tensor variables
(``pymc3/model.py:975`` builds ``FreeRV``/``ObservedRV`` as *Theano variable
subclasses*). This build replaces that with a minimal, pure-Python
expression DAG whose evaluation function is **traceable by JAX**: every node
knows how to compute itself from an environment ``{rv_name: jnp array}``.
Evaluating the DAG inside ``jax.jit``/``vmap`` traces it straight into XLA —
there is no interpreter at runtime, the graph exists only at trace time.

Eager *test values* (numpy) are computed at construction, mirroring Theano's
``compute_test_value='raise'`` discipline (``pymc3/model.py:818``): shape and
dtype errors surface at model-definition time, exactly like the reference.

Design notes:
 - evaluation is memoized per call so shared subexpressions trace once —
   XLA sees a DAG, not a tree;
 - no data-dependent Python control flow lives in nodes; anything dynamic
   must be expressed with ``lax`` primitives inside the wrapped function;
 - constants are closed over and become XLA constants (folded at compile).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import jax.numpy as jnp

from .config import floatX

__all__ = [
    "Node",
    "ConstantNode",
    "OpNode",
    "NamedNode",
    "apply",
    "as_node",
    "evaluate",
    "evaluate_many",
    "constant_fold",
]


def _to_test(x):
    """Concrete numpy test value for any operand."""
    if isinstance(x, Node):
        return x.test_value
    return np.asarray(x)


class Node:
    """Base class for symbolic expression nodes.

    Sub-classes implement ``_eval(env, memo)`` returning a jnp value. User
    arithmetic on nodes builds :class:`OpNode` trees via operator overloading,
    mirroring Theano tensor-variable semantics without Theano.
    """

    __array_ufunc__ = None  # keep numpy from consuming us in `np_array + node`
    __array_priority__ = 1000

    name: Optional[str] = None
    _test_value: Optional[np.ndarray] = None

    # -- evaluation ----------------------------------------------------------
    def _eval(self, env: Dict[str, Any], memo: Dict[int, Any]):
        raise NotImplementedError

    def eval(self, env: Optional[Dict[str, Any]] = None):
        """Evaluate against an environment of RV values (traceable)."""
        return evaluate(self, env or {})

    # -- static metadata -----------------------------------------------------
    @property
    def test_value(self) -> np.ndarray:
        if self._test_value is None:
            raise ValueError(f"node {self!r} has no test value")
        return self._test_value

    @property
    def tag(self):
        # Theano-compat: `var.tag.test_value`
        return self

    @property
    def shape(self):
        return self.test_value.shape

    @property
    def ndim(self):
        return self.test_value.ndim

    @property
    def size(self):
        return int(self.test_value.size)

    @property
    def dtype(self):
        return self.test_value.dtype

    # -- operators -----------------------------------------------------------
    @staticmethod
    def _operable(other):
        """Can jnp consume ``other``? Non-array operands with their own
        operator protocol (e.g. ``gp.cov.Covariance`` in
        ``eta**2 * ExpQuad(...)``) must get the reflected call."""
        import numbers
        return isinstance(other, (Node, numbers.Number, np.ndarray,
                                  jnp.ndarray, list, tuple))

    def __add__(self, other):
        if not self._operable(other):
            return NotImplemented
        return apply(jnp.add, self, other)

    def __radd__(self, other):
        return apply(jnp.add, other, self)

    def __sub__(self, other):
        return apply(jnp.subtract, self, other)

    def __rsub__(self, other):
        return apply(jnp.subtract, other, self)

    def __mul__(self, other):
        if not self._operable(other):
            return NotImplemented
        return apply(jnp.multiply, self, other)

    def __rmul__(self, other):
        return apply(jnp.multiply, other, self)

    def __truediv__(self, other):
        return apply(jnp.divide, self, other)

    def __rtruediv__(self, other):
        return apply(jnp.divide, other, self)

    def __floordiv__(self, other):
        return apply(jnp.floor_divide, self, other)

    def __rfloordiv__(self, other):
        return apply(jnp.floor_divide, other, self)

    def __mod__(self, other):
        return apply(jnp.mod, self, other)

    def __rmod__(self, other):
        return apply(jnp.mod, other, self)

    def __pow__(self, other):
        return apply(jnp.power, self, other)

    def __rpow__(self, other):
        return apply(jnp.power, other, self)

    def __matmul__(self, other):
        return apply(jnp.matmul, self, other)

    def __rmatmul__(self, other):
        return apply(jnp.matmul, other, self)

    def __neg__(self):
        return apply(jnp.negative, self)

    def __pos__(self):
        return self

    def __abs__(self):
        return apply(jnp.abs, self)

    def __invert__(self):
        return apply(jnp.logical_not, self)

    def __lt__(self, other):
        return apply(jnp.less, self, other)

    def __le__(self, other):
        return apply(jnp.less_equal, self, other)

    def __gt__(self, other):
        return apply(jnp.greater, self, other)

    def __ge__(self, other):
        return apply(jnp.greater_equal, self, other)

    def eq(self, other):
        return apply(jnp.equal, self, other)

    def neq(self, other):
        return apply(jnp.not_equal, self, other)

    def __getitem__(self, idx):
        idx_t = tuple(idx) if isinstance(idx, tuple) else idx
        return apply(lambda x: x[idx_t], self)

    # -- tensor-method conveniences -----------------------------------------
    @property
    def T(self):
        return apply(jnp.transpose, self)

    def transpose(self, *axes):
        axes = axes or None
        return apply(lambda x: jnp.transpose(x, axes), self)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return apply(lambda x: jnp.reshape(x, shape), self)

    def ravel(self):
        return apply(jnp.ravel, self)

    def flatten(self):
        return apply(jnp.ravel, self)

    def sum(self, axis=None, keepdims=False):
        return apply(lambda x: jnp.sum(x, axis=axis, keepdims=keepdims), self)

    def prod(self, axis=None, keepdims=False):
        return apply(lambda x: jnp.prod(x, axis=axis, keepdims=keepdims), self)

    def mean(self, axis=None, keepdims=False):
        return apply(lambda x: jnp.mean(x, axis=axis, keepdims=keepdims), self)

    def std(self, axis=None, keepdims=False):
        return apply(lambda x: jnp.std(x, axis=axis, keepdims=keepdims), self)

    def max(self, axis=None, keepdims=False):
        return apply(lambda x: jnp.max(x, axis=axis, keepdims=keepdims), self)

    def min(self, axis=None, keepdims=False):
        return apply(lambda x: jnp.min(x, axis=axis, keepdims=keepdims), self)

    def cumsum(self, axis=None):
        return apply(lambda x: jnp.cumsum(x, axis=axis), self)

    def dot(self, other):
        return apply(jnp.dot, self, other)

    def astype(self, dtype):
        return apply(lambda x: x.astype(dtype), self)

    def clip(self, a_min, a_max):
        return apply(jnp.clip, self, a_min, a_max)

    def exp(self):
        return apply(jnp.exp, self)

    def log(self):
        return apply(jnp.log, self)

    def squeeze(self, axis=None):
        return apply(lambda x: jnp.squeeze(x, axis=axis), self)

    def __iter__(self):
        if self.ndim == 0:
            raise TypeError("iteration over a 0-d symbolic node")
        return (self[i] for i in range(self.shape[0]))

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of 0-d symbolic node")
        return self.shape[0]

    def __bool__(self):
        raise TypeError(
            "the truth value of a symbolic node is undefined; use pm.math.switch "
            "or lax.cond inside wrapped functions"
        )

    def __hash__(self):
        return id(self)

    def __repr__(self):
        nm = self.name if self.name is not None else type(self).__name__
        try:
            return f"{nm}{list(self.shape)!r}"
        except Exception:
            return nm

    def __str__(self):
        return self.name if self.name is not None else repr(self)


class ConstantNode(Node):
    """A node wrapping a concrete array (closed over into the XLA program)."""

    __slots__ = ("value", "_test_value", "name")

    def __init__(self, value, name: Optional[str] = None):
        self.value = np.asarray(value)
        self._test_value = self.value
        self.name = name

    def _eval(self, env, memo):
        return jnp.asarray(self.value)


class NamedNode(Node):
    """A node addressable by name in the evaluation environment.

    If the environment carries a value for ``self.name`` it wins; otherwise the
    node falls back to ``_eval_default``. This mirrors the reference's
    ``draw_values`` precedence: the Point overrides graph computation
    (``pymc3/distributions/distribution.py:521-640``).
    """

    def _eval_default(self, env, memo):
        raise KeyError(
            f"variable {self.name!r} not in environment and has no default"
        )

    def _eval(self, env, memo):
        if self.name is not None and self.name in env:
            return env[self.name]
        return self._eval_default(env, memo)


class OpNode(Node):
    """fn(*args, **kwargs) over symbolic/constant operands."""

    __slots__ = ("fn", "args", "kwargs", "_test_value", "name")

    def __init__(self, fn: Callable, args: Sequence[Any], kwargs=None,
                 name: Optional[str] = None, test_value=None):
        self.fn = fn
        self.args = tuple(args)
        self.kwargs = dict(kwargs or {})
        self.name = name
        if test_value is None:
            tv_args = [_to_test(a) for a in self.args]
            test_value = fn(*tv_args, **self.kwargs)
        # multi-output ops (e.g. a GP conditional's (mu, cov)) carry a
        # tuple test value; downstream selector nodes index into it
        if isinstance(test_value, (tuple, list)):
            self._test_value = tuple(np.asarray(v) for v in test_value)
        else:
            self._test_value = np.asarray(test_value)

    def _eval(self, env, memo):
        vals = [_ev(a, env, memo) for a in self.args]
        return self.fn(*vals, **self.kwargs)


def as_node(x, name: Optional[str] = None, dtype=None) -> Node:
    """Wrap a value as a node (pass nodes through)."""
    if isinstance(x, Node):
        return x
    arr = np.asarray(x)
    if dtype is not None:
        arr = arr.astype(dtype)
    elif arr.dtype == np.float64 and floatX() == "float32":
        arr = arr.astype(np.float32)
    return ConstantNode(arr, name=name)


def apply(fn: Callable, *args, **kwargs) -> Node:
    """Build an OpNode from a jnp-level callable and operands.

    If no operand is symbolic, evaluates eagerly and returns a ConstantNode so
    pure-constant subgraphs are folded at model-build time.
    """
    if not any(isinstance(a, Node) for a in args):
        out = fn(*[np.asarray(a) for a in args], **kwargs)
        if not isinstance(out, (tuple, list)):
            return ConstantNode(np.asarray(out))
        # tuple-valued op over constants: keep it an OpNode so selector
        # nodes can index the outputs
        return OpNode(fn, args, kwargs, test_value=out)
    return OpNode(fn, args, kwargs)


def _ev(x, env, memo):
    if not isinstance(x, Node):
        return x
    key = id(x)
    if key in memo:
        return memo[key]
    val = x._eval(env, memo)
    memo[key] = val
    return val


def evaluate(node, env: Dict[str, Any], memo: Optional[Dict[int, Any]] = None):
    """Evaluate one node against ``env`` (dict of name -> array). Traceable."""
    if memo is None:
        memo = {}
    return _ev(node, env, memo)


def evaluate_many(nodes: Sequence[Any], env: Dict[str, Any]):
    """Evaluate several nodes sharing one memo (DAG evaluated once)."""
    memo: Dict[int, Any] = {}
    return [_ev(n, env, memo) for n in nodes]


def constant_fold(node: Node):
    """Return the concrete value if the node depends on no named variables."""
    try:
        return np.asarray(evaluate(node, {}))
    except KeyError:
        return None
