"""Model core: the DSL runtime, mirroring ``pymc3/model.py``.

``Model`` is a context-managed registry (``ContextMeta``, ``model.py:243``)
holding ``free_RVs / observed_RVs / deterministics / potentials / named_vars``
(``model.py:716``). Where the reference builds a Theano graph and compiles a
fused ``[q] -> [logp, grad]`` C function (``ValueGradFunction``,
``model.py:541-713``), this build *traces* the factor list into one pure JAX
function of the flat unconstrained vector and jits ``jax.value_and_grad`` —
same seam, XLA instead of generated C. Everything downstream (NUTS, VI, SMC)
consumes only that flat ``q -> (logp, dlogp)`` function, which is why chains
can become a ``vmap`` axis and shard over a device mesh.
"""
from __future__ import annotations

import collections
import functools
import threading
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from .config import floatX, get_config
from .node import (
    Node, NamedNode, OpNode, ConstantNode, as_node, evaluate, _ev,
    apply as node_apply,
)
from .blocking import ArrayOrdering, DictToArrayBijection
from .exceptions import ImputationWarning, SamplingError
from .memoize import WithMemoization
from .util import get_transformed_name, get_var_name
from .vartypes import continuous_types, discrete_types
from .distributions.shape_utils import to_tuple

__all__ = [
    "Model", "Factor", "modelcontext", "Point", "Deterministic", "Potential",
    "set_data", "FreeRV", "ObservedRV", "MultiObservedRV", "TransformedRV",
    "DeterministicRV", "ValueGradFunction", "fn", "fastfn",
]

FlatView = collections.namedtuple("FlatView", "input, replacements, view")


# ---------------------------------------------------------------------------
# Context stack (cf. ContextMeta, model.py:243-368)
# ---------------------------------------------------------------------------
class ContextMeta(type):
    """Thread-local context stack so `with model:` registers variables."""

    def __call__(cls, *args, **kwargs):
        instance = cls.__new__(cls, *args, **kwargs)
        with instance:
            instance.__init__(*args, **kwargs)
        return instance

    def __init__(cls, name, bases, nmspc, **kwargs):
        super().__init__(name, bases, nmspc)

    @property
    def context_class(cls):
        # anchor the stack at the most basal ContextMeta class so Model
        # subclasses (reference NewModel pattern, test_model.py:28) share
        # one stack instead of lazily creating split-brain per-class stores
        root = cls
        for base in cls.__mro__:
            if isinstance(base, ContextMeta):
                root = base
        return root

    def get_contexts(cls) -> List:
        root = cls.context_class
        if "_contexts" not in root.__dict__:
            root._contexts = threading.local()
        if not hasattr(root._contexts, "stack"):
            root._contexts.stack = []
        return root._contexts.stack

    def get_context(cls, error_if_none=True):
        stack = cls.get_contexts()
        if not stack:
            if error_if_none:
                raise TypeError(f"No {cls.__name__} on context stack")
            return None
        return stack[-1]


def modelcontext(model: Optional["Model"]) -> "Model":
    """Return the given model or the ambient context model
    (cf. ``model.py:356``)."""
    if model is None:
        model = Model.get_context(error_if_none=False)
        if model is None:
            raise TypeError("No model on context stack.")
    return model


# ---------------------------------------------------------------------------
# RV wrappers (cf. model.py:1420-1760)
# ---------------------------------------------------------------------------
def _get_scaling(total_size, shape, ndim):
    """Minibatch logp scaling coefficient (cf. ``model.py:1363``)."""
    if total_size is None:
        return 1.0
    if isinstance(total_size, int):
        if ndim >= 1:
            denom = shape[0] if shape else 1
        else:
            denom = 1
        return float(total_size) / max(int(denom), 1)
    if isinstance(total_size, (list, tuple)):
        if not all(isinstance(i, int) or i is Ellipsis or i is None
                   for i in total_size):
            raise TypeError(f"Unrecognized `total_size` type: {total_size}")
        if Ellipsis in total_size:
            sep = total_size.index(Ellipsis)
            begin = total_size[:sep]
            end = total_size[sep + 1:]
            if len(begin) + len(end) > ndim:
                raise ValueError("Length of total_size > ndim")
        else:
            begin = list(total_size)
            end = []
        coef = 1.0
        for i, t in enumerate(begin):
            if t is not None:
                coef *= float(t) / max(int(shape[i]), 1)
        for i, t in enumerate(reversed(end)):
            if t is not None:
                coef *= float(t) / max(int(shape[ndim - 1 - i]), 1)
        return coef
    raise TypeError(f"Unrecognized `total_size` type: {total_size}")


class Factor:
    """Mixin for terms contributing to the model log-density
    (cf. ``model.py:371``)."""

    def logp(self, point):
        """Host-side summed logp of this factor at a Point."""
        env = self.model._point_to_env(point)
        return float(np.asarray(self.logp_elemwise_env(env, {})))


class FreeRV(NamedNode, Factor):
    """Unobserved random variable in *unconstrained* space
    (cf. ``model.py:1420``). For transformed distributions this is the
    ``name_{transform}__`` variable the samplers see."""

    def __init__(self, name, distribution, model, transform=None,
                 total_size=None, orig_name=None):
        self.name = name
        self.distribution = distribution
        self.model = model
        self.transform = transform
        self.orig_name = orig_name or name
        if transform is not None:
            self.unconstrained_shape = tuple(
                transform.forward_shape(distribution.shape))
        else:
            self.unconstrained_shape = tuple(distribution.shape)
        self.dshape = tuple(distribution.shape)
        self.dsize = int(np.prod(distribution.shape, dtype=int))
        self.scaling = _get_scaling(total_size, distribution.shape,
                                    len(distribution.shape))
        # test value lives in unconstrained space
        testval = distribution.default()
        if transform is not None:
            testval = np.asarray(transform.forward_val(floatX(testval)))
        self._test_value = floatX(np.broadcast_to(
            testval, self.unconstrained_shape)) \
            if np.shape(testval) != self.unconstrained_shape else floatX(testval)
        self.missing_values = None

    @property
    def dtype(self):
        return np.dtype(floatX())

    @property
    def init_value(self):
        return self.test_value

    def _eval_default(self, env, memo):
        return jnp.asarray(self.test_value)

    def logp_elemwise_env(self, env, memo):
        """Elementwise logp term incl. transform jacobian (traceable)."""
        z = _ev(self, env, memo)
        if self.transform is not None:
            x = self.transform.backward(z, env, memo)
            jac = self.transform.jacobian_det(z, env, memo)
            lp = self.distribution.logp(x, env, memo)
            return self.scaling * (jnp.sum(lp) + jnp.sum(jac))
        return self.scaling * jnp.sum(self.distribution.logp(z, env, memo))

    def logp_elemwise_env_nojac(self, env, memo):
        z = _ev(self, env, memo)
        if self.transform is not None:
            x = self.transform.backward(z, env, memo)
            return self.scaling * jnp.sum(self.distribution.logp(x, env, memo))
        return self.scaling * jnp.sum(self.distribution.logp(z, env, memo))

    def random(self, point=None, size=None):
        return self.distribution.random(point=point, size=size)


class TransformedRV(NamedNode):
    """User-facing view of a transformed FreeRV: ``x = backward(x_log__)``
    (cf. ``model.py:1707``)."""

    def __init__(self, name, distribution, transform, transformed_rv, model):
        self.name = name
        self.distribution = distribution
        self.transform = transform
        self.transformed = transformed_rv
        self.transformed_name = transformed_rv.name
        self.model = model
        self._test_value = floatX(
            np.asarray(transform.backward_val(transformed_rv.test_value)))
        self.dshape = tuple(distribution.shape)
        self.dsize = int(np.prod(distribution.shape, dtype=int))

    @property
    def dtype(self):
        return np.dtype(floatX())

    def _eval_default(self, env, memo):
        z = _ev(self.transformed, env, memo)
        return self.transform.backward(z, env, memo)

    def random(self, point=None, size=None):
        return self.distribution.random(point=point, size=size)


class ObservedRV(NamedNode, Factor):
    """Observed variable (cf. ``model.py:1534``). Partially-observed (masked
    or NaN) data triggers automatic imputation: masked entries become a
    ``name_missing`` FreeRV spliced into the value at trace time
    (cf. ``model.py:1503-1531``)."""

    def __init__(self, name, data, distribution, model, total_size=None):
        self.name = name
        self.distribution = distribution
        self.model = model
        self.missing_values = None
        self._missing_idx = None
        self.data_node = None

        if isinstance(data, Node) and not isinstance(data, ConstantNode):
            # symbolic observed data (pm.Data / pm.Minibatch): evaluated at
            # trace time so VI minibatching stays on-device
            self.data_node = data
            data = np.asarray(data.test_value)

        data = _as_observed_array(data, distribution.dtype)
        mask = None
        if isinstance(data, np.ma.MaskedArray):
            mask = np.ma.getmaskarray(data)
            data = np.asarray(data.filled(0))
        elif np.issubdtype(np.asarray(data).dtype, np.floating) and \
                np.isnan(np.asarray(data)).any():
            mask = np.isnan(np.asarray(data))
            data = np.nan_to_num(np.asarray(data), nan=0.0)

        self.data = np.asarray(data)
        if self.data.dtype.kind == "f":
            self.data = floatX(self.data)
        self._test_value = self.data
        # the observed variable's shape is the data's shape — forward draws
        # must produce it even when params are scalar (cf. model.py:975
        # passing data shape into the distribution)
        if not distribution.shape and self.data.ndim > 0:
            distribution.shape = tuple(self.data.shape)

        if mask is not None and mask.any():
            from .distributions.distribution import NoDistribution
            warnings.warn(
                f"Data in {name} contains missing values and will be "
                "automatically imputed from the sampling distribution.",
                ImputationWarning)
            self._missing_idx = np.nonzero(mask.ravel())[0]
            n_missing = int(self._missing_idx.size)
            miss_testval = np.broadcast_to(
                distribution.default(), mask.shape).ravel()[self._missing_idx]
            fake = NoDistribution.dist(
                shape=(n_missing,), dtype=distribution.dtype,
                testval=miss_testval, parent_dist=distribution)
            missing_rv = FreeRV(name + "_missing", fake, model)
            model.free_RVs.append(missing_rv)
            model.add_named_variable(missing_rv)
            model.missing_values.append(missing_rv)
            self.missing_values = missing_rv

        self.scaling = _get_scaling(total_size, self.data.shape,
                                    self.data.ndim)

    @property
    def dtype(self):
        return self.data.dtype

    def value_node_eval(self, env, memo):
        """Observed value with imputed entries spliced in (traceable)."""
        if self.data_node is not None:
            return _ev(self.data_node, env, memo)
        base = jnp.asarray(self.data)
        if self.missing_values is not None:
            miss = _ev(self.missing_values, env, memo)
            flat = base.ravel().at[self._missing_idx].set(
                miss.astype(base.dtype))
            return flat.reshape(base.shape)
        return base

    def _eval_default(self, env, memo):
        return self.value_node_eval(env, memo)

    def logp_elemwise_env(self, env, memo):
        value = self.value_node_eval(env, memo)
        return self.scaling * jnp.sum(self.distribution.logp(value, env, memo))

    logp_elemwise_env_nojac = logp_elemwise_env


class MultiObservedRV(Factor):
    """Observed with a dict of data (DensityDist), cf. ``model.py:1601``."""

    def __init__(self, name, data: Dict[str, Any], distribution, model,
                 total_size=None):
        self.name = name
        self.data = {k: np.asarray(v) for k, v in data.items()}
        self.distribution = distribution
        self.model = model
        self.missing_values = None
        first = next(iter(self.data.values()))
        self.scaling = _get_scaling(total_size, first.shape, first.ndim)

    def logp_elemwise_env(self, env, memo):
        vals = {k: jnp.asarray(v) for k, v in self.data.items()}
        out = self.distribution._logp_fn(**vals)
        if isinstance(out, Node):
            out = evaluate(out, env, memo)
        return self.scaling * jnp.sum(out)

    logp_elemwise_env_nojac = logp_elemwise_env


class DeterministicRV(NamedNode):
    """A named, traced deterministic quantity (cf. ``Deterministic``,
    ``model.py:1667``)."""

    def __init__(self, name, expr, model):
        self.name = name
        self.expr = as_node(expr)
        self.model = model
        self._test_value = np.asarray(self.expr.test_value)

    def _eval_default(self, env, memo):
        return _ev(self.expr, env, memo)


def _as_observed_array(data, dtype):
    if isinstance(data, np.ma.MaskedArray):
        return data
    if hasattr(data, "to_numpy"):  # pandas
        data = data.to_numpy()
    if isinstance(data, Node):
        data = data.test_value
    arr = np.asarray(data)
    return arr


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------
class Model(WithMemoization, metaclass=ContextMeta):
    """Encapsulates the variables and likelihood factors of a model
    (cf. ``model.py:716``). Supports nested sub-models with name prefixing
    (``treelist`` semantics, ``model.py:469``)."""

    def __new__(cls, *args, **kwargs):
        instance = object.__new__(cls)
        parent = cls.get_context(error_if_none=False)
        if kwargs.get("model") is not None:
            instance._parent = kwargs["model"]
        else:
            instance._parent = parent
        return instance

    def __init__(self, name="", model=None, coords=None, check_bounds=True,
                 **kwargs):
        self.name = name
        self.coords = dict(coords) if coords else {}
        self.check_bounds = check_bounds
        self._RV_dims: Dict[str, tuple] = {}
        if self.parent is not None:
            self.named_vars = self.parent.named_vars
            self.free_RVs = self.parent.free_RVs
            self.observed_RVs = self.parent.observed_RVs
            self.deterministics = self.parent.deterministics
            self.potentials = self.parent.potentials
            self.missing_values = self.parent.missing_values
            self._factor_order = self.parent._factor_order
        else:
            self.named_vars: Dict[str, Node] = {}
            self.free_RVs: List[FreeRV] = []
            self.observed_RVs: List = []
            self.deterministics: List[DeterministicRV] = []
            self.potentials: List[Node] = []
            self.missing_values: List[FreeRV] = []
            self._factor_order: List = []  # declaration-ordered factors

    @property
    def parent(self):
        return self._parent

    @property
    def root(self):
        model = self
        while model.parent is not None:
            model = model.parent
        return model

    @property
    def isroot(self):
        return self.parent is None

    # -- context protocol ---------------------------------------------------
    def __enter__(self):
        type(self).get_contexts().append(self)
        return self

    def __exit__(self, typ, value, traceback):
        type(self).get_contexts().pop()

    # -- naming -------------------------------------------------------------
    @property
    def prefix(self):
        return f"{self.name}_" if self.name else ""

    def name_for(self, name):
        if self.prefix and not name.startswith(self.prefix):
            return f"{self.prefix}{name}"
        return name

    def name_of(self, name):
        if self.prefix and name.startswith(self.prefix):
            return name[len(self.prefix):]
        return name

    def __getitem__(self, key):
        try:
            return self.named_vars[key]
        except KeyError:
            return self.named_vars[self.name_for(key)]

    def __contains__(self, key):
        return key in self.named_vars or self.name_for(key) in self.named_vars

    # -- registration -------------------------------------------------------
    def Var(self, name, dist, data=None, total_size=None, dims=None):
        """Create and register a variable (cf. ``model.py:975``)."""
        name = self.name_for(name)
        if dims is not None:
            self._RV_dims[name] = tuple(np.atleast_1d(dims))
        if data is None:
            # free variable
            transform = getattr(dist, "transform", None)
            if transform is None:
                var = FreeRV(name, dist, self, total_size=total_size)
                # validate the name BEFORE touching model state so a failed
                # registration leaves the model unchanged
                self.add_named_variable(var)
                self.free_RVs.append(var)
                self._factor_order.append(("free", var))
                return var
            zname = get_transformed_name(name, transform)
            if name in self.named_vars or zname in self.named_vars:
                raise ValueError(f"Variable name {name} already exists.")
            zvar = FreeRV(zname, dist, self, transform=transform,
                          total_size=total_size, orig_name=name)
            self.add_named_variable(zvar)
            self.free_RVs.append(zvar)
            self._factor_order.append(("free", zvar))
            var = TransformedRV(name, dist, transform, zvar, self)
            self.add_named_variable(var)
            zvar.view_rv = var
            return var
        elif isinstance(data, dict):
            var = MultiObservedRV(name, data, dist, self,
                                  total_size=total_size)
            self.observed_RVs.append(var)
            self._factor_order.append(("obs", var))
            return var
        else:
            # validate the name first: ObservedRV may register a
            # `name_missing` FreeRV as a side effect (imputation)
            if name in self.named_vars:
                raise ValueError(f"Variable name {name} already exists.")
            var = ObservedRV(name, data, dist, self, total_size=total_size)
            self.add_named_variable(var)
            self.observed_RVs.append(var)
            self._factor_order.append(("obs", var))
            return var

    def add_named_variable(self, var):
        if var.name in self.named_vars:
            raise ValueError(f"Variable name {var.name} already exists.")
        self.named_vars[var.name] = var

    add_random_variable = add_named_variable

    def add_coords(self, coords):
        if coords:
            self.coords.update(coords)

    # -- variable views -----------------------------------------------------
    @property
    def vars(self):
        """Sampling-space (unconstrained) free variables."""
        return list(self.free_RVs)

    @property
    def basic_RVs(self):
        return self.free_RVs + self.observed_RVs

    @property
    def unobserved_RVs(self):
        """User-facing unobserved variables: untransformed views, raw free
        RVs, and deterministics (cf. ``model.py``)."""
        out = []
        for rv in self.free_RVs:
            view = getattr(rv, "view_rv", None)
            if view is not None:
                out.append(view)
        out.extend(self.free_RVs)
        out.extend(self.deterministics)
        return out

    @property
    def cont_vars(self):
        return [v for v in self.free_RVs
                if str(v.distribution.dtype) in continuous_types]

    @property
    def disc_vars(self):
        return [v for v in self.free_RVs
                if str(v.distribution.dtype) in discrete_types]

    @property
    def test_point(self) -> Dict[str, np.ndarray]:
        """Test point in unconstrained space (cf. ``model.py:946``)."""
        return Point({v.name: v.test_value for v in self.free_RVs}, model=self)

    @property
    def ndim(self):
        return sum(int(np.prod(v.unconstrained_shape, dtype=int))
                   for v in self.free_RVs)

    @property
    def ordering(self) -> ArrayOrdering:
        return ArrayOrdering(self.free_RVs)

    @property
    def bijection(self) -> DictToArrayBijection:
        return DictToArrayBijection(self.ordering, self.test_point)

    def dict_to_array(self, point) -> np.ndarray:
        return floatX(self.bijection.map(point))

    def array_to_dict(self, q) -> Dict[str, np.ndarray]:
        return self.bijection.rmap(q)

    # -- logp construction (the JAX/XLA seam) -------------------------------
    def _env_from_q(self, q):
        """Decode flat unconstrained q into an env with both transformed and
        constrained values (traceable)."""
        env = {}
        for vm in self.ordering.vmap:
            env[vm.var] = q[vm.slc].reshape(vm.shp)
        for rv in self.free_RVs:
            if rv.transform is not None:
                env[rv.orig_name] = rv.transform.backward(env[rv.name], env, None)
        return env

    def logp_from_env(self, env, memo=None, jacobian=True):
        """Total logp given an env of free-RV values (traceable)."""
        memo = {} if memo is None else memo
        total = jnp.asarray(0.0, dtype=floatX())
        for kind, factor in self._factor_order:
            if kind == "free":
                if jacobian:
                    total = total + factor.logp_elemwise_env(env, memo)
                else:
                    total = total + factor.logp_elemwise_env_nojac(env, memo)
            else:
                total = total + factor.logp_elemwise_env(env, memo)
        for pot in self.potentials:
            total = total + jnp.sum(_ev(pot, env, memo))
        return total

    def make_logp_fn(self, jacobian=True, with_rng=False):
        """Pure q -> scalar logp function (traceable, vmappable).

        With ``with_rng`` the function takes ``(q, key)`` and exposes the key
        to Minibatch nodes via the environment (``data.RNG_ENV_KEY``) so
        stochastic-VI minibatching is pure device-side indexing."""
        if with_rng:
            from .data import RNG_ENV_KEY

            def logp_rng(q, key):
                q = jnp.asarray(q, dtype=floatX())
                env = self._env_from_q(q)
                env[RNG_ENV_KEY] = key
                return self.logp_from_env(env, jacobian=jacobian)
            return logp_rng

        def logp(q):
            q = jnp.asarray(q, dtype=floatX())
            env = self._env_from_q(q)
            return self.logp_from_env(env, jacobian=jacobian)
        return logp

    def make_logp_dlogp_fn(self, jacobian=True):
        lp = self.make_logp_fn(jacobian=jacobian)
        return jax.value_and_grad(lp)

    def logp_dlogp_function(self, grad_vars=None, **kwargs):
        """cf. ``model.py:885`` — returns a :class:`ValueGradFunction`."""
        return ValueGradFunction(self, grad_vars=grad_vars, **kwargs)

    def varlogpt_fn(self):
        """logp of free RVs only (SMC prior term, cf. ``model.py:929``)."""
        def logp(q):
            env = self._env_from_q(jnp.asarray(q, dtype=floatX()))
            memo = {}
            total = jnp.asarray(0.0, dtype=floatX())
            for rv in self.free_RVs:
                total = total + rv.logp_elemwise_env(env, memo)
            return total
        return logp

    def datalogpt_fn(self):
        """logp of observed terms + potentials (SMC likelihood term,
        cf. ``model.py:938``)."""
        def logp(q):
            env = self._env_from_q(jnp.asarray(q, dtype=floatX()))
            memo = {}
            total = jnp.asarray(0.0, dtype=floatX())
            for obs in self.observed_RVs:
                total = total + obs.logp_elemwise_env(env, memo)
            for pot in self.potentials:
                total = total + jnp.sum(_ev(pot, env, memo))
            return total
        return logp

    # -- symbolic logp nodes (cf. model.py:897-938) --------------------------
    def _logp_node(self, fn_from_env, name):
        """Wrap an env -> scalar logp contraction as a graph Node whose
        inputs are the free-RV NamedNodes, so ``pm.gradient(model.logpt)``
        etc. trace through it like any other expression."""
        rvs = list(self.free_RVs)

        def run(*vals):
            env = {rv.name: v for rv, v in zip(rvs, vals)}
            for rv in rvs:
                if rv.transform is not None:
                    env[rv.orig_name] = rv.transform.backward(
                        env[rv.name], env, None)
            return fn_from_env(env)

        out = node_apply(run, *rvs)
        out.name = name
        return out

    @property
    def logpt(self):
        """Joint log-density node incl. transform jacobians (model.py:897)."""
        return self._logp_node(
            lambda env: self.logp_from_env(env, jacobian=True), "__logp")

    @property
    def logp_nojact(self):
        """Joint logp node without jacobian terms (model.py:909)."""
        return self._logp_node(
            lambda env: self.logp_from_env(env, jacobian=False),
            "__logp_nojac")

    @property
    def varlogpt(self):
        """Free-RV (prior) logp node (model.py:929)."""
        def contract(env):
            memo = {}
            total = jnp.asarray(0.0, dtype=floatX())
            for rv in self.free_RVs:
                total = total + rv.logp_elemwise_env(env, memo)
            return total
        return self._logp_node(contract, "__varlogp")

    @property
    def datalogpt(self):
        """Observed + potential logp node (model.py:938)."""
        def contract(env):
            memo = {}
            total = jnp.asarray(0.0, dtype=floatX())
            for obs in self.observed_RVs:
                total = total + obs.logp_elemwise_env(env, memo)
            for pot in self.potentials:
                total = total + jnp.sum(_ev(pot, env, memo))
            return total
        return self._logp_node(contract, "__datalogp")

    # -- host-side conveniences ---------------------------------------------
    def _point_to_env(self, point):
        env = {k: jnp.asarray(v) for k, v in point.items()}
        # fill constrained views for any transformed value present
        for rv in self.free_RVs:
            if rv.transform is not None and rv.name in env \
                    and rv.orig_name not in env:
                env[rv.orig_name] = rv.transform.backward(
                    jnp.asarray(env[rv.name]), env, None)
            elif rv.transform is not None and rv.orig_name in env \
                    and rv.name not in env:
                env[rv.name] = rv.transform.forward(
                    jnp.asarray(env[rv.orig_name]), env, None)
        return env

    def logp(self, point=None):
        """Host-side total logp at a Point (transformed-space names)."""
        point = point if point is not None else self.test_point
        env = self._point_to_env(point)
        return float(np.asarray(self.logp_from_env(env, jacobian=True)))

    fastlogp = logp

    def logp_nojac(self, point=None):
        point = point if point is not None else self.test_point
        env = self._point_to_env(point)
        return float(np.asarray(self.logp_from_env(env, jacobian=False)))

    def dlogp(self, point=None):
        point = point if point is not None else self.test_point
        q = self.dict_to_array(point)
        _, g = jax.value_and_grad(self.make_logp_fn())(jnp.asarray(q))
        return np.asarray(g)

    def logp_elemwise(self, point=None):
        point = point if point is not None else self.test_point
        env = self._point_to_env(point)
        memo = {}
        out = {}
        for kind, factor in self._factor_order:
            out[factor.name] = np.asarray(factor.logp_elemwise_env(env, memo))
        return out

    def check_test_point(self, test_point=None, round_vals=2):
        """Per-RV logp at the test point (cf. ``model.py:1199``)."""
        import pandas as pd
        if test_point is None:
            test_point = self.test_point
        env = self._point_to_env(test_point)
        memo = {}
        vals = {}
        for kind, factor in self._factor_order:
            vals[factor.name] = float(np.asarray(
                factor.logp_elemwise_env(env, memo)))
        return pd.Series(vals, name="Log-probability of test_point").round(round_vals)

    def makefn(self, outs, point_fn=True):
        """Compile a Point -> values function (cf. ``model.py:1081``)."""
        single = not isinstance(outs, (list, tuple))
        outs_list = [outs] if single else list(outs)

        def f(point):
            env = self._point_to_env(point)
            memo = {}
            vals = [np.asarray(_ev(as_node(o), env, memo)) for o in outs_list]
            return vals[0] if single else vals
        return f

    def fn(self, outs, *args, **kwargs):
        return self.makefn(outs)

    def fastfn(self, outs, *args, **kwargs):
        return self.makefn(outs)

    def profile(self, outs, n=1000, point=None, profile=True, *args, **kwargs):
        """Time the jitted evaluation of ``outs`` (cf. ``model.py:1132``).

        Returns a dict with compile and per-call walltime; use
        ``jax.profiler`` for deep traces.
        """
        import time
        if point is None:
            point = self.test_point
        f = self.makefn(outs)
        t0 = time.perf_counter()
        f(point)
        compile_time = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n):
            f(point)
        total = time.perf_counter() - t0
        return {"n_calls": n, "compile_time_s": compile_time,
                "total_time_s": total, "per_call_us": total / n * 1e6}

    def flatten(self, vars=None, order=None, inputvar=None):
        """FlatView over free RVs (cf. ``model.py:1161``)."""
        if vars is None:
            vars = self.free_RVs
        if order is None:
            order = ArrayOrdering(vars)
        flat_input = np.concatenate(
            [np.ravel(v.test_value) for v in vars]) if vars else np.array([])
        replacements = {v.name: order.by_name[v.name] for v in vars}
        return FlatView(flat_input, replacements, order)

    # -- forward (predictive) sampling ---------------------------------------
    def draw_point(self, point=None):
        """One forward draw of all RVs in declaration order, conditioned on
        any values already in ``point`` (the vectorized replacement of the
        reference's ``draw_values`` DAG interpreter,
        ``distributions/distribution.py:521`` — topological order is known at
        model build, SURVEY §7.7)."""
        point = dict(point or {})
        for kind, factor in self._factor_order:
            rv = factor
            orig = getattr(rv, "orig_name", rv.name)
            if orig in point or rv.name in point:
                continue
            if kind == "free":
                val = np.asarray(rv.distribution.random(point=point))
                point[orig] = val
                if rv.transform is not None:
                    point[rv.name] = np.asarray(
                        rv.transform.forward_val(val))
            else:
                if isinstance(rv, MultiObservedRV):
                    continue
                point[rv.name] = np.asarray(
                    rv.distribution.random(point=point))
        for det in self.deterministics:
            if det.name not in point:
                env = {k: jnp.asarray(v) for k, v in point.items()}
                point[det.name] = np.asarray(det._eval_default(env, {}))
        return point

    def _batched_random(self, dist, point, samples, batched_names):
        """Vectorized forward draw with per-sample fallback."""
        expect = (samples,) + tuple(dist.shape)
        try:
            out = np.asarray(dist.random(point=point, size=samples))
            if out.shape == expect:
                return out
            return np.broadcast_to(out, expect).copy()
        except Exception:
            draws = []
            for i in range(samples):
                pt_i = {k: (v[i] if k in batched_names else v)
                        for k, v in point.items()}
                draws.append(np.asarray(dist.random(point=pt_i)))
            return np.stack(draws)

    def sample_forward(self, samples: int, point=None) -> Dict[str, np.ndarray]:
        """Vectorized prior(-predictive) draws: {name: (samples, *shape)}."""
        point = {k: np.asarray(v) for k, v in (point or {}).items()}
        batched = set(point.keys()) if point and any(
            np.ndim(v) and np.shape(v)[0] == samples
            for v in point.values()) else set()
        for kind, factor in self._factor_order:
            rv = factor
            orig = getattr(rv, "orig_name", rv.name)
            if orig in point or rv.name in point:
                continue
            if isinstance(rv, MultiObservedRV):
                continue
            if kind != "free":
                self._refresh_observed_shape(rv)
            val = self._batched_random(rv.distribution, point, samples,
                                       batched)
            point[orig] = val
            batched.add(orig)
            if kind == "free" and rv.transform is not None:
                point[rv.name] = np.asarray(rv.transform.forward_val(val))
                batched.add(rv.name)
        # deterministics: vmap the node evaluation over the batch axis
        if self.deterministics:
            det_vals = self._vmap_eval(self.deterministics, point, batched,
                                       samples)
            point.update(det_vals)
        return point

    def _vmap_eval(self, nodes, point, batched_names, samples):
        """Evaluate named nodes under vmap over the batched point entries."""
        batched_env = {k: jnp.asarray(v) for k, v in point.items()
                       if k in batched_names}
        static_env = {k: jnp.asarray(v) for k, v in point.items()
                      if k not in batched_names}

        def eval_one(benv):
            env = dict(static_env)
            env.update(benv)
            memo = {}
            return [jnp.asarray(_ev(n, env, memo)) for n in nodes]

        if batched_env:
            vals = jax.vmap(eval_one)(batched_env)
        else:
            one = eval_one({})
            vals = [jnp.broadcast_to(v, (samples,) + v.shape) for v in one]
        return {n.name: np.asarray(v) for n, v in zip(nodes, vals)}

    def sample_forward_conditional(self, points, idx, vars, size=None
                                   ) -> Dict[str, np.ndarray]:
        """Posterior predictive: draw ``vars`` forward for each selected
        trace point (vectorized — the only path, cf.
        ``posterior_predictive.py:124``)."""
        idx = np.asarray(idx)
        nsel = idx.shape[0]
        batched_point = {}
        for k in points[0]:
            batched_point[k] = np.stack(
                [np.asarray(points[i][k]) for i in idx])
        batched = set(batched_point.keys())
        # fill constrained views of transformed values
        for rv in self.free_RVs:
            if rv.transform is not None and rv.name in batched_point \
                    and rv.orig_name not in batched_point:
                batched_point[rv.orig_name] = np.asarray(
                    rv.transform.backward_val(batched_point[rv.name]))
                batched.add(rv.orig_name)
        out = {}
        det_vars = []
        for var in vars:
            var = self.named_vars.get(getattr(var, "name", var), var)
            if isinstance(var, (ObservedRV,)):
                self._refresh_observed_shape(var)
                draw = self._batched_random(var.distribution, batched_point,
                                            nsel, batched)
                if size is not None:
                    extra = [self._batched_random(
                        var.distribution, batched_point, nsel, batched)
                        for _ in range(int(size) - 1)]
                    draw = np.stack([draw] + extra, axis=1) if extra else \
                        draw[:, None]
                out[var.name] = draw
            elif isinstance(var, DeterministicRV):
                det_vars.append(var)
            elif isinstance(var, (FreeRV, TransformedRV)):
                nm = var.name
                if nm in batched_point:
                    out[nm] = batched_point[nm]
                else:
                    out[nm] = self._batched_random(
                        var.distribution, batched_point, nsel, batched)
        if det_vars:
            out.update(self._vmap_eval(det_vars, batched_point, batched,
                                       nsel))
        return out

    def _refresh_observed_shape(self, rv):
        """Observed RVs whose data lives in a pm.Data container must track
        the container's *current* shape for forward draws: after
        set_data() to a different number of rows, the build-time shape is
        stale (reference semantics via shared variables,
        ``tests/test_data_container.py:68``)."""
        node = getattr(rv, "data_node", None)
        if node is None:
            return
        cur = tuple(np.shape(np.asarray(node.test_value)))
        if tuple(rv.distribution.shape or ()) != cur:
            rv.distribution.shape = cur

    def set_data(self, name, values):
        """Mutate a pm.Data container (cf. ``model.py:1236``)."""
        from .data import SharedDataNode
        node = self[name]
        if not isinstance(node, SharedDataNode):
            raise TypeError(
                f"The variable `{name}` must be defined as `pymc3.Data` inside "
                "the model to allow updating.")
        node.set_value(values)

    def __str__(self):
        return f"Model({self.name or 'unnamed'}: {len(self.free_RVs)} free, " \
               f"{len(self.observed_RVs)} observed)"

    __repr__ = __str__


def all_continuous(vars) -> bool:
    """Check that vars not include discrete variables
    (cf. ``pymc3/model.py``/``sampling.py`` usage)."""
    vars_ = [var for var in vars if hasattr(var, "distribution")]
    return all(str(np.dtype(v.distribution.dtype)) in continuous_types
               for v in vars_)


def Point(*args, model=None, **kwargs) -> Dict[str, np.ndarray]:
    """Build a point dict limited to model variable names
    (cf. ``model.py:1331``)."""
    model = modelcontext(model)
    args = list(args)
    try:
        d = dict(*args, **kwargs)
    except Exception as e:
        raise TypeError(f"can't turn {args} and {kwargs} into a dict. {e}")
    return {get_var_name(k): np.asarray(v) for k, v in d.items()}


def Deterministic(name, var, model=None, dims=None):
    """Register a named deterministic (cf. ``model.py:1667``)."""
    model = modelcontext(model)
    name = model.name_for(name)
    det = DeterministicRV(name, var, model)
    model.deterministics.append(det)
    model.add_named_variable(det)
    if dims is not None:
        model._RV_dims[name] = tuple(np.atleast_1d(dims))
    return det


def Potential(name, var, model=None):
    """Add an arbitrary factor to the joint logp (cf. ``model.py:1688``)."""
    model = modelcontext(model)
    node = as_node(var, name=model.name_for(name))
    model.potentials.append(node)
    model.named_vars.setdefault(model.name_for(name), node)
    return node


def set_data(new_data: Dict[str, Any], model=None):
    """Update pm.Data containers (cf. ``model.py:1236`` / ``pm.set_data``)."""
    model = modelcontext(model)
    for name, values in new_data.items():
        model.set_data(name, values)


def fn(outs, model=None, *args, **kwargs):
    return modelcontext(model).fn(outs)


def fastfn(outs, model=None, *args, **kwargs):
    return modelcontext(model).fastfn(outs)


compilef = fastfn  # cf. model.py:1360


# ---------------------------------------------------------------------------
# ValueGradFunction (cf. model.py:541-713)
# ---------------------------------------------------------------------------
class ValueGradFunction:
    """Fused ``q -> (logp, dlogp)`` over the flat unconstrained vector.

    The reference clones the Theano graph against vector slices and compiles
    one C function (``model.py:622-713``). Here the same contraction is a
    traced ``jax.value_and_grad`` under ``jit`` — one XLA executable, fused
    end-to-end. ``.jax_fn`` exposes the traceable function for vmapping over
    chains.
    """

    def __init__(self, model, grad_vars=None, extra_vars=None, dtype=None,
                 **kwargs):
        self.model = model
        self._grad_vars = grad_vars or model.free_RVs
        self.ordering = ArrayOrdering(self._grad_vars)
        self.size = self.ordering.size
        self.dtype = np.dtype(dtype or floatX())
        self._extra_values: Dict[str, np.ndarray] = {}
        self._extra_vars = [v for v in (extra_vars or [])]

        grad_names = {v.name for v in self._grad_vars}
        all_names = {v.name for v in model.free_RVs}
        self._fixed_names = sorted(all_names - grad_names)
        for name in self._fixed_names:
            rv = model.named_vars[name]
            self._extra_values[name] = np.asarray(rv.test_value)

        self._logp_fn_cache = None
        self._jit_vag = None
        self._n_eval = 0

    def set_extra_values(self, extra_values: Dict[str, np.ndarray]):
        self._extra_values.update(
            {k: np.asarray(v) for k, v in extra_values.items()})
        self._jit_vag = None  # fixed values are baked into the trace

    def get_extra_values(self):
        return dict(self._extra_values)

    @property
    def jax_fn(self):
        """Pure logp(q) over the grad vars, with fixed vars closed over."""
        model = self.model
        ordering = self.ordering
        fixed = {k: jnp.asarray(v) for k, v in self._extra_values.items()}

        def logp(q):
            q = jnp.asarray(q, dtype=floatX())
            env = {}
            for vm in ordering.vmap:
                env[vm.var] = q[vm.slc].reshape(vm.shp)
            env.update(fixed)
            for rv in model.free_RVs:
                if rv.transform is not None and rv.name in env:
                    env[rv.orig_name] = rv.transform.backward(
                        jnp.asarray(env[rv.name]), env, None)
            return model.logp_from_env(env, jacobian=True)
        return logp

    def _get_jit(self):
        if self._jit_vag is None:
            self._jit_vag = jax.jit(jax.value_and_grad(self.jax_fn))
        return self._jit_vag

    def __call__(self, q, grad_out=None, extra_vars=None):
        if extra_vars is not None:
            self.set_extra_values(extra_vars)
        logp, grad = self._get_jit()(jnp.asarray(np.asarray(q),
                                                 dtype=self.dtype))
        self._n_eval += 1
        if grad_out is not None:
            np.copyto(grad_out, np.asarray(grad))
            return float(np.asarray(logp))
        return float(np.asarray(logp)), np.asarray(grad)

    def dict_to_array(self, point) -> np.ndarray:
        vals = [np.ravel(np.asarray(point[vm.var]))
                for vm in self.ordering.vmap]
        return np.concatenate(vals).astype(self.dtype) if vals else \
            np.array([], dtype=self.dtype)

    def array_to_dict(self, q) -> Dict[str, np.ndarray]:
        q = np.asarray(q)
        return {vm.var: q[vm.slc].reshape(vm.shp) for vm in self.ordering.vmap}

    def array_to_full_dict(self, q) -> Dict[str, np.ndarray]:
        """Include fixed (extra) values (cf. ``model.py:695``)."""
        out = self.array_to_dict(q)
        out.update(self._extra_values)
        return out

    @property
    def profile(self):
        return {"n_eval": self._n_eval}
