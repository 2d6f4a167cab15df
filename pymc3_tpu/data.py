"""Data containers, mirroring ``pymc3/data.py``.

``Data`` (`data.py:442`) is a named mutable array registered on the model and
swapped with ``pm.set_data``; ``Minibatch`` (`data.py:111`) yields a random
slice per evaluation for stochastic VI. In this build a Minibatch node
resolves its slice *inside* the jitted VI step from a per-step PRNG key in the
environment (``__rng__``), so minibatching is pure device-side indexing — no
host round-trip per step.
"""
from __future__ import annotations

import hashlib
import io
import os
import pkgutil
import urllib.request
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from .config import floatX, intX
from .node import NamedNode, Node, as_node, _ev
from .model import Model, modelcontext

__all__ = ["get_data", "GeneratorAdapter", "Minibatch", "Data",
           "SharedDataNode", "MinibatchNode", "align_minibatches"]

RNG_ENV_KEY = "__rng__"

_DATA_SEARCH_PATHS = [
    os.path.join(os.path.dirname(__file__), "datasets"),
    os.path.join(os.path.dirname(__file__), "examples", "data"),
]


def get_data(filename):
    """Return a BytesIO for one of the packaged datasets
    (cf. ``pymc3/data.py:35``). Falls back to the reference checkout's data
    directory when present."""
    for base in _DATA_SEARCH_PATHS:
        path = os.path.join(base, filename)
        if os.path.exists(path):
            with open(path, "rb") as f:
                return io.BytesIO(f.read())
    raise FileNotFoundError(
        f"dataset {filename!r} not found in {_DATA_SEARCH_PATHS}")


class GeneratorAdapter:
    """Feed a finite/infinite generator of arrays (cf. ``data.py:68``)."""

    def __init__(self, generator):
        if not hasattr(generator, "__next__"):
            raise TypeError("Object should be generator-like")
        self.gen = generator
        self.tensor = None
        first = next(generator)
        self._first = np.asarray(first)
        self.shape = self._first.shape
        self.dtype = self._first.dtype
        self._returned_first = False

    def __next__(self):
        if not self._returned_first:
            self._returned_first = True
            return self._first
        return np.asarray(next(self.gen))

    def __iter__(self):
        return self

    def make_variable(self, name="generator"):
        node = SharedDataNode(name, self._first, model=None, register=False)
        node._generator = self
        return node


class SharedDataNode(NamedNode):
    """Named mutable data; the JAX stand-in for a Theano shared variable."""

    def __init__(self, name, value, model=None, register=True, dtype=None):
        self.name = name
        self.model = model
        value = np.asarray(value)
        if dtype is None:
            if value.dtype == np.float64 and floatX() == "float32":
                dtype = floatX()
            else:
                dtype = value.dtype
        self._value = value.astype(dtype)
        self.version = 0
        if register and model is not None:
            model.add_named_variable(self)

    @property
    def _test_value(self):
        return self._value

    @_test_value.setter
    def _test_value(self, v):
        pass

    def get_value(self):
        return self._value

    def set_value(self, value):
        value = np.asarray(value)
        if value.dtype != self._value.dtype:
            value = value.astype(self._value.dtype)
        self._value = value
        self.version += 1

    def _eval_default(self, env, memo):
        return jnp.asarray(self._value)


class MinibatchNode(NamedNode):
    """Random-slice view over data for stochastic VI (cf. ``Minibatch``,
    ``data.py:111``). The slice indices come from the per-step PRNG key in
    the environment; without one (e.g. test-value evaluation) the leading
    rows are returned."""

    _counter = [0]

    def __init__(self, data, batch_size, name=None, random_seed=42,
                 in_memory_size=None, sampling="window"):
        data = np.asarray(data)
        if data.dtype == np.float64 and floatX() == "float32":
            data = data.astype(floatX())
        self.data = data
        if in_memory_size is not None:
            self.data = self.data[_slice_from_size(in_memory_size)]
        self.batch_size = int(batch_size) if not isinstance(batch_size, (list, tuple)) \
            else batch_size
        MinibatchNode._counter[0] += 1
        self.name = name or f"Minibatch_{MinibatchNode._counter[0]}"
        self.random_seed = random_seed
        # the fold key derives from random_seed, NOT the node name: in the
        # reference two Minibatch views with the same seed walk the same
        # index stream (how X/y pairs stay aligned, ``pymc3/data.py:156``
        # seeded RandomStream); a name-derived fold silently scrambled
        # X-vs-y row pairing in multi-tensor minibatch models
        self._fold = int(random_seed if random_seed is not None else 42)
        # Batch-selection mode. "random" = the reference's semantics: bs
        # i.i.d. uniform row indices per step (``pymc3/data.py:111``) — an
        # arbitrary bs-row GATHER per step. "window" (default) replaces the
        # gather with one contiguous read: shuffle the rows once at
        # construction, then each step takes a CIRCULAR contiguous
        # window at a uniform random offset — one lax.dynamic_slice. Every
        # row has equal marginal probability bs/N, so the scaled
        # likelihood (and its gradient) stays unbiased; the one-time
        # shuffle kills order correlations within windows.
        if sampling not in ("window", "random"):
            raise ValueError(f"sampling must be 'window' or 'random', "
                             f"got {sampling!r}")
        if not isinstance(self.batch_size, int):
            sampling = "random"  # multi-axis batch specs keep the gather
        elif self.batch_size >= data.shape[0]:
            # a window as large as the data would need a slice past the
            # circular padding (dynamic_slice clamps the offset, biasing
            # toward the leading rows); i.i.d. sampling-with-replacement
            # is both correct and what the reference does here
            sampling = "random"
        self.sampling = sampling
        if sampling == "window":
            rng = np.random.RandomState(
                random_seed if random_seed is not None else 42)
            # keep the permutation: ``indices()`` reports positions in the
            # USER'S original array (AEVB encoders index their own copy of
            # the data with it), while the fast path slices the shuffled
            # copy
            self._perm = rng.permutation(self.data.shape[0])
            self.data = self.data[self._perm]
            # circular padding so the window never needs a wrap gather
            self._padded = np.concatenate(
                [self.data, self.data[:self.batch_size]], axis=0)

    @property
    def _test_value(self):
        bs = self.batch_size if isinstance(self.batch_size, int) else self.batch_size[0]
        return self.data[:bs]

    @_test_value.setter
    def _test_value(self, v):
        pass

    @property
    def total_size(self):
        return self.data.shape[0]

    def indices(self, key):
        """Row indices this minibatch selects under per-step key ``key``
        (``None`` -> the deterministic leading rows used for test values).

        AEVB encoders call this with the per-sample minibatch key so the
        amortized posterior is computed from exactly the rows the model
        logp sees (cf. reference local groups, ``opvi.py:507``)."""
        bs = self.batch_size if isinstance(self.batch_size, int) \
            else self.batch_size[0]
        if key is None:
            # match _test_value: in window mode the leading rows of the
            # SHUFFLED copy sit at original positions _perm[:bs]
            if self.sampling == "window":
                return jnp.asarray(self._perm[:bs])
            return jnp.arange(bs)
        fkey = jax.random.fold_in(key, self._fold)
        if self.sampling == "window":
            r = jax.random.randint(fkey, (), 0, self.data.shape[0])
            pos = (r + jnp.arange(bs)) % self.data.shape[0]
            # positions in the ORIGINAL (pre-shuffle) row order
            return jnp.asarray(self._perm)[pos]
        return jax.random.randint(fkey, (bs,), 0, self.data.shape[0])

    def _eval_default(self, env, memo):
        if self.sampling == "window" and RNG_ENV_KEY in env:
            fkey = jax.random.fold_in(env[RNG_ENV_KEY], self._fold)
            r = jax.random.randint(fkey, (), 0, self.data.shape[0])
            return jax.lax.dynamic_slice_in_dim(
                jnp.asarray(self._padded), r, self.batch_size, axis=0)
        data = jnp.asarray(self.data)
        if RNG_ENV_KEY in env:
            return jnp.take(data, self.indices(env[RNG_ENV_KEY]), axis=0)
        return jnp.take(data, self.indices(None), axis=0)


def Minibatch(data, batch_size=128, dtype=None, broadcastable=None,
              name="Minibatch", random_seed=42, update_shared_f=None,
              in_memory_size=None, sampling="window"):
    """Build a minibatch view node (cf. ``pymc3/data.py:111``).

    ``sampling='window'`` (default) draws each batch as a circular
    contiguous window over a once-shuffled copy — one contiguous
    ``dynamic_slice``, equal marginal row probability, unbiased scaled
    likelihood. ``sampling='random'`` keeps the reference's i.i.d.
    uniform row gather."""
    return MinibatchNode(data, batch_size, name=name, random_seed=random_seed,
                         sampling=sampling,
                         in_memory_size=in_memory_size)


def align_minibatches(batches=None):
    """No-op under per-step key folding (kept for API compat,
    cf. ``data.py:437``)."""
    return None


def _slice_from_size(size):
    if isinstance(size, int):
        return slice(0, size)
    return tuple(slice(0, s) if isinstance(s, int) else slice(None)
                 for s in size)


def Data(name, value, *, dims=None, export_index_as_coords=False, model=None):
    """Register a named mutable data container (cf. ``pymc3/data.py:442``)."""
    model = modelcontext(model)
    if hasattr(value, "to_numpy"):
        value = value.to_numpy()
    node = SharedDataNode(model.name_for(name), np.asarray(value), model=model)
    if dims is not None:
        model._RV_dims[model.name_for(name)] = tuple(np.atleast_1d(dims))
    return node
