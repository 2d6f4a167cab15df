"""Flat-vector ordering & bijections, mirroring ``pymc3/blocking.py``.

``ArrayOrdering`` (`blocking.py:33`) maps each free RV's *unconstrained* space
to a slice of one flat vector ``q``; ``DictToArrayBijection`` (`blocking.py:62`)
converts between Point dicts and flat arrays. The flat vector is the only
representation the samplers see — it is what gets vmapped over chains and
sharded over the device mesh.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Sequence

import numpy as np
import jax.numpy as jnp

__all__ = ["VarMap", "ArrayOrdering", "DictToArrayBijection", "DictToVarBijection",
           "ListArrayOrdering", "ListToArrayBijection", "Compose"]

VarMap = collections.namedtuple("VarMap", "var, slc, shp, dtyp")


class ArrayOrdering:
    """An ordering for an array space (cf. ``pymc3/blocking.py:33``).

    ``vars`` must expose ``name``, ``unconstrained_shape`` and ``dtype`` —
    free RVs in this build. Slices index the *unconstrained* flat vector.
    """

    def __init__(self, vars):
        self.vmap: List[VarMap] = []
        self.by_name: Dict[str, VarMap] = {}
        self.size = 0
        for var in vars:
            name = var.name
            if name is None:
                raise ValueError("unnamed variable in ArrayOrdering")
            shape = tuple(getattr(var, "unconstrained_shape", None) or var.shape)
            count = int(np.prod(shape, dtype=int))
            slc = slice(self.size, self.size + count)
            vm = VarMap(name, slc, shape, np.dtype(var.dtype).name)
            self.vmap.append(vm)
            self.by_name[name] = vm
            self.size += count

    def __getitem__(self, key):
        return self.by_name[key]

    def __iter__(self):
        return iter(self.vmap)


class DictToArrayBijection:
    """Map between Point dicts and flat vectors (cf. ``blocking.py:62``)."""

    def __init__(self, ordering: ArrayOrdering, dpoint: Dict[str, np.ndarray]):
        self.ordering = ordering
        self.dpt = dpoint

    def map(self, dpt: Dict[str, np.ndarray]):
        """Dict -> flat array."""
        vals = []
        for var, slc, shp, dtyp in self.ordering.vmap:
            vals.append(np.ravel(np.asarray(dpt[var])))
        if not vals:
            return np.array([], dtype="float64")
        return np.concatenate(vals)

    def rmap(self, apt) -> Dict[str, np.ndarray]:
        """Flat array -> dict (numpy)."""
        dpt = {}
        apt = np.asarray(apt)
        for var, slc, shp, dtyp in self.ordering.vmap:
            dpt[var] = apt[slc].reshape(shp).astype(dtyp)
        for name, val in self.dpt.items():
            if name not in dpt:
                dpt[name] = val
        return dpt

    def rmap_jax(self, q) -> Dict:
        """Flat jnp vector -> dict of jnp arrays (traceable)."""
        return {vm.var: q[vm.slc].reshape(vm.shp) for vm in self.ordering.vmap}

    def mapf(self, f):
        """function over dicts -> function over flat arrays."""
        def wrapped(apt, *args, **kwargs):
            return f(self.rmap(apt), *args, **kwargs)
        return wrapped


class ListArrayOrdering:
    """An ordering for a list of arrays (cf. ``blocking.py:123``)."""

    def __init__(self, list_arrays, intype="numpy"):
        self.vmap = []
        self.intype = intype
        self.size = 0
        for array in list_arrays:
            shape = np.asarray(array).shape
            count = int(np.prod(shape, dtype=int))
            slc = slice(self.size, self.size + count)
            self.vmap.append(VarMap(str(self.size), slc, shape,
                                    np.asarray(array).dtype.name))
            self.size += count


class ListToArrayBijection:
    """cf. ``blocking.py:155``."""

    def __init__(self, ordering: ListArrayOrdering, list_arrays):
        self.ordering = ordering
        self.list_arrays = list_arrays

    def fmap(self, list_arrays):
        out = np.empty(self.ordering.size)
        for vm, arr in zip(self.ordering.vmap, list_arrays):
            out[vm.slc] = np.ravel(arr)
        return out

    def rmap(self, array):
        return [np.asarray(array)[vm.slc].reshape(vm.shp).astype(vm.dtyp)
                for vm in self.ordering.vmap]

    def mapf(self, f):
        def wrapped(array, *args, **kwargs):
            return f(self.rmap(array), *args, **kwargs)
        return wrapped


class DictToVarBijection:
    """Bijection between a single var value and a Point (cf. ``blocking.py:234``)."""

    def __init__(self, var, idx, dpoint):
        self.var = getattr(var, "name", str(var))
        self.idx = idx
        self.dpt = dpoint

    def map(self, dpt):
        return dpt[self.var][self.idx]

    def rmap(self, apt):
        dpt = dict(self.dpt)
        dvar = np.array(dpt[self.var], copy=True)
        dvar[self.idx] = apt
        dpt[self.var] = dvar
        return dpt

    def mapf(self, f):
        def wrapped(apt, *args, **kwargs):
            return f(self.rmap(apt), *args, **kwargs)
        return wrapped


class Compose:
    """Compose two functions in a pickle-friendly way (cf. ``blocking.py:261``)."""

    def __init__(self, fa, fb):
        self.fa = fa
        self.fb = fb

    def __call__(self, x):
        return self.fa(self.fb(x))
