"""Text file trace backend (cf. ``pymc3/backends/text.py``).

Streaming CSV: one file per chain, one row per draw, flattened columns
(``text.py:43``); ``load`` restores a MultiTrace (``text.py:174``).
"""
from __future__ import annotations

import glob
import os
import shutil
from typing import Dict, List

import numpy as np

from ..model import modelcontext
from .base import BaseTrace, MultiTrace
from .ndarray import NDArray

__all__ = ["Text", "load", "dump"]


def _create_flat_names(varname, shape):
    """cf. ``tracetab.py:52``: ``x -> x``, ``x (2,) -> x__0, x__1``."""
    if not shape:
        return [varname]
    labels = (np.ravel(xs).tolist() for xs in np.indices(shape))
    labels = (map(str, xs) for xs in labels)
    return [f"{varname}__{'_'.join(idxs)}" for idxs in zip(*labels)]


class Text(BaseTrace):
    """Text trace object (cf. ``text.py:43``)."""

    supports_sampler_stats = False

    def __init__(self, name, model=None, vars=None, test_point=None):
        if not os.path.exists(name):
            os.mkdir(name)
        super().__init__(name, model, vars, test_point)
        self.flat_names = {v: _create_flat_names(v, shape)
                           for v, shape in self.var_shapes.items()}
        self.filename = None
        self._fh = None
        self.df = None

    def setup(self, draws, chain, sampler_vars=None):
        if sampler_vars is not None:
            raise ValueError("Text backend does not support sampler stats.")
        super().setup(draws, chain, sampler_vars=None)
        self.chain = chain
        self.filename = os.path.join(self.name, f"chain-{chain}.csv")
        cnames = [fv for v in self.varnames for fv in self.flat_names[v]]
        if os.path.exists(self.filename):
            with open(self.filename) as fh:
                prev_cnames = next(fh).strip().split(",")
            if prev_cnames != cnames:
                raise ValueError("Previous file has different variables")
            self._fh = open(self.filename, "a")
        else:
            self._fh = open(self.filename, "w")
            self._fh.write(",".join(cnames) + "\n")

    def record(self, point, sampler_stats=None):
        if sampler_stats is not None:
            raise ValueError("Text backend does not support sampler stats.")
        vals = {}
        for varname, value in zip(self.varnames, self._fn(point)):
            vals[varname] = np.ravel(value)
        columns = [str(val) for var in self.varnames for val in vals[var]]
        self._fh.write(",".join(columns) + "\n")

    def record_batch(self, var_values, n, stats_batch=None):
        for i in range(n):
            columns = [str(v) for var in self.varnames
                       for v in np.ravel(var_values[var][i])]
            self._fh.write(",".join(columns) + "\n")

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- selection -----------------------------------------------------------
    def _load_df(self):
        if self.df is None:
            import pandas as pd

            self.df = pd.read_csv(self.filename)
            for key, dtype in self.var_dtypes.items():
                for fname in self.flat_names[key]:
                    self.df[fname] = self.df[fname].astype(dtype)

    def __len__(self):
        if self.filename is None or not os.path.exists(self.filename):
            return 0
        self._load_df()
        return self.df.shape[0]

    def get_values(self, varname, burn=0, thin=1):
        self._load_df()
        shape = (self.df.shape[0],) + self.var_shapes[varname]
        vals = self.df[self.flat_names[varname]].values.reshape(shape)
        return vals[burn::thin]

    def _slice(self, idx):
        if idx.stop is not None:
            raise ValueError("Stop value in slice not supported.")
        return ndarray_from_text(self)._slice(idx)

    def point(self, idx) -> Dict[str, np.ndarray]:
        self._load_df()
        idx = int(idx)
        return {v: self.df[self.flat_names[v]].iloc[idx].values.reshape(
            self.var_shapes[v]) for v in self.varnames}


def ndarray_from_text(strace: Text) -> NDArray:
    nd = NDArray(model=strace.model, vars=strace.vars)
    nd.chain = strace.chain
    nd.samples = {v: strace.get_values(v) for v in strace.varnames}
    nd.draw_idx = len(strace)
    return nd


def load(name, model=None) -> MultiTrace:
    """Load Text database (cf. ``text.py:174``)."""
    files = glob.glob(os.path.join(name, "chain-*.csv"))
    if len(files) == 0:
        raise ValueError(f"No files present in directory {name}")
    straces = []
    for f in files:
        chain = int(os.path.splitext(os.path.basename(f))[0].replace(
            "chain-", ""))
        model = modelcontext(model)
        strace = Text(name, model=model)
        strace.chain = chain
        strace.filename = f
        straces.append(strace)
    return MultiTrace(straces)


def dump(name, trace, chains=None):
    """Store values from NDArray trace as CSV files (cf. ``text.py:204``)."""
    import pandas as pd

    if not os.path.exists(name):
        os.mkdir(name)
    if chains is None:
        chains = trace.chains
    for chain in chains:
        filename = os.path.join(name, f"chain-{chain}.csv")
        strace = trace._straces[chain]
        data = {}
        for varname in strace.varnames:
            vals = strace.get_values(varname)
            flat = _create_flat_names(varname, strace.var_shapes.get(
                varname, np.shape(vals)[1:]))
            arr = np.reshape(vals, (len(vals), -1))
            for i, fname in enumerate(flat):
                data[fname] = arr[:, i]
        pd.DataFrame(data).to_csv(filename, index=False)
