"""Minibatch container semantics (cf. ``pymc3/data.py:111`` and the
reference's ``tests/test_data_container.py``): index bookkeeping of the
window mode, degenerate batch sizes, and X/y pairing."""
import numpy as np
import jax
import pytest

import pymc3_tpu as pm
from pymc3_tpu.data import MinibatchNode, RNG_ENV_KEY


def test_window_indices_none_match_test_value():
    """indices(None) must report the ORIGINAL-array positions of exactly
    the rows _test_value returns (AEVB encoders index the user's copy of
    the data with it)."""
    data = np.arange(40, dtype=np.float32).reshape(20, 2)
    mb = MinibatchNode(data, batch_size=6, random_seed=7)
    assert mb.sampling == "window"
    idx = np.asarray(mb.indices(None))
    np.testing.assert_array_equal(data[idx], np.asarray(mb._test_value))


def test_window_indices_keyed_match_eval():
    """The fast dynamic-slice eval path and indices(key) must select the
    same rows for the same key."""
    data = np.arange(60, dtype=np.float32).reshape(30, 2)
    mb = MinibatchNode(data, batch_size=5, random_seed=3)
    key = jax.random.PRNGKey(11)
    rows_fast = np.asarray(mb._eval_default({RNG_ENV_KEY: key}, {}))
    idx = np.asarray(mb.indices(key))
    np.testing.assert_array_equal(rows_fast, data[idx])


def test_batch_size_at_least_data_falls_back_to_random():
    """A window >= the data length would slice past the circular padding
    (dynamic_slice clamps the offset, biasing toward leading rows):
    such configs take the i.i.d. gather path instead."""
    data = np.arange(10, dtype=np.float32)
    for bs in (10, 17):
        mb = MinibatchNode(data, batch_size=bs, random_seed=1)
        assert mb.sampling == "random"
        out = np.asarray(mb._eval_default({RNG_ENV_KEY: jax.random.PRNGKey(0)},
                                          {}))
        assert out.shape == (bs,)
        assert set(np.asarray(out).tolist()) <= set(data.tolist())


def test_window_marginal_row_probability_uniform():
    """Every row must have equal marginal probability bs/N (the property
    that keeps the scaled likelihood unbiased)."""
    data = np.arange(16, dtype=np.float32)
    mb = MinibatchNode(data, batch_size=4, random_seed=0)
    counts = np.zeros(16)
    key = jax.random.PRNGKey(42)
    for i in range(400):
        key, sub = jax.random.split(key)
        idx = np.asarray(mb.indices(sub))
        counts[idx] += 1
    # each row expected 400 * 4/16 = 100 times; binomial sd ~ 8.7
    assert counts.min() > 55 and counts.max() < 145


def test_same_seed_views_stay_paired():
    """Two Minibatch views with the same seed walk the same index stream
    (how X-vs-y row pairing survives, cf. ``pymc3/data.py:156``)."""
    X = np.arange(50, dtype=np.float32)
    y = np.arange(50, dtype=np.float32) * 10
    mbx = MinibatchNode(X, batch_size=8, random_seed=5)
    mby = MinibatchNode(y, batch_size=8, random_seed=5)
    key = jax.random.PRNGKey(2)
    bx = np.asarray(mbx._eval_default({RNG_ENV_KEY: key}, {}))
    by = np.asarray(mby._eval_default({RNG_ENV_KEY: key}, {}))
    np.testing.assert_array_equal(by, bx * 10)
