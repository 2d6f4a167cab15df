"""Backend tests (cf. ``pymc3/tests/backend_fixtures.py`` + per-backend
test files): setup/record/selection/dump-load equality across
NDArray/Text/SQLite/HDF5."""
import os

import numpy as np
import pytest

import pymc3_tpu as pm
from pymc3_tpu.backends import NDArray, Text, SQLite, HDF5
from pymc3_tpu.backends import text as text_mod, sqlite as sqlite_mod, \
    hdf5 as hdf5_mod
from pymc3_tpu.backends.base import MultiTrace

from . import models


@pytest.fixture(scope="module")
def sampled():
    _, model, _ = models.simple_model()
    with model:
        trace = pm.sample(draws=100, tune=100, chains=2, progressbar=False,
                          random_seed=0, compute_convergence_checks=False)
    return model, trace


class TestNDArray:
    def test_record_and_select(self, sampled):
        model, trace = sampled
        assert len(trace) == 100
        vals = trace.get_values("x")
        assert vals.shape == (200, 2)
        vals_c = trace.get_values("x", combine=False)
        assert len(vals_c) == 2
        pt = trace.point(5)
        assert "x" in pt
        sliced = trace[25:75]
        assert len(sliced) == 50
        thinned = trace.get_values("x", burn=10, thin=2)
        assert thinned.shape == (45 * 2, 2)

    def test_stats_roundtrip(self, sampled):
        model, trace = sampled
        stats = trace.get_sampler_stats("depth")
        assert stats.shape == (200,)

    def test_save_load(self, sampled, tmp_path):
        model, trace = sampled
        d = pm.save_trace(trace, str(tmp_path / "tr"), overwrite=True)
        with model:
            t2 = pm.load_trace(d)
        np.testing.assert_allclose(trace.get_values("x"),
                                   t2.get_values("x"))
        # warmup state checkpoint present (an extension)
        assert getattr(t2._straces[0], "warmup_state", None) is not None

    def test_merge_traces(self, sampled):
        model, trace = sampled
        with model:
            t2 = pm.sample(draws=100, tune=50, chains=2, progressbar=False,
                           random_seed=9, compute_convergence_checks=False)
        merged = pm.merge_traces([trace, t2])
        assert merged.nchains == 4


class TestTextBackend:
    def test_roundtrip(self, sampled, tmp_path):
        model, trace = sampled
        name = str(tmp_path / "textdb")
        text_mod.dump(name, trace)
        with model:
            loaded = text_mod.load(name)
        np.testing.assert_allclose(
            np.sort(trace.get_values("x"), axis=0),
            np.sort(loaded.get_values("x"), axis=0), rtol=1e-4)

    def test_record_stream(self, sampled, tmp_path):
        model, trace = sampled
        name = str(tmp_path / "textdb2")
        with model:
            strace = Text(name, model=model)
            strace.setup(10, 0)
            for i in range(10):
                strace.record(model.test_point)
            strace.close()
            assert len(strace) == 10


class TestSQLiteBackend:
    def test_roundtrip(self, sampled, tmp_path):
        model, trace = sampled
        name = str(tmp_path / "trace.sqlite")
        with model:
            strace = SQLite(name, model=model)
            strace.setup(20, 0)
            for i in range(20):
                strace.record(model.test_point)
            strace.close()
            loaded = sqlite_mod.load(name)
        assert len(loaded) == 20
        vals = loaded.get_values("x")
        assert vals.shape[0] == 20


class TestHDF5Backend:
    def test_roundtrip(self, sampled, tmp_path):
        model, trace = sampled
        name = str(tmp_path / "trace.h5")
        with model:
            strace = HDF5(name, model=model)
            strace.setup(15, 0, [{"stat1": np.float64}])
            for i in range(15):
                strace.record(model.test_point, [{"stat1": float(i)}])
            strace.close()
            loaded = hdf5_mod.load(name)
        assert len(loaded) == 15
        stats = loaded.get_sampler_stats("stat1")
        np.testing.assert_allclose(stats, np.arange(15.0))


class TestTraceToDataframe:
    def test_df(self, sampled):
        model, trace = sampled
        df = pm.trace_to_dataframe(trace)
        # merge_traces (run earlier on the shared fixture) mutates in place,
        # so compute the expectation from the trace itself
        assert df.shape[0] == len(trace) * trace.nchains
        assert any(c.startswith("x") for c in df.columns)


class TestAddRemoveValues:
    """Post-hoc derived series on MultiTrace (reference API parity:
    ``pymc3/backends/base.py:394-458``)."""

    def test_roundtrip(self, sampled):
        _, trace = sampled
        n = len(trace) * trace.nchains
        series = np.arange(n, dtype=float)
        trace.add_values({"derived": series})
        assert "derived" in trace.varnames
        np.testing.assert_allclose(
            trace.get_values("derived", combine=True), series)
        per_chain = trace.get_values("derived", combine=False)
        assert len(per_chain) == trace.nchains
        assert per_chain[1][0] == len(trace)
        trace.remove_values("derived")

    def test_overwrite_guard(self, sampled):
        _, trace = sampled
        n = len(trace) * trace.nchains
        trace.add_values({"v2": np.zeros(n)})
        with pytest.raises(ValueError):
            trace.add_values({"v2": np.ones(n)})
        trace.add_values({"v2": np.ones(n)}, overwrite=True)
        assert trace.get_values("v2", combine=True).min() == 1.0
        trace.remove_values("v2")

    def test_remove(self, sampled):
        _, trace = sampled
        n = len(trace) * trace.nchains
        trace.add_values({"tmp": np.zeros(n)})
        trace.remove_values("tmp")
        assert "tmp" not in trace.varnames
        with pytest.raises(KeyError):
            trace.remove_values("tmp")

    def test_length_mismatch_warns(self, sampled):
        _, trace = sampled
        with pytest.warns(UserWarning, match="rows"):
            with pytest.raises(ValueError):
                trace.add_values({"bad": np.zeros(7)})


class TestBackendEquality:
    """cf. ``backend_fixtures.py:489`` (``BackendEqualityTestCase``) +
    ``SelectionTestCase:287``: identical recorded data must come back
    identically from every backend across the full selection matrix
    (burn x thin x chains x combine x squeeze, point(), slicing)."""

    N, CHAINS = 30, 2

    @pytest.fixture(scope="class")
    def equal_traces(self, tmp_path_factory):
        _, model, _ = models.simple_model()
        rng = np.random.RandomState(7)
        draws = [{"x": rng.randn(self.CHAINS, 2).astype(np.float32)}
                 for _ in range(self.N)]
        stats = [{"stat1": rng.rand(self.CHAINS)} for _ in range(self.N)]
        tmp = tmp_path_factory.mktemp("backends")

        def build(factory, with_stats=True):
            straces = []
            for c in range(self.CHAINS):
                strace = factory(c)
                if with_stats:
                    strace.setup(self.N, c, [{"stat1": np.float64}])
                else:
                    strace.setup(self.N, c)
                for i in range(self.N):
                    if with_stats:
                        strace.record(
                            {"x": draws[i]["x"][c]},
                            [{"stat1": float(stats[i]["stat1"][c])}])
                    else:
                        strace.record({"x": draws[i]["x"][c]})
                strace.close()
                straces.append(strace)
            return MultiTrace(straces)

        with model:
            traces = {
                "ndarray": build(lambda c: NDArray(model=model)),
                # Text has no sampler-stat support (reference parity,
                # ``backends/text.py``)
                "text": build(lambda c: Text(
                    str(tmp / "text"), model=model), with_stats=False),
                # SQLite: no sampler stats either (reference parity,
                # ``backends/sqlite.py:76``)
                "sqlite": build(lambda c: SQLite(
                    str(tmp / "eq.sqlite"), model=model),
                    with_stats=False),
                "hdf5": build(lambda c: HDF5(
                    str(tmp / "eq.h5"), model=model)),
            }
        return traces

    @pytest.mark.parametrize("backend", ["text", "sqlite", "hdf5"])
    @pytest.mark.parametrize("burn,thin", [(0, 1), (5, 1), (0, 3), (7, 2)])
    @pytest.mark.parametrize("combine", [True, False])
    def test_get_values_matrix(self, equal_traces, backend, burn, thin,
                               combine):
        ref = equal_traces["ndarray"].get_values(
            "x", burn=burn, thin=thin, combine=combine)
        got = equal_traces[backend].get_values(
            "x", burn=burn, thin=thin, combine=combine)
        if combine:
            np.testing.assert_allclose(got, ref, rtol=1e-6)
        else:
            assert len(got) == len(ref)
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g, r, rtol=1e-6)

    @pytest.mark.parametrize("backend", ["text", "sqlite", "hdf5"])
    def test_chain_selection_and_squeeze(self, equal_traces, backend):
        ref = equal_traces["ndarray"]
        got = equal_traces[backend]
        for chains in (0, [1], [0, 1]):
            np.testing.assert_allclose(
                got.get_values("x", chains=chains),
                ref.get_values("x", chains=chains), rtol=1e-6)
        # squeeze=False returns a list even for one chain
        out = got.get_values("x", chains=[0], combine=False, squeeze=False)
        assert isinstance(out, list) and len(out) == 1

    @pytest.mark.parametrize("backend", ["text", "sqlite", "hdf5"])
    def test_point_and_len(self, equal_traces, backend):
        ref = equal_traces["ndarray"]
        got = equal_traces[backend]
        assert len(got) == len(ref) == self.N
        for idx in (0, 7, self.N - 1, -1):
            np.testing.assert_allclose(got.point(idx)["x"],
                                       ref.point(idx)["x"], rtol=1e-6)

    @pytest.mark.parametrize("backend", ["hdf5"])
    def test_sampler_stats_equal(self, equal_traces, backend):
        np.testing.assert_allclose(
            equal_traces[backend].get_sampler_stats("stat1"),
            equal_traces["ndarray"].get_sampler_stats("stat1"), rtol=1e-6)

    def test_ndarray_slicing_semantics(self, equal_traces):
        """``SelectionTestCase`` slicing: a sliced MultiTrace preserves
        draw alignment and stats."""
        tr = equal_traces["ndarray"]
        sl = tr[5:25:2]
        assert len(sl) == 10
        got = sl.get_values("x", combine=False)
        exp = tr.get_values("x", burn=5, thin=2, combine=False)
        for g, e in zip(got, exp):
            np.testing.assert_allclose(g, e[:10], rtol=1e-6)


class TestSQLiteViaSample:
    def test_sample_into_sqlite_drops_stats(self, sampled, tmp_path):
        """pm.sample with a SQLite trace: the stats gate (reference
        ``sampling.py:615-620``) routes draws in and drops sampler stats
        instead of erroring."""
        model, _ = sampled
        name = str(tmp_path / "via_sample.sqlite")
        with model:
            tr = pm.sample(draws=30, tune=30, chains=1, trace=SQLite(name),
                           progressbar=False, random_seed=1,
                           compute_convergence_checks=False)
            loaded = sqlite_mod.load(name)
        assert len(tr) == 30
        np.testing.assert_allclose(loaded.get_values("x"),
                                   tr.get_values("x", combine=True))

    def test_draw_numbering_resumes(self, sampled, tmp_path):
        """A second setup() on the same chain continues draw numbering
        (the reference's max_draw resume)."""
        model, _ = sampled
        name = str(tmp_path / "resume.sqlite")
        with model:
            s1 = SQLite(name, model=model)
            s1.setup(5, 0)
            for _ in range(5):
                s1.record(model.test_point)
            s1.close()
            s2 = SQLite(name, model=model)
            s2.setup(5, 0)
            assert s2.draw_idx == 5
            for _ in range(5):
                s2.record(model.test_point)
            s2.close()
            loaded = sqlite_mod.load(name)
        assert len(loaded) == 10

    def test_bit_exact_roundtrip(self, sampled, tmp_path):
        """Blob storage round-trips float32 values bit-exactly (the
        reference's FLOAT columns go through REAL)."""
        model, _ = sampled
        name = str(tmp_path / "exact.sqlite")
        vals = np.array([[1/3, np.pi], [1e-30, -7.0], [2/7, 1e30]],
                        dtype=np.float64)
        with model:
            s = SQLite(name, model=model)
            s.setup(3, 0)
            for v in vals:
                pt = dict(model.test_point)
                pt["x"] = np.asarray(v, dtype=pt["x"].dtype)
                s.record(pt)
            s.close()
            out = sqlite_mod.load(name).get_values("x")
        np.testing.assert_array_equal(out, vals.astype(out.dtype))


class TestTracetab:
    """Trace -> DataFrame conversion (cf. reference
    ``tests/test_tracetab.py:1``)."""

    def _trace(self):
        import pymc3_tpu as pm
        with pm.Model() as m:
            pm.Normal("x", 0.0, 1.0)
            pm.Normal("y", 0.0, 1.0, shape=(2, 2))
        return pm.sample(draws=50, tune=20, chains=2, model=m,
                         progressbar=False,
                         compute_convergence_checks=False,
                         random_seed=5)

    def test_create_flat_names(self):
        from pymc3_tpu.backends.tracetab import (create_flat_names,
                                                 _create_shape)
        assert create_flat_names("x", ()) == ["x"]
        assert create_flat_names("x", (2,)) == ["x__0", "x__1"]
        want2d = ["x__0_0", "x__0_1", "x__1_0", "x__1_1"]
        assert create_flat_names("x", (2, 2)) == want2d
        want3d = ["x__0_0_0", "x__0_0_1", "x__0_1_0", "x__0_1_1",
                  "x__1_0_0", "x__1_0_1", "x__1_1_0", "x__1_1_1"]
        assert create_flat_names("x", (2, 2, 2)) == want3d
        # inverse recovers the shape from the labels
        assert _create_shape(want2d) == (2, 2)
        assert _create_shape(["x"]) == ()

    def test_trace_to_dataframe_values(self):
        from pymc3_tpu.backends.tracetab import trace_to_dataframe
        trace = self._trace()
        df = trace_to_dataframe(trace)
        assert len(df) == 100  # chains concatenated
        assert set(df.columns) >= {"x", "y__0_0", "y__1_1"}
        np.testing.assert_allclose(df["x"].values,
                                   trace.get_values("x", combine=True))
        y = trace.get_values("y", combine=True)
        np.testing.assert_allclose(df["y__0_1"].values, y[:, 0, 1])
        # transformed columns excluded by default
        assert not any(c.endswith("__") for c in df.columns)

    def test_trace_to_dataframe_chain_arg(self):
        from pymc3_tpu.backends.tracetab import trace_to_dataframe
        trace = self._trace()
        df0 = trace_to_dataframe(trace, chains=0)
        assert len(df0) == 50
        np.testing.assert_allclose(df0["x"].values,
                                   trace.get_values("x", chains=0))
