"""Session windows through the port (``flink_tpu_torch/windowing/
sessions.py``, ``flat_merge_pairs``, ``DataGenSource``, the DataStream
dispatch) against the reference on the CPU.

- ``DataGenSource``: the same batches as the reference's, skew included.
- ``flat_merge_pairs``: the reference's jitted program on the same planes
  and pairs — Count, float32/float64 Sum with NaN payloads and +-inf,
  float32/float64 Max/Min with NaN payloads and +-0, duplicate
  destinations and padded lanes.
- ``SessionWindower``: the counterparts of ``tests/test_sessions.py``'s
  basics, oracle, out-of-order, late-drop and public-API tests (its
  snapshot tests are in ``tests/test_torch_restore.py``), each run through both
  packages with every fired batch equal in order and bit for bit, and
  held to a brute-force oracle where the reference's test is.
- BASELINE row 5's job (``tools/bench_suite.py:198-245``) through the
  public API, cut to 200k records, 100k keys and a 1<<12-row budget (so
  the paged spill tier evicts and reloads): the sink rows equal the
  reference's, in order, bit for bit.

Inputs come from numpy seeds. Tolerance: none, except where the
oracle's float sums are compared (relative 1e-4, as the reference's test;
the oracle adds in another order).
"""

import collections

import numpy as np
import pytest
import torch

from flink_tpu.connectors.sources import DataGenSource as JDataGenSource
from flink_tpu.core.records import RecordBatch as JRecordBatch
from flink_tpu.stateplane import flat_merge_pairs as jflat_merge_pairs
from flink_tpu.windowing import aggregates as jagg
from flink_tpu.windowing.sessions import SessionWindower as JSessionWindower
from flink_tpu_torch.connectors.sources import DataGenSource
from flink_tpu_torch.core.records import KEY_ID_FIELD, RecordBatch
from flink_tpu_torch.stateplane.families import flat_merge_pairs
from flink_tpu_torch.windowing import aggregates as tagg
from flink_tpu_torch.windowing.sessions import SessionWindower

_U = {4: np.uint32, 8: np.uint64}


def _bits(a):
    a = np.asarray(a)
    return a.view(_U[a.dtype.itemsize]) if a.dtype.kind == "f" else a


def assert_batches_equal(got, want):
    """Fired batches equal in order, every column bit for bit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g.names()) == sorted(w.names())
        for name in w.names():
            a, b = np.asarray(g[name]), np.asarray(w[name])
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


# ----------------------------------------------------------- DataGenSource

@pytest.mark.parametrize("skew", [0.0, 1.1])
def test_datagen_batches_equal_reference(skew):
    """Keys, float32 values and timestamps bit for bit, across uneven
    batches and a two-way split of the index space."""
    for sub, par in [(0, 1), (1, 2)]:
        src = DataGenSource(50_000, 1_000, 400_000, seed=3, skew=skew)
        ref = JDataGenSource(50_000, 1_000, 400_000, seed=3, skew=skew)
        src.open(sub, par)
        ref.open(sub, par)
        for size in (1, 999, 1 << 12, 1 << 16, 7):
            got, want = src.poll_batch(size), ref.poll_batch(size)
            if want is None:
                assert got is None
                continue
            for name in ("key", "value"):
                assert got[name].dtype == want[name].dtype
                np.testing.assert_array_equal(_bits(got[name]),
                                              _bits(want[name]))
            np.testing.assert_array_equal(got.timestamps, want.timestamps)


# -------------------------------------------------------- flat_merge_pairs

#: NaN payloads (signalling, quiet, negative), +-1, +-0 and +-inf
_SPECIAL = {
    np.float32: np.array([0x7fa00001, 0x7fc00002, 0xffc00003, 0xffa00004,
                          0x3f800000, 0xbf800000, 0, 0x80000000,
                          0x7f800000, 0xff800000], np.uint32),
    np.float64: np.array([0x7ff4000000000001, 0x7ff8000000000002,
                          0xfff8000000000003, 0xfff4000000000004,
                          0x3ff0000000000000, 0xbff0000000000000, 0,
                          0x8000000000000000, 0x7ff0000000000000,
                          0xfff0000000000000], np.uint64),
}

MERGE_AGGS = {
    "count": (jagg.CountAggregate, tagg.CountAggregate, {}),
    "sum_f32": (jagg.SumAggregate, tagg.SumAggregate, {}),
    "sum_f64": (jagg.SumAggregate, tagg.SumAggregate,
                {"dtype": np.float64}),
    "max_f32": (jagg.MaxAggregate, tagg.MaxAggregate, {}),
    "max_f64": (jagg.MaxAggregate, tagg.MaxAggregate,
                {"dtype": np.float64}),
    "min_f32": (jagg.MinAggregate, tagg.MinAggregate, {}),
    "min_f64": (jagg.MinAggregate, tagg.MinAggregate,
                {"dtype": np.float64}),
    "avg_f32": (jagg.AvgAggregate, tagg.AvgAggregate, {}),
}


def _merge_case(kind, seed, cap=4096, pairs=700, size=1024):
    """Planes ``[cap]`` per leaf (slot 0 the identity) and a chain-free
    group of (dst, src) pairs, many sharing a dst, padded with 0/0."""
    jmake, tmake, kw = MERGE_AGGS[kind]
    args = () if kind == "count" else ("v",)
    jl = jmake(*args, **kw).leaves
    rng = np.random.default_rng(seed)
    planes = []
    for leaf in jl:
        dt = np.dtype(leaf.dtype)
        if dt.kind != "f":
            p = rng.integers(0, 1000, cap).astype(dt)
        elif leaf.reduce == "sum":
            p = (rng.standard_normal(cap)
                 * np.exp(rng.uniform(-8, 8, cap))).astype(dt)
            sp = rng.random(cap) < 0.05
            p[sp] = rng.choice(_SPECIAL[dt.type], int(sp.sum())).view(dt)
        else:
            p = rng.choice(_SPECIAL[dt.type], cap).view(dt)
        p[0] = leaf.identity
        planes.append(p)
    slots = rng.permutation(np.arange(1, cap))
    dst_pool, src = slots[:pairs // 7], slots[cap // 2:cap // 2 + pairs]
    dst = rng.choice(dst_pool, pairs)
    dst = np.concatenate([dst, np.zeros(size - pairs, np.int64)])
    src = np.concatenate([src, np.zeros(size - pairs, np.int64)])
    return jmake, tmake, args, kw, planes, dst.astype(np.int32), \
        src.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", sorted(MERGE_AGGS))
def test_flat_merge_pairs_matches_reference(kind, seed):
    import jax

    jmake, tmake, args, kw, planes, dst, src = _merge_case(kind, seed)
    x64 = any(np.dtype(p.dtype).itemsize == 8 for p in planes)
    with jax.enable_x64(x64):
        want = jflat_merge_pairs(jmake(*args, **kw).leaves)(
            tuple(jax.numpy.asarray(p) for p in planes),
            jax.numpy.asarray(dst), jax.numpy.asarray(src))
        want = [np.asarray(w) for w in want]
    got = flat_merge_pairs(tmake(*args, **kw).leaves)(
        tuple(torch.from_numpy(p.copy()) for p in planes),
        torch.from_numpy(dst), torch.from_numpy(src))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


# ---------------------------------------------------------- SessionWindower

def _jbatch(keys, values, ts):
    return JRecordBatch.from_pydict(
        {KEY_ID_FIELD: np.asarray(keys, dtype=np.int64),
         "v": np.asarray(values, dtype=np.float32)}, timestamps=ts)


def _tbatch(keys, values, ts):
    return RecordBatch.from_pydict(
        {KEY_ID_FIELD: np.asarray(keys, dtype=np.int64),
         "v": np.asarray(values, dtype=np.float32)}, timestamps=ts)


class Pair:
    """The port's and the reference's SessionWindower driven by the same
    calls; every fire compared in order, bit for bit."""

    def __init__(self, gap, agg="sum", spill=None, **kw):
        make_j = {"sum": lambda: jagg.SumAggregate("v"),
                  "count": jagg.CountAggregate}[agg]
        make_t = {"sum": lambda: tagg.SumAggregate("v"),
                  "count": tagg.CountAggregate}[agg]
        self.j = JSessionWindower(gap, make_j(), spill=spill, **kw)
        self.t = SessionWindower(gap, make_t(),
                                 spill={**(spill or {}), "device": "cpu"},
                                 **kw)

    #: write a NaN into the port's reserved slot 0 before every call
    poison_slot0 = False

    def _poison(self):
        if self.poison_slot0:
            for a in self.t.table.accs:
                a[0] = float("nan")

    def process(self, keys, values, ts):
        self.j.process_batch(_jbatch(keys, values, ts))
        self._poison()
        self.t.process_batch(_tbatch(keys, values, ts))

    def fire(self, wm):
        want = self.j.on_watermark(wm)
        self._poison()
        got = self.t.on_watermark(wm)
        assert_batches_equal(got, want)
        assert self.t.late_records_dropped == self.j.late_records_dropped
        return got


def fired_to_dict(batches, field="sum_v"):
    out = {}
    for b in batches:
        for r in b.to_rows():
            out[(r[KEY_ID_FIELD], r["window_start"], r["window_end"])] = \
                r[field]
    return out


def oracle_sessions(events, gap):
    """events (key, value, ts) -> {(key, start, end): sum} after a flush."""
    by_key = collections.defaultdict(list)
    for k, v, t in events:
        by_key[k].append((t, v))
    out = {}
    for k, evs in by_key.items():
        evs.sort()
        cur = []
        for t, v in evs:
            if cur and t - cur[-1][0] > gap:
                out[(k, cur[0][0], cur[-1][0] + gap)] = sum(
                    x[1] for x in cur)
                cur = []
            cur.append((t, v))
        if cur:
            out[(k, cur[0][0], cur[-1][0] + gap)] = sum(x[1] for x in cur)
    return out


class TestSessionBasics:
    def test_single_session(self):
        w = Pair(100)
        w.process([1, 1, 1], [1, 2, 3], [0, 50, 120])
        assert w.fire(218) == []
        assert fired_to_dict(w.fire(219)) == {(1, 0, 220): 6.0}

    def test_pathological_timestamp_span_takes_lexsort_fallback(self):
        w = Pair(100)
        w.process([1, 2], [1.0, 2.0], [-(1 << 62), 1 << 61])
        assert fired_to_dict(w.fire(1 << 62)) == {
            (1, -(1 << 62), -(1 << 62) + 100): 1.0,
            (2, 1 << 61, (1 << 61) + 100): 2.0}

    def test_gap_splits_sessions(self):
        w = Pair(10)
        w.process([1, 1], [1, 2], [0, 100])
        assert fired_to_dict(w.fire(10**6)) == {(1, 0, 10): 1.0,
                                                (1, 100, 110): 2.0}

    def test_cross_batch_merge(self):
        w = Pair(50)
        w.process([1], [1.0], [0])
        w.process([1], [2.0], [40])
        w.process([1], [4.0], [200])
        assert fired_to_dict(w.fire(10**6)) == {(1, 0, 90): 3.0,
                                                (1, 200, 250): 4.0}

    def test_bridge_merges_two_sessions(self):
        """A record chain bridging two live sessions merges them: the
        merge moves one accumulator into the other (flat_merge_pairs)."""
        w = Pair(20)
        w.process([1], [1.0], [0])
        w.process([1], [2.0], [100])
        w.process([1] * 5, [0.5] * 5, [20, 40, 60, 80, 95])
        assert fired_to_dict(w.fire(10**6)) == {(1, 0, 120): 5.5}

    def test_fire_frees_state(self):
        w = Pair(10, agg="count")
        w.process([1, 2, 3], [1, 1, 1], [0, 0, 0])
        assert w.t.table.num_used == 3
        w.fire(10**6)
        assert w.t.table.num_used == 0
        assert not w.t.sessions

    def test_late_record_dropped(self):
        w = Pair(10, agg="count")
        w.process([1], [1], [100])
        w.fire(200)
        w.process([1], [1], [50])
        assert w.t.late_records_dropped == 1


class TestSessionOracle:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_against_oracle(self, seed):
        rng = np.random.default_rng(seed)
        gap = 30
        w = Pair(gap, capacity=1 << 14)
        events = []
        for step in range(8):
            n = 300
            keys = rng.integers(0, 25, n).astype(np.int64)
            vals = rng.random(n).astype(np.float32)
            ts = rng.integers(step * 200, step * 200 + 400,
                              n).astype(np.int64)
            events.extend(zip(keys.tolist(), vals.tolist(), ts.tolist()))
            w.process(keys, vals, ts)
        fired = fired_to_dict(w.fire(10**9))
        oracle = oracle_sessions(events, gap)
        assert set(fired) == set(oracle)
        for k in oracle:
            assert fired[k] == pytest.approx(oracle[k], rel=1e-4), k

    def test_high_cardinality(self):
        rng = np.random.default_rng(9)
        w = Pair(1000, agg="count", capacity=1 << 15)
        n = 20000
        w.process(rng.integers(0, 10000, n), np.ones(n, np.float32),
                  rng.integers(0, 5000, n))
        fired = w.fire(10**9)
        assert sum(int(b["count"].sum()) for b in fired) == n


class TestOutOfOrderMerge:
    def test_out_of_order_record_merges_into_live_session(self):
        w = Pair(50)
        w.process([1], [1.0], [100])
        assert w.fire(120) == []
        w.process([1], [2.0], [60])
        assert w.t.late_records_dropped == 0
        assert fired_to_dict(w.fire(10**6)) == {(1, 60, 150): 3.0}

    def test_stale_new_session_still_dropped(self):
        w = Pair(50)
        w.process([1], [1.0], [1000])
        w.fire(2000)
        w.process([1], [2.0], [100])
        assert w.t.late_records_dropped == 1
        assert fired_to_dict(w.fire(10**6)) == {}


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("budget", [0, 1 << 10])
def test_late_records_under_allowed_lateness_match_reference(budget, poison):
    """Late records within the allowance start new sessions; beyond it
    they are dropped and their values land in the reserved slot 0 (the
    reference folds them there; the card's fold drops slot-0 lanes). The
    sink rows — not the raw planes — are held equal; with ``poison`` the
    port's slot 0 holds a NaN before every batch and fire, and the rows
    are still the reference's: nothing on the path reads slot 0 (a merge's
    padded lanes and a reload's put reset it)."""
    rng = np.random.default_rng(11)
    w = Pair(40, allowed_lateness=150,
             spill={"max_device_slots": budget} if budget else None,
             capacity=1 << 10)
    w.poison_slot0 = poison
    wm = 0
    for step in range(40):
        n = 200
        keys = rng.integers(0, 300, n)
        vals = rng.standard_normal(n).astype(np.float32)
        ts = wm + rng.integers(-400, 300, n)
        w.process(keys, vals, ts)
        wm += 120
        w.fire(wm)
    w.fire(1 << 60)
    assert w.t.late_records_dropped > 0
    assert w.t.merge_groups > 0


@pytest.mark.parametrize("poison", [False, True])
def test_merges_under_eviction_match_reference(poison):
    """Bridging records across many keys while the paged tier evicts:
    merge groups resolve dst and src in one lookup, so both are resident
    for the merge; fires, drops and spill counters equal the reference's,
    also with a NaN in the port's slot 0 before every call."""
    rng = np.random.default_rng(12)
    w = Pair(30, spill={"max_device_slots": 1 << 11}, capacity=1 << 11)
    w.poison_slot0 = poison
    for step in range(30):
        n = 250
        keys = rng.integers(0, 3000, n)
        ts = step * 25 + rng.integers(0, 100, n)
        w.process(keys, rng.random(n).astype(np.float32), ts)
        w.fire(step * 25 - 200)
    w.fire(1 << 60)
    assert w.t.spill_counters() == w.j.spill_counters()
    assert w.t.spill_counters()["rows_evicted"] > 0
    assert w.t.merge_groups > 0


# ------------------------------------------------------------- public API

def _row5_job(pkg, records, keys, budget, batch, extra=None):
    """BASELINE row 5 (tools/bench_suite.py:198-245) through ``pkg``'s
    public API, cut to ``records``/``keys``/``budget``."""
    if pkg == "ref":
        from flink_tpu import Configuration, StreamExecutionEnvironment
        from flink_tpu.connectors.sinks import CollectSink
        from flink_tpu.connectors.sources import DataGenSource as Src
        from flink_tpu.runtime.watermarks import WatermarkStrategy
        from flink_tpu.windowing.assigners import EventTimeSessionWindows
    else:
        from flink_tpu_torch import Configuration, StreamExecutionEnvironment
        from flink_tpu_torch.connectors.sinks import CollectSink
        from flink_tpu_torch.connectors.sources import DataGenSource as Src
        from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
        from flink_tpu_torch.windowing.assigners import (
            EventTimeSessionWindows,
        )
    env = StreamExecutionEnvironment(Configuration({
        "execution.micro-batch.size": batch,
        "state.slot-table.capacity": budget,
        "state.slot-table.max-device-slots": budget,
        **(extra or {})}))
    sink = CollectSink()
    (env.from_source(Src(records, keys, 400_000, seed=3),
                     WatermarkStrategy.for_bounded_out_of_orderness(0))
        .key_by("key").window(EventTimeSessionWindows.with_gap(2_000))
        .sum("value").sink_to(sink))
    env.execute("sessions")
    return sink


def test_row5_job_through_public_api_matches_reference():
    got = _row5_job("port", 200_000, 100_000, 1 << 12, 1 << 11,
                    {"execution.device": "cpu"})
    want = _row5_job("ref", 200_000, 100_000, 1 << 12, 1 << 11)
    assert len(got.batches) == len(want.batches)
    g, w = got.result(), want.result()
    assert len(w) > 50_000
    assert sorted(g.names()) == sorted(w.names())
    for name in w.names():
        np.testing.assert_array_equal(_bits(g[name]), _bits(w[name]),
                                      err_msg=name)


def _jittered(base, splitmix, jitter):
    """``base`` (a DataGenSource) with each timestamp moved back by up to
    ``jitter`` ms and each value one of the float32 specials (NaN
    payloads, +-0, +-inf, +-1), both hashed from the record index: out of
    order, so sessions merge."""

    class Jittered(base):
        def _generate(self, idx):
            b = super()._generate(idx)
            late = splitmix(idx, 99) % np.uint64(jitter)
            vals = _SPECIAL[np.float32][splitmix(idx, 98) % np.uint64(10)]
            return b.with_column("value", vals.view(np.float32)) \
                .with_timestamps(b.timestamps - late.astype(np.int64))

    return Jittered


def _merge_job(pkg, records, keys, budget, batch, extra=None):
    if pkg == "ref":
        from flink_tpu import Configuration, StreamExecutionEnvironment
        from flink_tpu.connectors.sinks import CollectSink
        from flink_tpu.connectors.sources import DataGenSource as Src
        from flink_tpu.connectors.sources import _splitmix64
        from flink_tpu.runtime.watermarks import WatermarkStrategy
        from flink_tpu.windowing.assigners import EventTimeSessionWindows
    else:
        from flink_tpu_torch import Configuration, StreamExecutionEnvironment
        from flink_tpu_torch.connectors.sinks import CollectSink
        from flink_tpu_torch.connectors.sources import DataGenSource as Src
        from flink_tpu_torch.connectors.sources import _splitmix64
        from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
        from flink_tpu_torch.windowing.assigners import (
            EventTimeSessionWindows,
        )
    env = StreamExecutionEnvironment(Configuration({
        "execution.micro-batch.size": batch,
        "state.slot-table.capacity": budget,
        "state.slot-table.max-device-slots": budget,
        **(extra or {})}))
    sink = CollectSink()
    src = _jittered(Src, _splitmix64, 3000)(records, keys, 400_000, seed=3)
    (env.from_source(src, WatermarkStrategy.for_bounded_out_of_orderness(
        3000)).key_by("key").window(EventTimeSessionWindows.with_gap(2_000))
        .max("value").sink_to(sink))
    env.execute("sessions")
    return sink


def test_out_of_order_max_job_with_merges_matches_reference():
    """Max over NaN payloads and +-0 with out-of-order records under a
    budget: sessions merge (``flat_merge_pairs`` on the Max NaN rule) and
    page out; the sink rows equal the reference's in order, bit for
    bit."""
    got = _merge_job("port", 60_000, 4_000, 1 << 11, 1 << 10,
                     {"execution.device": "cpu"})
    want = _merge_job("ref", 60_000, 4_000, 1 << 11, 1 << 10)
    g, w = got.result(), want.result()
    assert len(w) > 1000
    for name in w.names():
        np.testing.assert_array_equal(_bits(g[name]), _bits(w[name]),
                                      err_msg=name)


def test_session_api_with_string_keys():
    """tests/test_sessions.py's public-API case: string keys come back
    on the fired rows."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.connectors.sources import Source
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.windowing.assigners import EventTimeSessionWindows

    class Rows(Source):
        def open(self, subtask_index=0, parallelism=1):
            self.done = False

        def poll_batch(self, max_records):
            if self.done:
                return None
            self.done = True
            return RecordBatch.from_pydict(
                {"key": np.array(["a", "a", "b", "a"], dtype=object),
                 "v": np.array([1.0, 2.0, 5.0, 4.0], np.float32)},
                timestamps=np.array([0, 900, 100, 5000], np.int64))

    env = StreamExecutionEnvironment(Configuration(
        {"execution.device": "cpu"}))
    sink = CollectSink()
    (env.from_source(Rows(), WatermarkStrategy.for_bounded_out_of_orderness(0))
        .key_by("key").window(EventTimeSessionWindows.with_gap(1000))
        .sum("v").sink_to(sink))
    env.execute()
    got = {(r["key"], r["window_start"], r["window_end"]): r["sum_v"]
           for r in sink.rows()}
    assert got == {("a", 0, 1900): 3.0, ("b", 100, 1100): 5.0,
                   ("a", 5000, 6000): 4.0}


def test_session_job_above_parallelism_one_raises():
    """Above parallelism 1 a session job runs on the mesh session engine
    (``tests/test_torch_mesh_sessions.py``), never at parallelism 1
    instead: an option that engine does not port yet raises naming its
    ROADMAP item."""
    with pytest.raises(NotImplementedError, match="item 12"):
        _row5_job("port", 10_000, 100, 1 << 12, 1 << 11,
                  {"execution.device": "cpu", "parallelism.default": 2,
                   "shuffle.mode": "host"})


def test_session_job_on_the_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        _row5_job("port", 10_000, 100, 1 << 12, 1 << 11)


def test_fire_projector_on_sessions_raises():
    from flink_tpu_torch import StreamExecutionEnvironment
    from flink_tpu_torch.windowing.assigners import EventTimeSessionWindows
    from flink_tpu_torch.windowing.fire_projectors import TopKFireProjector

    env = StreamExecutionEnvironment()
    ws = (env.from_source(DataGenSource(10, 10)).key_by("key")
          .window(EventTimeSessionWindows.with_gap(10)))
    with pytest.raises(ValueError, match="fire_projector"):
        ws.aggregate(tagg.CountAggregate(),
                     fire_projector=TopKFireProjector("count", 4))


def test_queries_and_snapshots_name_their_items():
    w = SessionWindower(10, tagg.CountAggregate(), spill={"device": "cpu"})
    with pytest.raises(NotImplementedError, match="item 12"):
        w.query_sessions(1)
    with pytest.raises(NotImplementedError, match="item 12"):
        w.query_sessions_batch([1])
    # snapshots are ported (item 8a): the table and the interval lists
    snap = w.snapshot()
    assert set(snap) == {"table", "sessions", "next_sid",
                         "max_fired_watermark"}
