"""The port's host join operators (``flink_tpu_torch/runtime/
join_operators.py``), its join API and Nexmark Q7 against the reference on
the CPU.

- ``equi_join_indices``, ``WindowJoinOperator`` (tumbling and sliding),
  ``IntervalJoinOperator`` (INNER and ``left_outer``) and
  ``TemporalJoinOperator`` against the reference's over the same batches
  and watermarks: every emitted batch, and every snapshot, equal; a
  restored operator continues as the uninterrupted one.
- The public-API interval join (``KeyedStream.interval_join().between()``)
  through ``env.execute`` at ``parallelism.default`` 1 and 8: with
  ``join.mode=device`` equal to the reference's ``join.mode=device`` batch
  for batch, with ``join.mode=host`` equal to the reference's host run,
  and the two modes' pair sets equal (the port's form of
  ``test_datastream_join_mode_device_matches_host``).
- Nexmark Q7 (``build_q7``) through the public API, equal to the
  reference's ``build_q7`` and to ``oracle_q7``.
- A checkpointed interval-join job (both modes) that fails mid-stream and
  is restored through ``execute(restore_from=)``: the rows its sink had
  committed at the restored checkpoint plus the restored run's rows equal
  a clean run's, as a multiset.

Tolerance: none. Batches and snapshots are compared bit for bit (floats
on their bits), in order; pair sets and multisets compare whole rows.
"""

import collections

import numpy as np
import pytest

from flink_tpu import (
    Configuration as JConfiguration,
    StreamExecutionEnvironment as JEnv,
)
from flink_tpu.benchmarks.nexmark import (
    BidSource as JBidSource,
    build_q7 as jbuild_q7,
)
from flink_tpu.connectors.sinks import CollectSink as JCollectSink
from flink_tpu.connectors.sources import Source as JSource
from flink_tpu.core.records import RecordBatch as JRecordBatch
from flink_tpu.runtime import join_operators as jops
from flink_tpu.windowing import assigners as jassigners
from flink_tpu_torch import Configuration, StreamExecutionEnvironment
from flink_tpu_torch.benchmarks.nexmark import (
    BidSource,
    build_q7,
    oracle_q7,
)
from flink_tpu_torch.connectors.sinks import CollectSink
from flink_tpu_torch.connectors.sources import Source
from flink_tpu_torch.core.records import (
    KEY_ID_FIELD,
    TIMESTAMP_FIELD,
    RecordBatch,
)
from flink_tpu_torch.runtime import join_operators as ops
from flink_tpu_torch.windowing import assigners

_U = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _bits(a):
    a = np.asarray(a)
    return a.view(_U[a.dtype.itemsize]) if a.dtype.kind == "f" else a


def assert_batches_equal(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(got, want):
        assert sorted(a.names()) == sorted(b.names())
        assert len(a) == len(b)
        for n in a.names():
            x, y = np.asarray(a[n]), np.asarray(b[n])
            assert x.dtype == y.dtype, (n, x.dtype, y.dtype)
            if x.dtype == object:
                assert [repr(v) for v in x] == [repr(v) for v in y], n
            else:
                np.testing.assert_array_equal(_bits(x), _bits(y),
                                              err_msg=n)


def assert_state_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_state_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_state_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        g = np.asarray(got)
        assert g.dtype == want.dtype, path
        if g.dtype == object:
            assert [repr(v) for v in g] == [repr(v) for v in want], path
        else:
            np.testing.assert_array_equal(_bits(g), _bits(want),
                                          err_msg=path)
    else:
        assert got == want, path


def cols(keys, ts, **values):
    return {KEY_ID_FIELD: np.asarray(keys, dtype=np.int64),
            **{k: np.asarray(v) for k, v in values.items()},
            TIMESTAMP_FIELD: np.asarray(ts, dtype=np.int64)}


def side_stream(steps, n, keys, span, seed, jitter=None):
    """(input, columns, watermark) steps over both inputs."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        for side in (0, 1):
            ts = step * span + rng.integers(0, jitter or span, n)
            c = cols(rng.integers(0, keys, n), ts,
                     **({"v": rng.random(n).astype(np.float32),
                         "id": rng.integers(0, 1 << 40, n)}
                        if side == 0 else
                        {"w": rng.random(n).astype(np.float32),
                         "id": rng.integers(0, 1 << 40, n).astype(np.int32),
                         "flag": rng.random(n) < 0.5}))
            out.append((side, c, step * span - span))
    return out


def drive(op, stream, batch_cls, close=True):
    out = []
    for side, c, wm in stream:
        out += op.process_batch(batch_cls(c), side)
        out += op.process_watermark(wm)
    if close:
        out += op.close() if hasattr(op, "close") and not isinstance(
            op, (ops.WindowJoinOperator, jops.WindowJoinOperator)) \
            else op.process_watermark(1 << 40)
    return out


# -------------------------------------------------------------- equi join


@pytest.mark.parametrize("seed,nl,nr,keys", [
    (0, 200, 300, 50), (1, 0, 10, 5), (2, 10, 0, 5), (3, 1000, 1000, 3),
    (4, 50, 60, 10_000)])
def test_equi_join_indices_matches_reference(seed, nl, nr, keys):
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, keys, nl).astype(np.int64)
    rk = rng.integers(0, keys, nr).astype(np.int64)
    got = ops.equi_join_indices(lk, rk)
    want = jops.equi_join_indices(lk, rk)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) == sum(int((rk == k).sum()) for k in lk)


# ------------------------------------------------------------ window join


@pytest.mark.parametrize("kind", ["tumbling", "sliding"])
def test_window_join_operator_matches_reference(kind):
    mk = {"tumbling": lambda a: a.TumblingEventTimeWindows.of(100),
          "sliding": lambda a: a.SlidingEventTimeWindows.of(200, 100)}[kind]
    stream = side_stream(8, 150, 40, 60, seed=3)
    op = ops.WindowJoinOperator(mk(assigners), key_fields=("k", "k"))
    jop = jops.WindowJoinOperator(mk(jassigners), key_fields=("k", "k"))
    got = drive(op, stream[:9], RecordBatch, close=False)
    want = drive(jop, stream[:9], JRecordBatch, close=False)
    snap = op.snapshot_state()
    assert_state_equal(snap, jop.snapshot_state())
    restored = ops.WindowJoinOperator(mk(assigners), key_fields=("k", "k"))
    restored.restore_state(snap)
    got += drive(restored, stream[9:], RecordBatch)
    want += drive(jop, stream[9:], JRecordBatch)
    assert sum(len(b) for b in want) > 0
    assert_batches_equal(got, want)


# ---------------------------------------------------------- interval join


@pytest.mark.parametrize("outer", [False, True])
def test_interval_join_operator_matches_reference(outer):
    stream = side_stream(8, 120, 30, 50, seed=5, jitter=80)
    kw = (dict(left_outer=True, right_columns=["w", "id", "flag"])
          if outer else {})
    op = ops.IntervalJoinOperator(-20, 35, **kw)
    jop = jops.IntervalJoinOperator(-20, 35, **kw)
    got = drive(op, stream[:7], RecordBatch, close=False)
    want = drive(jop, stream[:7], JRecordBatch, close=False)
    snap = op.snapshot_state()
    assert_state_equal(snap, jop.snapshot_state())
    restored = ops.IntervalJoinOperator(-20, 35, **kw)
    restored.restore_state(snap)
    got += drive(restored, stream[7:], RecordBatch)
    want += drive(jop, stream[7:], JRecordBatch)
    assert sum(len(b) for b in want) > 0
    assert_batches_equal(got, want)
    if outer:
        # some left rows expired unmatched and were null-padded
        assert any(np.isnan(np.asarray(b["w"], dtype=np.float64)).any()
                   for b in got)


def test_left_outer_needs_right_columns():
    with pytest.raises(ValueError, match="right-side column names"):
        ops.IntervalJoinOperator(0, 1, left_outer=True)


# ---------------------------------------------------------- temporal join


def test_temporal_join_operator_matches_reference():
    rng = np.random.default_rng(8)
    stream = []
    for step in range(8):
        # left rows up to 150 ms behind: some arrive late
        stream.append((0, cols(rng.integers(0, 40, 200),
                               step * 100 + rng.integers(-150, 100, 200),
                               v=rng.random(200).astype(np.float32)),
                       step * 100 - 30))
        stream.append((1, cols(rng.integers(0, 40, 40),
                               step * 100 + rng.integers(0, 100, 40),
                               rate=rng.random(40)), step * 100 - 30))
    op, jop = ops.TemporalJoinOperator(), jops.TemporalJoinOperator()
    got = drive(op, stream[:9], RecordBatch, close=False)
    want = drive(jop, stream[:9], JRecordBatch, close=False)
    snap = op.snapshot_state()
    assert_state_equal(snap, jop.snapshot_state())
    restored = ops.TemporalJoinOperator()
    restored.restore_state(snap)
    got += drive(restored, stream[9:], RecordBatch)
    want += drive(jop, stream[9:], JRecordBatch)
    assert sum(len(b) for b in want) > 0
    assert_batches_equal(got, want)
    assert restored.late_left_dropped + op.late_left_dropped == \
        jop.late_left_dropped
    assert jop.late_left_dropped > 0


# ----------------------------------------------------- public-API join


def _side_factory(base):
    class SideSource(base):
        """``total`` rows of one join input in batches of ``per``: keys
        over 40 values, sorted timestamps over 2 s, one float32 column;
        its position is the rows emitted."""

        def __init__(self, seed, col, total=1200, per=256):
            rng = np.random.default_rng(seed)
            self.col, self.per, self.done = col, per, 0
            self.keys = rng.integers(0, 40, total).astype(np.int64)
            self.vals = rng.random(total).astype(np.float32)
            self.ts = np.sort(rng.integers(0, 2000, total).astype(np.int64))

        def poll_batch(self, max_records):
            if self.done >= len(self.keys):
                return None
            a, b = self.done, min(self.done + self.per, len(self.keys))
            self.done = b
            cls = JRecordBatch if base is JSource else RecordBatch
            return cls.from_pydict(
                {"k": self.keys[a:b], self.col: self.vals[a:b]},
                timestamps=self.ts[a:b])

        def snapshot_position(self):
            return {"done": self.done}

        def restore_position(self, pos):
            self.done = pos["done"]

    return SideSource


SideSource = _side_factory(Source)
JSideSource = _side_factory(JSource)


def _interval_job(env, sink, side_cls, fail=None):
    left = env.add_source(side_cls(1, "price")).key_by("k")
    right = env.add_source(side_cls(2, "rate")).key_by("k")
    if fail is not None:
        left = left.map(fail, name="failmap").key_by("k")
    else:
        left = left.map(lambda b: b, name="failmap").key_by("k")
    left.interval_join(right).between(-100, 100).sink_to(sink)


def _run_interval(mode, parallelism, reference=False):
    settings = {"join.mode": mode, "execution.micro-batch.size": 128,
                "parallelism.default": parallelism,
                "state.slot-table.capacity": 256}
    if reference:
        # the reference's source pump threads interleave the two inputs
        # as their timing falls; polled inline, as the port polls them,
        # its sources take turns and its batches are reproducible
        env = JEnv(JConfiguration(
            {**settings, "execution.pipeline.in-flight-batches": 0}))
        sink = JCollectSink()
        _interval_job(env, sink, JSideSource)
    else:
        env = StreamExecutionEnvironment(Configuration(
            {**settings, "execution.device": "cpu",
             "execution.pipeline.in-flight-batches": 0}))
        sink = CollectSink()
        _interval_job(env, sink, SideSource)
    env.execute("ij-" + mode)
    return sink.batches


def _rows(batches):
    rows = []
    for b in batches:
        names = sorted(b.names())
        for i in range(len(b)):
            rows.append(tuple((n, _bits(np.asarray(b[n])[i:i + 1])[0].item())
                              for n in names))
    return rows


@pytest.mark.parametrize("parallelism", [1, 8])
def test_public_interval_join_modes_match_each_other_and_reference(
        parallelism):
    dev = _run_interval("device", parallelism)
    host = _run_interval("host", parallelism)
    assert len(_rows(host)) > 0
    assert collections.Counter(_rows(dev)) == collections.Counter(
        _rows(host))
    assert_batches_equal(dev, _run_interval("device", parallelism,
                                            reference=True))
    assert_batches_equal(host, _run_interval("host", parallelism,
                                             reference=True))


def test_public_join_mode_rejects_unknown_value():
    env = StreamExecutionEnvironment(Configuration(
        {"join.mode": "gpu", "execution.device": "cpu"}))
    with pytest.raises(ValueError, match="join.mode"):
        _interval_job(env, CollectSink(), SideSource)


class _CommitSink(CollectSink):
    """A collect sink that takes part in checkpoints: the batches it held
    at the last snapshot are its committed output."""

    def __init__(self):
        super().__init__()
        self.committed = 0

    def snapshot_state(self):
        self.committed = len(self.batches)
        return {"batches": self.committed}

    def restore_state(self, state):
        pass


class _FailAfter:
    def __init__(self, n):
        self.n, self.seen = n, 0

    def __call__(self, batch):
        self.seen += len(batch)
        if self.seen > self.n:
            raise RuntimeError("injected failure")
        return batch


@pytest.mark.parametrize("mode,parallelism", [("device", 8),
                                              ("device", 1),
                                              ("host", 1)])
def test_checkpointed_interval_join_restores_exactly_once(tmp_path, mode,
                                                          parallelism):
    base = {"join.mode": mode, "execution.micro-batch.size": 128,
            "parallelism.default": parallelism, "execution.device": "cpu",
            "state.slot-table.capacity": 256}
    env = StreamExecutionEnvironment(Configuration(base))
    clean = CollectSink()
    _interval_job(env, clean, SideSource)
    env.execute("clean")
    expected = collections.Counter(_rows(clean.batches))
    assert expected

    root = str(tmp_path / "ckpt")
    conf = Configuration({
        **base, "state.checkpoints.dir": root,
        "execution.checkpointing.every-n-source-batches": 5})
    env = StreamExecutionEnvironment(conf)
    crashed = _CommitSink()
    # a checkpoint after the 3rd round of polls (6 batches), the failure
    # in the 5th left batch: the 4th round's rows are past the cut
    _interval_job(env, crashed, SideSource, fail=_FailAfter(1100))
    with pytest.raises(RuntimeError, match="injected failure"):
        env.execute("crashing")
    assert crashed.committed > 0
    assert len(crashed.batches) > crashed.committed   # rows past the cut

    env = StreamExecutionEnvironment(conf)
    restored = _CommitSink()
    _interval_job(env, restored, SideSource)
    result = env.execute("restored", restore_from=root)
    assert result.metrics["restore_ms"] > 0
    got = collections.Counter(_rows(crashed.batches[:crashed.committed]
                                    + restored.batches))
    assert got == expected


# ------------------------------------------------------------------- Q7


@pytest.mark.parametrize("records,size_ms", [(300_000, 1000),
                                             (120_000, 200)])
def test_q7_matches_reference_and_oracle(records, size_ms):
    settings = {"execution.micro-batch.size": 1 << 14,
                "state.slot-table.capacity": 1 << 12}
    env = StreamExecutionEnvironment(Configuration(
        {**settings, "execution.device": "cpu"}))
    sink = CollectSink()
    build_q7(env, BidSource(total_records=records, num_auctions=10_000,
                            events_per_second_of_eventtime=100_000),
             size_ms=size_ms).sink_to(sink)
    env.execute("q7")
    jenv = JEnv(JConfiguration(settings))
    jsink = JCollectSink()
    jbuild_q7(jenv, JBidSource(total_records=records, num_auctions=10_000,
                               events_per_second_of_eventtime=100_000),
              size_ms=size_ms).sink_to(jsink)
    jenv.execute("q7")
    assert_batches_equal(sink.batches, jsink.batches)
    res = sink.result()
    assert res["max_price"].dtype == np.float32

    src = BidSource(total_records=records, num_auctions=10_000,
                    events_per_second_of_eventtime=100_000)
    src.open()
    b = RecordBatch.concat(iter(lambda: src.poll_batch(1 << 16), None))
    want = oracle_q7(zip(b["auction"].tolist(), b["bidder"].tolist(),
                         b["price"].tolist(), b[TIMESTAMP_FIELD].tolist()),
                     size_ms)
    got = collections.defaultdict(list)
    for r in res.to_rows():
        assert r["price"] == r["max_price"]
        got[r["window_end"]].append((r["auction"], r["bidder"],
                                     r["max_price"]))
    assert set(got) == set(want) and len(want) > 1
    for w, (mx, winners) in want.items():
        assert {p for _, _, p in got[w]} == {mx}
        assert sorted((a, b) for a, b, _ in got[w]) == sorted(winners)
