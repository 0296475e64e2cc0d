"""Nexmark Q5 through the port's public API on the CPU, against the JAX
reference's run of the same job and against the oracle: at parallelism 8
(the mesh engine; the configuration tests/test_mesh_public_api.py pins
for the reference) and at parallelism 1 (the single-device slot table,
as bench.py runs Q5, and the pane layout, bench.py's other layout, with
and without pre-aggregation), where the sink rows must equal the
reference's in their order — the top-k's ties included — for Q5 and for
Q5-revenue (float32 ``.sum("price")``); a run split against
``latency.fire-deadline-ms`` gives the unsplit run's rows.

Tolerance: none — counts are integers, float sums are compared on their
raw bits; rows must be equal.
"""

import numpy as np
import pytest

from flink_tpu.benchmarks.nexmark import oracle_q5

TOTAL, AUCTIONS = 150_000, 3_000


def _run_port(top_k=0):
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink

    env = StreamExecutionEnvironment(Configuration({
        "execution.micro-batch.size": 1 << 14,
        "parallelism.default": 8,
        "execution.device": "cpu"}))
    sink = CollectSink()
    src = BidSource(total_records=TOTAL, num_auctions=AUCTIONS,
                    events_per_second_of_eventtime=100_000)
    build_q5(env, src, size_ms=10_000, slide_ms=2_000,
             device_top_k=top_k).sink_to(sink)
    result = env.execute()
    return sink.rows(), result


def _run_reference():
    from flink_tpu.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu.connectors.sinks import CollectSink
    from flink_tpu.core.config import Configuration
    from flink_tpu.datastream.environment import StreamExecutionEnvironment

    env = StreamExecutionEnvironment(Configuration({
        "execution.micro-batch.size": 1 << 14, "parallelism.default": 8}))
    sink = CollectSink()
    src = BidSource(total_records=TOTAL, num_auctions=AUCTIONS,
                    events_per_second_of_eventtime=100_000)
    build_q5(env, src, size_ms=10_000, slide_ms=2_000).sink_to(sink)
    env.execute()
    return sink.rows()


def _canon(rows):
    return sorted(sorted(r.items()) for r in rows)


def _winners(rows):
    out = {}
    for r in rows:
        out.setdefault(r["window_end"], (r["count"], set()))[1].add(
            r["auction"])
    return out


def _oracle():
    from flink_tpu_torch.benchmarks.nexmark import BidSource

    src = BidSource(total_records=TOTAL, num_auctions=AUCTIONS,
                    events_per_second_of_eventtime=100_000)
    src.open()
    b = src.poll_batch(TOTAL)
    return oracle_q5(zip(b["auction"].tolist(), b.timestamps.tolist()),
                     10_000, 2_000)


def test_q5_rows_equal_reference_and_oracle():
    rows, result = _run_port()
    assert result.metrics["records_emitted_by_sources"] == TOTAL
    assert _canon(rows) == _canon(_run_reference())
    assert _winners(rows) == _oracle()


def test_q5_top_k_projection_keeps_the_winners():
    rows, _ = _run_port(top_k=16)
    want = _oracle()
    got = _winners(rows)
    assert set(got) == set(want)
    for w, (best, winners) in got.items():
        assert best == want[w][0]
        assert winners <= want[w][1]
        assert len(winners) == min(len(want[w][1]), 16)


def test_bid_source_matches_reference_stream():
    from flink_tpu.benchmarks.nexmark import BidSource as JBidSource
    from flink_tpu_torch.benchmarks.nexmark import BidSource as TBidSource

    j = JBidSource(total_records=5000, num_auctions=AUCTIONS)
    t = TBidSource(total_records=5000, num_auctions=AUCTIONS)
    j.open(1, 3)
    t.open(1, 3)
    jb, tb = j.poll_batch(1 << 20), t.poll_batch(1 << 20)
    for name in ("auction", "bidder", "price", "__ts__"):
        np.testing.assert_array_equal(tb[name], jb[name])
    # the NumPy generator equals the native one
    idx = np.arange(1, 5000, 3, dtype=np.int64)
    gen = t._generate(idx)
    for got, name in zip(gen, ("auction", "bidder", "price", "__ts__")):
        np.testing.assert_array_equal(got, jb[name])


@pytest.mark.parametrize("key,value,item", [
    ("state.spill.dir", "s3://bucket/spill", "Queue A item 8b"),
    ("state.backend", "host-heap", "Queue A item 11"),
])
def test_parallelism_one_is_not_ported_yet(key, value, item):
    """Both keys that once raised here, naming their ROADMAP item, are
    ported: a spill directory on another filesystem scheme since item
    8b's filesystem SPI (the tier resolves the scheme only when it writes
    a file), and the state.backend placements since item 11d (host-heap
    keeps the state on the CPU). As in the reference, the job runs and
    gives the rows it gives without the key."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink

    def job(extra):
        env = StreamExecutionEnvironment(Configuration(
            {"execution.device": "cpu", **extra}))
        sink = CollectSink()
        build_q5(env, BidSource(total_records=100)).sink_to(sink)
        env.execute()
        return sink.rows()

    assert job({key: value}) == job({})


def test_placement_backend_is_refused_on_the_mesh():
    """As the reference: a state.backend placement does not apply to
    mesh-sharded state."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink

    env = StreamExecutionEnvironment(Configuration({
        "execution.device": "cpu", "parallelism.default": 8,
        "state.backend": "host-heap"}))
    build_q5(env, BidSource(total_records=100)).sink_to(CollectSink())
    with pytest.raises(ValueError, match="parallelism > 1"):
        env.execute()


# ------------------------------------------------------------ parallelism 1

P1_RATE = 20_000   # 7.5 s of event time: 8 HOP 10 s / 2 s windows fire


def _p1_job(pkg, env, job):
    """Q5 (``job`` = top-k, 0 for none) or Q5-revenue (``"revenue"``) on
    ``pkg``'s API over the same seeded bids."""
    import importlib

    nexmark = importlib.import_module(f"{pkg}.benchmarks.nexmark")
    src = nexmark.BidSource(total_records=TOTAL, num_auctions=AUCTIONS,
                            events_per_second_of_eventtime=P1_RATE)
    if job == "revenue":
        wm = importlib.import_module(f"{pkg}.runtime.watermarks")
        asg = importlib.import_module(f"{pkg}.windowing.assigners")
        return (env.from_source(
            src, wm.WatermarkStrategy.for_bounded_out_of_orderness(0))
            .key_by("auction")
            .window(asg.SlidingEventTimeWindows.of(10_000, 2_000))
            .sum("price"))
    return nexmark.build_q5(env, src, size_ms=10_000, slide_ms=2_000,
                            device_top_k=job)


def _run_p1(pkg, job, extra=None):
    import importlib

    api = importlib.import_module(pkg)
    sinks = importlib.import_module(f"{pkg}.connectors.sinks")
    conf = {"parallelism.default": 1, "execution.micro-batch.size": 1 << 14,
            **(extra or {})}
    env = api.StreamExecutionEnvironment(api.Configuration(conf))
    sink = sinks.CollectSink()
    _p1_job(pkg, env, job).sink_to(sink)
    result = env.execute()
    return sink.rows(), result


def _raw(v):
    a = np.asarray(v)
    return (a.dtype.str, a.tobytes())


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert {k: _raw(v) for k, v in g.items()} == \
            {k: _raw(v) for k, v in w.items()}


@pytest.mark.parametrize("job", [16, 0, "revenue"])
def test_parallelism_one_rows_equal_reference_in_order(job):
    """Q5 with the device top-k (16), without it, and Q5-revenue: the
    port's P = 1 engine gives the reference's sink rows in their order;
    with the top-k that fixes WHICH tied auctions survive a window that
    has more than 16 of them, and Q5 holds the oracle's winners."""
    rows, result = _run_p1("flink_tpu_torch", job,
                           {"execution.device": "cpu"})
    assert result.metrics["records_emitted_by_sources"] == TOTAL
    want = _run_p1("flink_tpu", job)[0]
    assert rows
    _same_rows(rows, want)
    if job != "revenue":
        src = _oracle_source()
        oracle = oracle_q5(zip(src["auction"].tolist(),
                               src.timestamps.tolist()), 10_000, 2_000)
        got = _winners(rows)
        assert set(got) == set(oracle)
        for w, (best, winners) in got.items():
            assert best == oracle[w][0] and winners <= oracle[w][1]


def test_parallelism_one_top_k_breaks_ties_as_the_reference():
    """A run with a window whose winning count is shared by more auctions
    than k = 2 (the first, 6 auctions at 7 bids): the auctions that
    survive are the reference's, not merely a subset of the oracle's."""
    from flink_tpu.benchmarks.nexmark import BidSource as JSource
    from flink_tpu_torch.benchmarks.nexmark import BidSource as TSource

    rows = {}
    for pkg, src_cls, extra in (
            ("flink_tpu_torch", TSource, {"execution.device": "cpu"}),
            ("flink_tpu", JSource, {})):
        import importlib

        api = importlib.import_module(pkg)
        nexmark = importlib.import_module(f"{pkg}.benchmarks.nexmark")
        sinks = importlib.import_module(f"{pkg}.connectors.sinks")
        env = api.StreamExecutionEnvironment(api.Configuration({
            "parallelism.default": 1, "execution.micro-batch.size": 1 << 12,
            **extra}))
        sink = sinks.CollectSink()
        nexmark.build_q5(env, src_cls(total_records=40_000,
                                      num_auctions=100_000,
                                      events_per_second_of_eventtime=2_000),
                         size_ms=10_000, slide_ms=2_000,
                         device_top_k=2).sink_to(sink)
        env.execute()
        rows[pkg] = sink.rows()
    _same_rows(rows["flink_tpu_torch"], rows["flink_tpu"])
    src = TSource(total_records=40_000, num_auctions=100_000,
                  events_per_second_of_eventtime=2_000)
    src.open()
    b = src.poll_batch(40_000)
    oracle = oracle_q5(zip(b["auction"].tolist(), b.timestamps.tolist()),
                       10_000, 2_000)
    got = _winners(rows["flink_tpu_torch"])
    assert any(len(got[w][1]) == 2 < len(ties)
               for w, (_, ties) in oracle.items())


PANES = {"state.window-layout": "panes",
         "state.slot-table.capacity": 1 << 14}


@pytest.mark.parametrize("preagg", [True, False])
@pytest.mark.parametrize("job", [16, "revenue"])
def test_parallelism_one_panes_rows_equal_reference_in_order(job, preagg):
    """The pane layout (state.window-layout=panes) with the delta fire
    (latency.pane-preagg on) and with the full-window harvest: Q5 with the
    device top-k and Q5-revenue give the reference's sink rows in order,
    float32 sums bit for bit, and Q5 the oracle's winners."""
    extra = {**PANES, "latency.pane-preagg": preagg}
    rows, result = _run_p1("flink_tpu_torch", job,
                           {**extra, "execution.device": "cpu"})
    assert result.metrics["records_emitted_by_sources"] == TOTAL
    want = _run_p1("flink_tpu", job, extra)[0]
    assert rows
    _same_rows(rows, want)
    if job != "revenue":
        src = _oracle_source()
        oracle = oracle_q5(zip(src["auction"].tolist(),
                               src.timestamps.tolist()), 10_000, 2_000)
        got = _winners(rows)
        assert set(got) == set(oracle)
        for w, (best, winners) in got.items():
            assert best == oracle[w][0] and winners <= oracle[w][1]


@pytest.mark.parametrize("layout", ["panes", "slots"])
def test_deadline_split_rows_equal_unsplit(layout, monkeypatch):
    """latency.fire-deadline-ms splits each source batch at the measured
    rate, with watermarks min(final, suffix-min - 1) and harvests between
    the splits: the sink rows and their order are the unsplit run's."""
    from flink_tpu_torch.cluster.local_executor import LocalExecutor

    extra = {**PANES, "state.window-layout": layout,
             "execution.device": "cpu"}
    whole = _run_p1("flink_tpu_torch", "revenue", extra)[0]
    emits = []
    orig = LocalExecutor._emit_batch

    def counting(self, node, batch):
        emits.append(len(batch))
        return orig(self, node, batch)

    monkeypatch.setattr(LocalExecutor, "_emit_batch", counting)
    split = _run_p1("flink_tpu_torch", "revenue",
                    {**extra, "latency.fire-deadline-ms": 2})[0]
    assert len(emits) > -(-TOTAL // (1 << 14))   # it did split
    _same_rows(split, whole)


def test_deadline_rate_ema_settles():
    from flink_tpu_torch.cluster.local_executor import LocalExecutor

    ex = LocalExecutor()
    ex._fire_deadline_ms = 10
    ex._deadline_rate = 0.0
    ex._deadline_observe(1000, 0.01)
    assert ex._deadline_rate == pytest.approx(100_000)
    ex._deadline_observe(1000, 0.02)
    assert 50_000 < ex._deadline_rate < 100_000


def _oracle_source():
    from flink_tpu_torch.benchmarks.nexmark import BidSource

    src = BidSource(total_records=TOTAL, num_auctions=AUCTIONS,
                    events_per_second_of_eventtime=P1_RATE)
    src.open()
    return src.poll_batch(TOTAL)
