"""Nexmark Q5 through the port's public API at parallelism 8 on the CPU,
against the JAX reference's run of the same job and against the oracle
(the configuration tests/test_mesh_public_api.py pins for the reference).

Tolerance: none — counts are integers; rows must be equal.
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


def test_parallelism_one_is_not_ported_yet():
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink

    env = StreamExecutionEnvironment(Configuration(
        {"execution.device": "cpu"}))
    build_q5(env, BidSource(total_records=100)).sink_to(CollectSink())
    with pytest.raises(NotImplementedError, match="Queue A item 3"):
        env.execute()
