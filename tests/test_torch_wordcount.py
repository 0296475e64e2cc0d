"""BASELINE row 1 on the port at a small scale on the CPU
(``flink_tpu_torch/benchmarks/wordcount.py``): socket source, ``flat_map``
split, ``key_by("word")`` with string keys, a 5 s tumbling
processing-time window and ``.sum("one")``, through the public API. The
per-word totals over all windows equal the oracle exactly (``to`` and
``be`` twice the line count, the other words once), the total is ten
words a line, and the re-attached keys are the line's words — at
parallelism 1 and on the 8-shard mesh."""

import time

import pytest

from flink_tpu_torch.benchmarks import wordcount


@pytest.mark.parametrize("parallelism", [1, 8])
def test_row1_counts_equal_oracle(parallelism):
    out = wordcount.run(3000, "cpu", parallelism, batch=1 << 10)
    assert out["oracle_ok"], out["counts"]
    assert sorted(out["counts"]) == sorted(set(wordcount.LINE.split()))
    assert out["counts"]["to"] == out["counts"]["be"] == 6000
    assert out["fired_rows"] >= 8 and out["value"] > 0


def test_row1_windows_split_on_the_wall_clock():
    """With 50 ms windows the run spans several windows; the totals over
    all of them still equal the oracle."""
    out = wordcount.run(20_000, "cpu", 1, batch=1 << 9, window_ms=50)
    assert out["oracle_ok"], out["counts"]
    assert out["windows"] >= 2


def test_oracle_rejects_wrong_counts():
    good = {w: 10 * m for w, m in wordcount.MULTIPLICITY.items()}
    assert wordcount.check_counts(good, 10)
    assert not wordcount.check_counts({**good, "to": 19}, 10)
    assert not wordcount.check_counts({**good, "x": 0}, 10)


def test_reference_row1_split_gives_the_same_words():
    """The port's vectorised split yields the reference bench's words."""
    import numpy as np

    from flink_tpu_torch.core.records import RecordBatch

    lines = np.array(["to be or", "not  to be", ""], dtype=object)
    got = wordcount.split_words(RecordBatch({"line": lines}))[0]
    want = []
    for ln in lines:
        want.extend(str(ln).split())
    assert got["word"].tolist() == want
    assert got["one"].tolist() == [1] * len(want)


def _drain(src, max_records):
    src.open()
    n = 0
    deadline = time.time() + 20
    while time.time() < deadline:
        b = src.poll_batch(max_records)
        if b is None:
            break
        n += len(b)
    src.close()
    return n


def test_socket_source_drains_lines_buffered_at_close():
    """ROADMAP Queue C R3: polled with batches smaller than one receive,
    the reference's ``SocketSource`` returns None as soon as the server
    closes and drops the lines still buffered; the port returns them."""
    from flink_tpu.connectors.sources import SocketSource as JSocket
    from flink_tpu_torch.connectors.sources import SocketSource

    port, feeder = wordcount.serve_lines(20_000)
    assert _drain(SocketSource("127.0.0.1", port), 100) == 20_000
    feeder.join(10)
    port, feeder = wordcount.serve_lines(20_000)
    assert _drain(JSocket("127.0.0.1", port), 100) < 20_000
    feeder.join(10)
