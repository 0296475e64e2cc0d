"""BASELINE row 1 on the port: socket WordCount over a 5 s tumbling
processing-time window (the port's form of ``tools/bench_suite.py``
``row1_wordcount``, the reference's WindowWordCount).

    python3 -m flink_tpu_torch.benchmarks.wordcount [--lines N]
        [--device cuda|cpu] [--parallelism P]

The reference's shape: a local line server sends ``--lines`` lines (200,000
by default) of ``to be or not to be that is the question`` over a TCP
socket, 512 lines a write; the job is ``SocketSource`` → ``flat_map``
(split into words, one ``one`` column of 1s) → ``key_by("word")`` →
``TumblingProcessingTimeWindows.of(5000)`` → ``.sum("one")``, in
micro-batches of ``1 << 15``. The words are strings: they go through
``hash_keys_to_i64`` and the fire re-attaches them.

It prints one JSON line with ``wordcount_socket_words_per_sec`` (the
line's ten words per line over the wall time of ``env.execute()``), the
job's window-fire latency, the fired rows and the oracle's verdict: over
all windows each word's counts sum to ``lines`` times its multiplicity in
the line (``to`` and ``be`` twice, the others once), the total is ten per
line, and the re-attached words are exactly the line's words.
"""

from __future__ import annotations

import argparse
import json
import socket
import threading
import time
from collections import Counter
from typing import Dict

import numpy as np

LINE = "to be or not to be that is the question"
#: each word's multiplicity in the line
MULTIPLICITY: Dict[str, int] = dict(Counter(LINE.split()))
LINES = 200_000
WINDOW_MS = 5_000
BATCH = 1 << 15
CHUNK_LINES = 512


def serve_lines(n_lines: int):
    """A one-connection line server on a free localhost port that sends
    exactly ``n_lines`` lines, ``CHUNK_LINES`` per write, then closes.
    Returns (port, thread)."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    chunk = (LINE + "\n").encode() * CHUNK_LINES

    def feed():
        conn, _ = srv.accept()
        with conn:
            sent = 0
            while sent < n_lines:
                n = min(CHUNK_LINES, n_lines - sent)
                conn.sendall(chunk if n == CHUNK_LINES
                             else (LINE + "\n").encode() * n)
                sent += n
        srv.close()

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    return port, t


def split_words(batch):
    """One record per word, with a column of 1s to sum."""
    from flink_tpu_torch.core.records import RecordBatch

    words = " ".join(str(ln) for ln in batch["line"]).split()
    arr = np.empty(len(words), dtype=object)
    arr[:] = words
    return [RecordBatch({"word": arr,
                         "one": np.ones(len(words), dtype=np.int64)})]


def run(n_lines: int = LINES, device: str = "cuda", parallelism: int = 1,
        batch: int = BATCH, window_ms: int = WINDOW_MS) -> dict:
    """One row-1 run; returns its numbers and the oracle's verdict."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.connectors.sources import SocketSource
    from flink_tpu_torch.windowing.assigners import (
        TumblingProcessingTimeWindows,
    )

    port, feeder = serve_lines(n_lines)
    env = StreamExecutionEnvironment(Configuration({
        "execution.micro-batch.size": batch,
        "parallelism.default": parallelism,
        "execution.device": device}))
    sink = CollectSink()
    (env.add_source(SocketSource("127.0.0.1", port))
        .flat_map(split_words)
        .key_by("word")
        .window(TumblingProcessingTimeWindows.of(window_ms))
        .sum("one").sink_to(sink))
    t0 = time.perf_counter()
    result = env.execute("wordcount")
    wall = time.perf_counter() - t0
    feeder.join(timeout=10)
    out = sink.result() if sink.batches else None
    counts: Dict[str, int] = {}
    if out is not None:
        for w, c in zip(out["word"].tolist(), out["sum_one"].tolist()):
            counts[w] = counts.get(w, 0) + int(c)
    return {
        "metric": "wordcount_socket_words_per_sec",
        "value": n_lines * len(LINE.split()) / wall,
        "unit": "words/s",
        "lines": n_lines,
        "wall_s": wall,
        "fire_latency_ms": result.metrics.get("window_fire_latency_ms"),
        "fired_rows": 0 if out is None else len(out),
        "windows": 0 if out is None else len(np.unique(out["window_end"])),
        "counts": counts,
        "oracle_ok": check_counts(counts, n_lines),
    }


def check_counts(counts: Dict[str, int], n_lines: int) -> bool:
    """The row-1 oracle: per-word totals over all windows, the grand
    total, and the re-attached words equal to the line's words."""
    want = {w: n_lines * m for w, m in MULTIPLICITY.items()}
    return (counts == want
            and sum(counts.values()) == n_lines * len(LINE.split()))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lines", type=int, default=LINES)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parallelism", type=int, default=1)
    args = ap.parse_args()
    out = run(args.lines, args.device, args.parallelism)
    print(json.dumps(out, default=str), flush=True)
    if not out["oracle_ok"]:
        raise SystemExit("wordcount: counts differ from the oracle")


if __name__ == "__main__":
    main()
