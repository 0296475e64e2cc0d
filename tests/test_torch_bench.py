"""The port's benchmark entry (``flink_tpu_torch/benchmarks/bench.py``,
ROADMAP Queue A item 13) on the CPU at a small size: it runs both layouts
and prints one JSON line with ``bench.py``'s fields. No timing is checked
here (a CPU run says nothing of the card)."""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench(**env):
    return subprocess.run(
        [sys.executable, "-m", "flink_tpu_torch.benchmarks.bench"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "BENCH_RECORDS": "300000", "BENCH_REPS": "2",
             **env})


def test_bench_entry_prints_one_line_of_bench_py_fields():
    proc = _bench(BENCH_DEVICE="cpu")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["metric"] == \
        "nexmark_q5_hop_hot_items_events_per_sec_per_chip"
    assert out["unit"] == "events/s" and out["value"] > 0
    assert out["vs_baseline"] == round(out["value"] / 500_000.0, 3)
    assert len(out["rep_events_per_s"]) == 2
    assert out["best_events_per_s"] == max(out["rep_events_per_s"])
    assert out["value"] in out["rep_events_per_s"]
    assert out["layout"] in ("panes", "slots")
    assert out["fire_latency_ms"]["count"] > 0
    assert out["device"] == "cpu"
    # both layouts ran, the chosen one's reps are the line's
    assert "layout=panes rep 1" in proc.stderr
    assert "layout=slots rep 1" in proc.stderr


def test_bench_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    proc = _bench()
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
