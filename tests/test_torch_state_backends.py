"""State backends (placements) of the port against the reference, on the
CPU.

The cases are those of ``tests/test_state_backends.py``. A placement is a
``torch.device``: ``tpu-slot-table`` keeps the accumulators on
``execution.device``, ``host-heap`` on the CPU. Every job runs in both
packages and the fired rows compare bit for bit in order; the port's
``host-heap`` job also runs with ``execution.device`` left at its default
(the card), where no card is present here: the placement alone decides
where the state lives, so the job runs on the CPU and equals the others.
The refusals (an unknown name, the pane layout with a placement, a
placement at parallelism > 1) raise with the reference's messages.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_sql import PKGS, assert_batches_equal


def _rows(n=2000, keys=17):
    rng = np.random.default_rng(5)
    return [{"key": int(rng.integers(keys)), "v": float(i % 7), "t": i * 3}
            for i in range(n)]


def _assigners(p):
    a = p.mod("windowing.assigners")
    return {"sliding": a.SlidingEventTimeWindows.of(600, 300),
            "sessions": a.EventTimeSessionWindows.with_gap(50),
            "tumbling": a.TumblingEventTimeWindows.of(500)}


def _run(p, backend, window, rows, extra=None, base=None):
    conf = {**(p.base if base is None else base),
            "execution.micro-batch.size": 128, "state.backend": backend,
            **(extra or {})}
    env = p.Env(p.Configuration(conf))
    return (env.from_collection(rows, timestamp_field="t").key_by("key")
            .window(_assigners(p)[window]).sum("v").execute_and_collect())


@pytest.mark.parametrize("window", ["sliding", "sessions", "tumbling"])
def test_host_heap_equals_default_and_the_reference(window):
    rows = _rows()
    want = _run(PKGS["reference"], "host-heap", window, rows)
    port = PKGS["port"]
    for backend, base in (("host-heap", None), ("tpu-slot-table", None),
                          ("host-heap", {})):
        if base == {} and torch.cuda.is_available():
            continue            # execution.device left at the card's
        assert_batches_equal(_run(port, backend, window, rows, base=base),
                             want)
    assert_batches_equal(
        _run(PKGS["reference"], "tpu-slot-table", window, rows), want)


def test_placements_resolve_to_torch_devices():
    from flink_tpu_torch.state.backends import (
        register_state_backend,
        resolve_placement,
    )

    assert resolve_placement("host-heap") == torch.device("cpu")
    assert resolve_placement("host-heap", "cuda") == torch.device("cpu")
    assert resolve_placement("tpu-slot-table", "cpu") == torch.device("cpu")
    register_state_backend("test-pinned", lambda dev: "cpu")
    assert resolve_placement("test-pinned", "cuda") == torch.device("cpu")
    register_state_backend("test-follow", lambda dev: None)
    assert resolve_placement("test-follow", "cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="execution.device"):
            resolve_placement("tpu-slot-table")


def test_accumulators_live_on_the_placement():
    from flink_tpu_torch.state.backends import resolve_placement
    from flink_tpu_torch.state.slot_table import SlotTable
    from flink_tpu_torch.windowing.aggregates import SumAggregate

    cpu = resolve_placement("host-heap", "cuda")
    t = SlotTable(SumAggregate("v"), capacity=1 << 10, device=cpu)
    t.upsert(np.arange(10, dtype=np.int64), np.zeros(10, dtype=np.int64),
             (np.ones(10, dtype=np.float32),))
    assert all(a.device == cpu for a in t.accs)


def test_unknown_backend_fails_loudly_as_the_reference():
    msgs = {}
    for name, p in PKGS.items():
        with pytest.raises(ValueError, match="host-heap") as e:
            p.mod("state.backends").resolve_placement("rocksdb")
        msgs[name] = str(e.value).split(";")[0]
    assert msgs["port"] == msgs["reference"]
    with pytest.raises(ValueError, match="unknown state.backend"):
        _run(PKGS["port"], "rocksdb", "tumbling", _rows(100))


def test_panes_with_placement_rejected_as_the_reference():
    msgs = {}
    for name, p in PKGS.items():
        with pytest.raises(ValueError, match="panes") as e:
            _run(p, "host-heap", "sliding", _rows(200),
                 extra={"state.window-layout": "panes"})
        msgs[name] = str(e.value)
    assert msgs["port"] == msgs["reference"]


@pytest.mark.parametrize("window", ["sliding", "sessions"])
def test_placement_on_mesh_path_fails_loudly_as_the_reference(window):
    msgs = {}
    for name, p in PKGS.items():
        with pytest.raises(ValueError, match="parallelism > 1") as e:
            _run(p, "host-heap", window, _rows(200),
                 extra={"parallelism.default": 8})
        msgs[name] = str(e.value)
    assert msgs["port"] == msgs["reference"]


def test_checkpoints_under_host_heap_restore_under_the_default(tmp_path):
    """A checkpoint written under host-heap restores under the default
    placement (snapshots are logical rows, not device buffers), and the
    resumed rows complete the uninterrupted run's."""
    import os

    p = PKGS["port"]
    rows = _rows(3000)
    whole = _run(p, "tpu-slot-table", "sliding", rows)
    ck = str(tmp_path / "ckpt")
    seen = [0]

    def fail(b):
        seen[0] += len(b)
        if seen[0] > 1800:
            raise RuntimeError("injected failure")
        return b

    def job(backend, fn, sink):
        env = p.Env(p.config(**{
            "execution.micro-batch.size": 128, "state.backend": backend,
            "state.checkpoints.dir": ck,
            "execution.checkpointing.every-n-source-batches": 3}))
        (env.from_collection(rows, timestamp_field="t").map(fn, name="f")
         .key_by("key").window(_assigners(p)["sliding"]).sum("v")
         .sink_to(sink))
        return env

    first, second = p.CollectSink(), p.CollectSink()
    with pytest.raises(RuntimeError, match="injected failure"):
        job("host-heap", fail, first).execute("j")
    assert [d for d in os.listdir(ck) if d.startswith("chk-")]
    job("tpu-slot-table", lambda b: b, second).execute(
        "j", restore_from=ck)

    def rows_of(*batches):
        out = {}
        for b in batches:
            for r in b.to_rows():
                out[(r["key"], r["window_start"])] = np.float32(
                    r["sum_v"]).view(np.uint32).item()
        return out

    got = rows_of(first.result(), second.result())
    assert got == rows_of(whole)
