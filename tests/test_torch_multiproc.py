"""BASELINE row 8 on the CPU (``flink_tpu_torch/benchmarks/multiproc.py``,
the port of ``tools/multiproc_smoke.py``): two spawned processes over
gloo (``torch.distributed`` on a free local port), each owning half the
key-group space, at 1<<14 records in batches of 1,024.

- the union of the two processes' committed windows equals the
  reference's one-process run of the same stream (its
  ``MeshSessionEngine`` over 4 devices), and the port's own one-process
  run;
- rows crossed a process boundary, and gloo carried bytes;
- the kill leg: process 1 dies after batch 10; the survivor restores
  only host 1's key-group ranges from its units, replays at most half the
  stream, and the union still equals the reference's run.

Every child runs under its own time limit (``run_row8(timeout=)``), so
no hung process outlives the test. Tolerance: none (the values are
integer-valued float32, their sums exact in any order, compared with
``==``).
"""

import json
import os

from flink_tpu_torch.benchmarks import multiproc as mp
from flink_tpu_torch.state.keygroups import host_key_group_ranges

SHAPE = mp.Shape(1 << 14, batch=1024)


def _reference_run():
    """The reference's one-process run of the row-8 stream."""
    import numpy as np

    from flink_tpu.core.records import KEY_ID_FIELD, RecordBatch
    from flink_tpu.parallel.mesh import make_mesh
    from flink_tpu.parallel.sharded_sessions import MeshSessionEngine
    from flink_tpu.windowing.aggregates import SumAggregate

    eng = MeshSessionEngine(mp.GAP, SumAggregate("v"), make_mesh(mp.LOCAL),
                            capacity_per_shard=1 << 14,
                            max_parallelism=mp.MAXP, max_dispatch_ahead=2)
    out = {}

    def collect(batches):
        for b in batches:
            for r in b.to_rows():
                out[(int(r[KEY_ID_FIELD]), int(r["window_start"]),
                     int(r["window_end"]))] = float(r["sum_v"])

    for b in range(SHAPE.n_batches()):
        keys, vals, ts, wm = SHAPE.make_batch(b)
        eng.process_batch(RecordBatch.from_pydict(
            {KEY_ID_FIELD: keys, "v": np.asarray(vals, np.float32)},
            timestamps=ts))
        collect(eng.on_watermark(wm))
    collect(eng.on_watermark(mp.FINAL_WM))
    return out


def _committed(path):
    return mp._load(path)[0]


def test_row8_two_processes_over_gloo_equal_the_reference(tmp_path):
    row = mp.run_row8(SHAPE, device="cpu", kill=True, timeout=240,
                      workdir=str(tmp_path))
    art = row["artifacts"]
    want = _reference_run()
    assert len(want) > 1000
    assert _committed(os.path.join(art, "single.json")) == want
    union = mp._merge([_committed(os.path.join(art, f"pod-{i}.json"))
                       for i in range(2)])
    assert union == want
    kill_union = mp._merge([_committed(os.path.join(art, f"kill-{i}.json"))
                            for i in range(2)])
    assert kill_union == want
    assert row["cross_host_rows"] > 0 and row["intra_host_rows"] > 0
    assert row["cross_host_rows"] + row["intra_host_rows"] == SHAPE.records
    assert row["gloo_bytes_sent"] > 0
    assert row["batches_per_process"] == SHAPE.n_batches()
    # the survivor restored only the dead host's ranges
    g0, g1 = host_key_group_ranges(2, 4, mp.MAXP)[1]
    assert row["kill_restored_units"] == 4
    assert all(g0 <= a and b <= g1 for a, b in row["kill_restored_ranges"])
    assert 0 < row["kill_replayed"] <= SHAPE.records // 2
    json.dumps(row)  # the printed row is plain JSON
