"""BASELINE row 8: the mesh-sessions job in two processes over one
key-group space (port of ``tools/multiproc_smoke.py`` and
``tools/bench_suite.py`` ``row8_mesh_sessions_2proc``).

    python3 -m flink_tpu_torch.benchmarks.multiproc [--records N]
        [--device cuda|cpu] [--no-kill] [--timeout S]

The shape: 2 processes x 4 logical shards, sessions with gap 40, float32
``sum(v)``, keys uniform over records/3, batches of 4,096, seed 23. Each
process owns half the key-group space (``host_key_group_ranges``) with
its own session engine (metadata plane, spill tier, checkpoint units)
and routes the records it reads to their owner through
``parallel/pod.PodDataPlane``: the rank and the bucketing on its device,
the exchange between the processes over gloo (``torch.distributed``;
both processes may share one card). Every batch is regenerated from the
seed by whichever process needs it: process 0 reads the first half of
each global batch, process 1 the second.

Gates (a failed gate raises :class:`Row8Failure`; the command exits 1):

- the union of both processes' committed windows equals the one-process
  run of the same stream, bit for bit;
- more than 0 rows crossed a process boundary;
- the kill leg: process 1 dies after a mid-stream batch (with an
  uncommitted epoch in flight); the survivor restores ONLY the dead
  host's key-group ranges from ITS checkpoint units, replays only that
  range's records since them (at most half the stream) and the union
  still equals the one-process run.

Prints one JSON object: aggregate events/s of the two processes, the
one-process events/s (run in the parent), rows crossed, bytes handed to
gloo and the route's milliseconds a batch. The two pod processes run the
measured run and then the kill leg, under one time limit, and are killed
past it. The device defaults to the card (``execution.device``); the
children resolve ``--device`` as the parent does.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

GAP = 40
SPAN = 80
MAXP = 128
HOSTS, LOCAL = 2, 4
FINAL_WM = 1 << 60
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Row8Failure(RuntimeError):
    """A gate of row 8 failed."""


class Shape:
    """The stream: every batch is regenerable by any process from the
    seed (the replay path depends on it)."""

    def __init__(self, records: int, batch: int = 4096,
                 keys: Optional[int] = None, seed: int = 23,
                 slots: int = 0, ckpt_every: int = 4) -> None:
        self.records = int(records)
        self.batch = int(batch)
        self.keys = int(keys or max(self.records // 3, 64))
        self.seed = int(seed)
        self.slots = int(slots)
        self.ckpt_every = int(ckpt_every)

    def n_batches(self) -> int:
        return -(-self.records // self.batch)

    def make_batch(self, b: int):
        import numpy as np

        rng = np.random.default_rng(self.seed * 1_000_003 + b)
        n = min(self.batch, self.records - b * self.batch)
        keys = rng.integers(0, self.keys, n).astype(np.int64)
        vals = rng.integers(0, 1000, n).astype(np.float32)
        ts = rng.integers(b * SPAN, b * SPAN + 60, n).astype(np.int64)
        return keys, vals, ts, (b - 1) * SPAN

    def as_args(self) -> List[str]:
        return ["--records", str(self.records), "--batch", str(self.batch),
                "--keys", str(self.keys), "--seed", str(self.seed),
                "--slots", str(self.slots),
                "--ckpt-every", str(self.ckpt_every)]


def _keyed(keys, vals, ts):
    import numpy as np

    from flink_tpu_torch.core.records import KEY_ID_FIELD, RecordBatch

    return RecordBatch.from_pydict(
        {KEY_ID_FIELD: np.asarray(keys, dtype=np.int64),
         "v": np.asarray(vals, dtype=np.float32)},
        timestamps=np.asarray(ts, dtype=np.int64))


def _collect(batches, into: Dict[Tuple[int, int, int], float]) -> None:
    from flink_tpu_torch.core.records import KEY_ID_FIELD

    for b in batches:
        if b is None or len(b) == 0:
            continue
        for k, s, e, v in zip(b[KEY_ID_FIELD].tolist(),
                              b["window_start"].tolist(),
                              b["window_end"].tolist(),
                              b["sum_v"].tolist()):
            into[(int(k), int(s), int(e))] = float(v)


def _append(path: str, cells, **extra) -> None:
    """Append one JSON line: the windows ``cells`` committed since the last
    line, and ``extra``. Appending keeps a checkpoint's cost to its own
    epoch (rewriting the whole committed set each time grows with the
    run), and a process that dies leaves the lines of its checkpoints."""
    with open(path, "a") as f:
        f.write(json.dumps({"committed": [[k[0], k[1], k[2], v]
                                          for k, v in cells.items()],
                            **extra}) + "\n")


def _load(path: str):
    """(every committed window of the file's lines, the last line's other
    keys)."""
    committed: Dict = {}
    meta: Dict = {}
    with open(path) as f:
        for line in f:
            d = json.loads(line)
            committed.update({(k, a, b): v for k, a, b, v in d["committed"]})
            meta = d
    return committed, meta


def _mk_engine(shape: Shape, device: str, key_group_range=None):
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_sessions import MeshSessionEngine
    from flink_tpu_torch.windowing.aggregates import SumAggregate

    return MeshSessionEngine(
        GAP, SumAggregate("v"), make_mesh(LOCAL, device),
        capacity_per_shard=1 << 14, max_device_slots=shape.slots,
        max_parallelism=MAXP, key_group_range=key_group_range,
        max_dispatch_ahead=2)


def _warm_batches(shape: Shape) -> int:
    """The warm-up run's batches (kernel loads, the allocator, the
    engines' first buckets): the stream's first sixteenth, at least 4."""
    return min(shape.n_batches(), max(shape.n_batches() // 16, 4))


def _sync(device: str) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------- children


def run_single(shape: Shape, device: str, out_path: str) -> None:
    """The one-process run: the whole stream through one 4-shard engine —
    the gates' oracle and the scaling row's denominator. A warm-up run
    over the stream's start first (``_warm_batches``), then the measured
    one."""

    def rep(batches: int):
        committed: Dict = {}
        eng = _mk_engine(shape, device)
        for b in range(batches):
            keys, vals, ts, wm = shape.make_batch(b)
            eng.process_batch(_keyed(keys, vals, ts))
            _collect(eng.on_watermark(wm), committed)
        _collect(eng.on_watermark(FINAL_WM), committed)
        _sync(device)
        return committed

    rep(_warm_batches(shape))
    t0 = time.perf_counter()
    committed = rep(shape.n_batches())
    _append(out_path, committed, wall_s=time.perf_counter() - t0,
            events=shape.records)


def run_pod(shape: Shape, device: str, pid: int, port: int,
            out_path: str, ckpt_root: str, kill_at: int = 0,
            kill_out: Optional[str] = None) -> None:
    """One pod process: owns ``host_key_group_ranges[pid]``, routes the
    rest through the pod plane, commits per checkpoint epoch: a warm-up
    run over the stream's start, then the measured run into ``out_path``.
    With ``kill_at`` > 0 the same processes then run the kill leg into
    ``kill_out``: process 1 dies after batch ``kill_at``; process 0 takes
    over the dead host's ranges."""
    import numpy as np
    import torch.distributed as dist

    from flink_tpu_torch.checkpoint.sharded import ShardedCheckpointStorage
    from flink_tpu_torch.parallel.mesh import (
        HostTopology,
        initialize_distributed,
    )
    from flink_tpu_torch.parallel.pod import PodDataPlane
    from flink_tpu_torch.state.keygroups import (
        assign_key_groups,
        host_key_group_ranges,
        host_of_key_group,
    )

    initialize_distributed(f"localhost:{port}", HOSTS, pid)
    topo = HostTopology(HOSTS, LOCAL)
    ranges = host_key_group_ranges(HOSTS, LOCAL, MAXP)

    def owners_of(keys):
        return host_of_key_group(assign_key_groups(keys, MAXP), HOSTS,
                                 LOCAL, MAXP)

    def rep(batches: int, root: Optional[str] = None,
            out: Optional[str] = None, chaos: bool = False):
        """One run over the first ``batches`` batches; with ``root`` it
        checkpoints there and appends each committed epoch to ``out``."""
        committed: Dict = {}
        epoch: Dict = {}
        eng = _mk_engine(shape, device, ranges[pid])
        plane = PodDataPlane(topo, dtypes=[np.int64, np.int64, np.float32],
                             max_parallelism=MAXP, device=device)
        storage = (ShardedCheckpointStorage(os.path.join(root, f"host-{pid}"))
                   if root else None)
        tombstone = os.path.join(root, "host-1.dead") if root else None
        evac = None
        replayed = restored_units = 0
        restored_ranges: List = []
        cid = 0

        def checkpoint(b: int) -> None:
            nonlocal cid, epoch
            if storage is not None and (b + 1) % shape.ckpt_every == 0:
                cid += 1
                units = eng.snapshot_sharded()
                storage.write_checkpoint(
                    cid, f"pod-host-{pid}", units,
                    positions={r: b + 1 for r in units})
                committed.update(epoch)
                _append(out, epoch, final=False)
                epoch = {}

        for b in range(batches):
            keys, vals, ts, wm = shape.make_batch(b)
            if chaos and b > kill_at:
                if evac is None:
                    # the death notice (the deterministic schedule stands
                    # in for a heartbeat timeout): restore ONLY the dead
                    # host's ranges from ITS units, replay only its
                    # records since them
                    for _ in range(600):
                        if os.path.exists(tombstone):
                            break
                        time.sleep(0.05)
                    if not os.path.exists(tombstone):
                        raise Row8Failure(
                            "the peer never wrote its death marker")
                    found = ShardedCheckpointStorage(os.path.join(
                        root, "host-1")).read_all_units_with_fallback()
                    evac = _mk_engine(shape, device, ranges[1])
                    unit_pos = 0
                    if found is not None:
                        _newest, units, _skipped = found
                        for r, _s, _p in units:
                            if not (ranges[1][0] <= r[0]
                                    and r[1] <= ranges[1][1]):
                                raise Row8Failure(
                                    f"unit {r} outside the dead range "
                                    f"{ranges[1]}")
                        evac.restore(evac.merge_unit_snapshots(
                            [s for _r, s, _p in units]))
                        restored_units = len(units)
                        restored_ranges = [list(r) for r, _s, _p in units]
                        unit_pos = min(p for _r, _s, p in units)
                    for rb in range(unit_pos, kill_at + 1):
                        rk, rv, rt, rwm = shape.make_batch(rb)
                        mask = owners_of(rk) == 1
                        if mask.any():
                            evac.process_batch(_keyed(
                                rk[mask], rv[mask], rt[mask]))
                            replayed += int(mask.sum())
                        _collect(evac.on_watermark(rwm), epoch)
                # the survivor owns everything now: it reads the whole
                # batch and routes on the host (the peer is gone)
                own = owners_of(keys)
                for m, e in ((own == 0, eng), (own == 1, evac)):
                    if m.any():
                        e.process_batch(_keyed(keys[m], vals[m], ts[m]))
                _collect(eng.on_watermark(wm), epoch)
                _collect(evac.on_watermark(wm), epoch)
            else:
                n = len(keys)
                sl = slice(0, n // 2) if pid == 0 else slice(n // 2, n)
                sub_k, sub_v, sub_t = keys[sl], vals[sl], ts[sl]
                # both processes know the global split: the chunk bound
                # is deterministic, no agree step per batch
                arrivals = plane.exchange(
                    owners_of(sub_k), [sub_k, sub_t, sub_v],
                    chunk_bound=-(-(n - n // 2) // LOCAL))
                ak, at, av = arrivals[plane.my_host]
                if len(ak):
                    eng.process_batch(_keyed(ak, av, at))
                _collect(eng.on_watermark(wm), epoch)
            checkpoint(b)
            if chaos and pid == 1 and b == kill_at:
                # die mid-stream, after the batch's exchange, with an
                # uncommitted epoch in flight and no final flush
                with open(tombstone, "w") as f:
                    f.write(str(b))
                _append(out, {}, final=False, died_at=b)
                os._exit(0)
        _collect(eng.on_watermark(FINAL_WM), epoch)
        if evac is not None:
            _collect(evac.on_watermark(FINAL_WM), epoch)
        committed.update(epoch)
        if out is not None:
            _append(out, epoch, final=False)
        _sync(device)
        return plane, {"replayed": replayed,
                       "restored_units": restored_units,
                       "restored_ranges": restored_ranges}

    rep(_warm_batches(shape))
    dist.barrier()
    t0 = time.perf_counter()
    run_root = os.path.join(ckpt_root, "run")
    os.makedirs(run_root, exist_ok=True)
    plane, _ = rep(shape.n_batches(), run_root, out_path)
    wall = time.perf_counter() - t0
    _append(out_path, {}, final=True, wall_s=wall,
            events=shape.records, cross_rows=plane.rows_cross_host,
            intra_rows=plane.rows_intra_host, bytes_sent=plane.bytes_sent,
            route_ms_per_batch=plane.route_s * 1e3 / max(plane.batches, 1),
            batches=plane.batches)
    dist.barrier()
    if kill_at:
        kill_root = os.path.join(ckpt_root, "kill")
        os.makedirs(kill_root, exist_ok=True)
        plane, info = rep(shape.n_batches(), kill_root, kill_out,
                          chaos=True)
        _append(kill_out, {}, final=True, events=shape.records,
                cross_rows=plane.rows_cross_host, **info)
        # the peer is dead: leave without the process group's teardown
        os._exit(0)
    dist.destroy_process_group()


# ------------------------------------------------------------------ parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(args: List[str]) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + (os.pathsep + env["PYTHONPATH"]
                                 if env.get("PYTHONPATH") else "")
    return subprocess.Popen(
        [sys.executable, "-m", "flink_tpu_torch.benchmarks.multiproc",
         *args], env=env, cwd=_REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _wait(procs, names, timeout: float) -> None:
    """Join every child, each within the time limit; a child past it or
    failing kills the rest and raises."""
    deadline = time.time() + timeout
    try:
        for p, name in zip(procs, names):
            try:
                out, _ = p.communicate(
                    timeout=max(deadline - time.time(), 1))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                raise Row8Failure(f"{name} timed out after {timeout} s\n"
                                  + out.decode()[-2000:])
            if p.returncode != 0:
                raise Row8Failure(f"{name} failed (rc={p.returncode})\n"
                                  + out.decode()[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _merge(parts) -> Dict:
    merged: Dict = {}
    for part in parts:
        for k, v in part.items():
            if k in merged and merged[k] != v:
                raise Row8Failure(f"conflicting committed cell {k}: "
                                  f"{merged[k]} vs {v}")
            merged[k] = v
    return merged


def _check_equal(got: Dict, want: Dict, what: str) -> None:
    if got != want:
        missing = set(want) - set(got)
        extra = set(got) - set(want)
        wrong = [k for k in got if k in want and got[k] != want[k]]
        raise Row8Failure(
            f"{what} diverged from the one-process run ({len(missing)} "
            f"missing, {len(extra)} extra, {len(wrong)} wrong; e.g. "
            f"{(list(missing) + list(extra) + wrong)[:3]})")


def run_row8(shape: Shape, device: str = "cuda", kill: bool = True,
             timeout: float = 600.0, workdir: Optional[str] = None
             ) -> Dict[str, object]:
    """Run row 8 and hold it to its gates; the row's numbers as a dict.
    The one-process run runs here; the two pod processes are children,
    which run the measured run and then, with ``kill``, the kill leg."""
    if workdir is None:
        with tempfile.TemporaryDirectory(prefix="row8_") as tmp:
            row = run_row8(shape, device, kill, timeout, tmp)
        row.pop("artifacts")
        return row
    tmp = tempfile.mkdtemp(prefix="row8_", dir=workdir)
    kill_at = 0
    if kill:
        kill_at = max(shape.n_batches() * 2 // 3, shape.ckpt_every + 1)
        if kill_at >= shape.n_batches() - 1:
            raise Row8Failure(
                f"{shape.n_batches()} batches cannot host a mid-stream "
                f"kill at {kill_at}: raise --records or lower --batch")
    single_out = os.path.join(tmp, "single.json")
    run_single(shape, device, single_out)
    oracle, single = _load(single_out)
    port = _free_port()
    outs = [os.path.join(tmp, f"pod-{i}.json") for i in range(HOSTS)]
    kill_outs = [os.path.join(tmp, f"kill-{i}.json") for i in range(HOSTS)]
    procs = [_spawn(["--role", "pod", "--pid", str(i), "--port", str(port),
                     "--out", outs[i], "--kill-out", kill_outs[i],
                     "--ckpt", tmp, "--kill-at", str(kill_at),
                     *shape.as_args(), "--device", device])
             for i in range(HOSTS)]
    _wait(procs, [f"pod-{i}" for i in range(HOSTS)], timeout)
    parts, metas = zip(*[_load(o) for o in outs])
    _check_equal(_merge(parts), oracle, "the two-process union")
    cross = sum(m["cross_rows"] for m in metas)
    if cross == 0:
        raise Row8Failure("vacuous: 0 rows crossed a process boundary")
    wall_2p = max(m["wall_s"] for m in metas)
    row: Dict[str, object] = {
        "metric": "mesh_sessions_2proc_events_per_s",
        "value": shape.records / wall_2p,
        "single_proc_events_per_s": shape.records / single["wall_s"],
        "scaling_x": single["wall_s"] / wall_2p,
        "records": shape.records,
        "cross_host_rows": cross,
        "intra_host_rows": sum(m["intra_rows"] for m in metas),
        "gloo_bytes_sent": sum(m["bytes_sent"] for m in metas),
        "route_ms_per_batch": max(m["route_ms_per_batch"] for m in metas),
        "batches_per_process": metas[0]["batches"],
        "device": device,
        # the runs' committed windows and numbers, one JSON-lines file
        # each (removed with the run's directory unless the caller gave
        # one)
        "artifacts": tmp,
    }
    if kill:
        (surv, smeta), (dead, _dmeta) = [_load(o) for o in kill_outs]
        _check_equal(_merge([dead, surv]), oracle, "the kill leg's union")
        if smeta["restored_units"] < 1:
            raise Row8Failure("the survivor restored no checkpoint unit")
        if not 0 < smeta["replayed"] <= shape.records // 2:
            raise Row8Failure(
                f"replay {smeta['replayed']} outside the per-host bound "
                f"(0, {shape.records // 2}]")
        row.update({"kill_at_batch": kill_at,
                    "kill_replayed": smeta["replayed"],
                    "kill_restored_units": smeta["restored_units"],
                    "kill_restored_ranges": smeta["restored_ranges"],
                    "kill_replay_bound": shape.records // 2})
    return row


def _args(argv=None):
    ap = argparse.ArgumentParser(
        description="BASELINE row 8: mesh sessions in two processes")
    ap.add_argument("--records", type=int, default=1 << 18)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--keys", type=int, default=0)
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--slots", type=int, default=0)
    ap.add_argument("--ckpt-every", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-kill", action="store_true")
    ap.add_argument("--timeout", type=float, default=600.0)
    # child roles
    ap.add_argument("--role", default="parent", choices=("parent", "pod"))
    ap.add_argument("--out")
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--ckpt")
    ap.add_argument("--kill-at", type=int, default=0)
    ap.add_argument("--kill-out")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    a = _args(argv)
    shape = Shape(a.records, a.batch, a.keys or None, a.seed, a.slots,
                  a.ckpt_every)
    if a.role == "pod":
        run_pod(shape, a.device, a.pid, a.port, a.out, a.ckpt, a.kill_at,
                a.kill_out)
        return 0
    try:
        row = run_row8(shape, a.device, kill=not a.no_kill,
                       timeout=a.timeout)
    except Row8Failure as e:
        print(f"ROW 8 FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
