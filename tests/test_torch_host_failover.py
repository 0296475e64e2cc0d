"""Host-granular failure domains of the port against the reference
(``tests/test_host_failover.py``), on the CPU: the watchdog's host level,
multi-shard evacuation (``lose_shards``) and the end-to-end host loss —
a lost HOST (one process's contiguous slice of shards) is "lose k shard
units, restore k units, replay one contiguous range".

- The escalation ladder: the same sections under an injected clock give
  the same error (host, shard or stall), quarantine and counters in both
  packages.
- ``lose_shards`` over one host's slice: the dead range and the survivors
  equal the reference's; the stale 2x4 factorization drops.
- ``run_shard_loss_verify`` with the ``host.lost`` point on the session
  and window engines (a 2x4 topology): not diverged, one host and four
  shards lost, the signature and the committed windows equal the
  reference's, seed-deterministic; a loss before the first checkpoint
  replays cold.
- Units the reference's 2x4 engine wrote restore host 1's ranges alone
  into the port's engine (``convert.from_jax_checkpoint_state``), which
  then finishes with the reference's rows.

Inputs come from numpy seeds. Tolerance: none (floats on their bits).
"""

import numpy as np
import pytest

import flink_tpu.chaos.harness as jharness
import flink_tpu.parallel.mesh as jmesh
from flink_tpu.chaos import injection as jchaos
from flink_tpu.core.records import RecordBatch as JRecordBatch
from flink_tpu.runtime import watchdog as jwd
from flink_tpu.windowing import aggregates as jagg
from flink_tpu_torch.chaos import harness as tharness
from flink_tpu_torch.chaos import injection as tchaos
from flink_tpu_torch.core.records import KEY_ID_FIELD, RecordBatch
from flink_tpu_torch.parallel.mesh import HostTopology, make_mesh
from flink_tpu_torch.runtime import watchdog as twd
from flink_tpu_torch.windowing import aggregates as tagg

GAP = 100
_U = {4: np.uint32, 8: np.uint64}


def _bits(a):
    a = np.asarray(a)
    return a.view(_U[a.dtype.itemsize]) if a.dtype.kind == "f" else a


def _steps(n_steps=8, per_step=800, num_keys=3000, seed=17):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_steps):
        keys = rng.integers(0, num_keys, per_step).astype(np.int64)
        vals = rng.random(per_step).astype(np.float32)
        ts = rng.integers(s * 80, s * 80 + 60, per_step).astype(np.int64)
        out.append((keys, vals, ts, (s - 1) * 80))
    return out


def _batch(cls, keys, vals, ts):
    return cls.from_pydict({KEY_ID_FIELD: np.asarray(keys, dtype=np.int64),
                            "v": np.asarray(vals, dtype=np.float32)},
                           timestamps=np.asarray(ts, dtype=np.int64))


def _session_engine(pkg, slots=1024):
    if pkg == "ref":
        from flink_tpu.parallel.sharded_sessions import MeshSessionEngine

        return MeshSessionEngine(
            GAP, jagg.SumAggregate("v"), jmesh.make_mesh(8),
            capacity_per_shard=1 << 14, max_device_slots=slots,
            max_dispatch_ahead=2, host_topology=jmesh.HostTopology(2, 4))
    from flink_tpu_torch.parallel.sharded_sessions import MeshSessionEngine

    return MeshSessionEngine(
        GAP, tagg.SumAggregate("v"), make_mesh(8, "cpu"),
        capacity_per_shard=1 << 14, max_device_slots=slots,
        max_dispatch_ahead=2, host_topology=HostTopology(2, 4))


def _session_oracle(pkg):
    if pkg == "ref":
        from flink_tpu.windowing.sessions import SessionWindower

        return SessionWindower(GAP, jagg.SumAggregate("v"), capacity=1 << 15)
    from flink_tpu_torch.windowing.sessions import SessionWindower

    return SessionWindower(GAP, tagg.SumAggregate("v"), capacity=1 << 15,
                           spill={"device": "cpu"})


def _window_engine(pkg):
    if pkg == "ref":
        from flink_tpu.parallel.sharded_windower import MeshWindowEngine
        from flink_tpu.windowing.assigners import TumblingEventTimeWindows

        return MeshWindowEngine(TumblingEventTimeWindows.of(50),
                                jagg.SumAggregate("v"), jmesh.make_mesh(8),
                                capacity_per_shard=1 << 14,
                                host_topology=jmesh.HostTopology(2, 4))
    from flink_tpu_torch.parallel.sharded_windower import MeshWindowEngine
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

    return MeshWindowEngine(TumblingEventTimeWindows.of(50),
                            tagg.SumAggregate("v"), make_mesh(8, "cpu"),
                            capacity_per_shard=1 << 14,
                            host_topology=HostTopology(2, 4))


def _window_oracle(pkg):
    if pkg == "ref":
        from flink_tpu.windowing.assigners import TumblingEventTimeWindows
        from flink_tpu.windowing.windower import SliceSharedWindower

        return SliceSharedWindower(TumblingEventTimeWindows.of(50),
                                   jagg.SumAggregate("v"), capacity=1 << 15)
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows
    from flink_tpu_torch.windowing.windower import SliceSharedWindower

    return SliceSharedWindower(TumblingEventTimeWindows.of(50),
                               tagg.SumAggregate("v"), capacity=1 << 15,
                               spill={"device": "cpu"})


# ---------------------------------------------------------- the ladder


def _ladder(pkg, misses, hosts=2, local=2):
    """Run ``misses`` (rounds of {shard or -1: seconds}) through a
    watchdog with a 2x2 topology: the error of the probe (its class name
    and attribution), the quarantine and the counters."""
    wd_mod, mesh_mod = (twd, __import__("flink_tpu_torch.parallel.mesh",
                                        fromlist=["x"])) \
        if pkg == "port" else (jwd, jmesh)
    t = [0.0]
    wd = wd_mod.DeviceWatchdog(hosts * local, deadline_ms=10, max_misses=2,
                               clock=lambda: t[0])
    wd.set_topology(mesh_mod.HostTopology(hosts, local))
    for rnd in misses:
        for shard, secs in rnd.items():
            with wd.section("op", shard=shard):
                t[0] += secs
    try:
        wd.boundary_probe()
        err = None
    except Exception as e:  # noqa: BLE001 - compared by kind
        err = (type(e).__name__, getattr(e, "host", None),
               getattr(e, "shards", None), getattr(e, "shard", None))
    return (err, sorted(wd.quarantined), wd.hosts_declared_dead,
            wd.declared_dead)


@pytest.mark.parametrize("misses,kind", [
    # only host 1's shards (2, 3) miss: the host is declared
    ([{2: .05, 3: .05, 0: .001, 1: .001}] * 2, "HostFailedError"),
    # one of host 1's shards misses: a wedged shard, not a lost process
    ([{3: .05, 0: .001, 1: .001, 2: .001}] * 2, "ShardFailedError"),
    # host 0 and half of host 1: mixed attribution stays per shard
    ([{0: .05, 1: .05, 2: .05, 3: .001}] * 2, "ShardFailedError"),
    # every live shard (whole-mesh sections): a stall, no host
    ([{-1: .05}] * 2, "MeshStalledError"),
], ids=["uniform-host", "one-shard", "spills-over", "whole-mesh"])
def test_escalation_ladder_equals_the_references(misses, kind):
    got, want = _ladder("port", misses), _ladder("ref", misses)
    assert got == want
    assert got[0][0] == kind
    if kind == "HostFailedError":
        assert got[0][1:3] == (1, (2, 3)) and got[1] == [2, 3]
        assert got[2] == 1


def test_host_lost_point_declares_the_host():
    out = {}
    for pkg, wd_mod, chaos, topo in (
            ("port", twd, tchaos, HostTopology(2, 4)),
            ("ref", jwd, jchaos, jmesh.HostTopology(2, 4))):
        wd = wd_mod.DeviceWatchdog(8)
        wd.set_topology(topo)
        plan = chaos.FaultPlan(rules=[chaos.FaultRule(
            pattern="host.lost", nth=2, where={"host": 1})])
        seen = []
        with chaos.chaos_active(plan, seed=3) as ctl:
            for _ in range(4):
                try:
                    wd.boundary_probe()
                    seen.append("ok")
                except wd_mod.HostFailedError as e:
                    seen.append((e.host, e.shards))
            hits = dict(ctl.points_hit)
        out[pkg] = (seen, hits, sorted(wd.quarantined),
                    wd.hosts_declared_dead)
    assert out["port"] == out["ref"]
    assert out["port"][0] == ["ok", (1, (4, 5, 6, 7)), "ok", "ok"]


def test_rebind_to_a_new_size_clears_the_stale_topology():
    wd = twd.DeviceWatchdog(4)
    wd.set_topology(HostTopology(2, 2))
    wd.rebind(3)
    assert wd._topology is None
    with pytest.raises(ValueError, match="does not cover"):
        twd.DeviceWatchdog(4).set_topology(HostTopology(2, 4))
    assert twd.DeviceWatchdog(4).counters()["hosts_declared_dead"] == 0


# ------------------------------------------------------------ evacuation


def test_lose_shards_refuses_a_noncontiguous_or_whole_mesh_loss():
    eng = _session_engine("port")
    with pytest.raises(ValueError, match="contiguous"):
        eng.lose_shards([1, 3])
    with pytest.raises(ValueError, match="whole mesh"):
        eng.lose_shards(list(range(8)))


def test_a_host_slice_evacuates_in_one_pass_as_the_references():
    steps = _steps(n_steps=3)
    out = {}
    for pkg, cls in (("port", RecordBatch), ("ref", JRecordBatch)):
        eng = _session_engine(pkg)
        for keys, vals, ts, wm in steps:
            eng.process_batch(_batch(cls, keys, vals, ts))
            eng.on_watermark(wm)
        dead = list(eng.host_topology.shards_of_host(1))
        ranges = eng.shard_key_groups()
        rng = eng.lose_shards(dead)
        assert rng == (ranges[dead[0]][0], ranges[dead[-1]][1])
        assert eng.P == 4 and eng.host_topology is None
        info = eng.last_shard_loss
        out[pkg] = (tuple(rng), list(info["dead_shards"]),
                    int(info["survivor_rows"]))
    assert out["port"] == out["ref"]
    assert out["port"][2] > 0


# ----------------------------------------------------- end-to-end loss


def _ref_report(mk, mo, steps, plan, root, **kw):
    """The reference's report and committed output (read where its
    harness hands it to the diff)."""
    seen = {}
    diff = jharness._diff

    def spy(expected, got, *a, **k):
        seen["committed"] = dict(got)
        return diff(expected, got, *a, **k)

    jharness._diff = spy
    try:
        rep = jharness.run_shard_loss_verify(mk, mo, steps, plan, **kw,
                                             ckpt_root=root)
    finally:
        jharness._diff = diff
    return rep, seen["committed"]


def _plan(chaos, nth=6):
    return chaos.FaultPlan(rules=[chaos.FaultRule(
        pattern="host.lost", nth=nth, where={"host": 1})])


def _both(tmp_path, make, oracle, steps, nth=6, seed=7, every=2):
    got = tharness.run_shard_loss_verify(
        lambda: make("port"), lambda: oracle("port"), steps,
        _plan(tchaos, nth), seed=seed, ckpt_root=str(tmp_path / "port"),
        checkpoint_every=every)
    want, want_committed = _ref_report(
        lambda: make("ref"), lambda: oracle("ref"), steps,
        _plan(jchaos, nth), str(tmp_path / "ref"), seed=seed,
        checkpoint_every=every)
    assert got.signature() == want.signature()
    assert got.committed == want_committed
    return got


def test_session_engine_host_loss(tmp_path):
    rep = _both(tmp_path, _session_engine, _session_oracle, _steps())
    assert not rep.diverged
    assert rep.hosts_lost == 1 and rep.shards_lost == 4
    assert rep.shard_restores == 1
    # bounded replay: one of two hosts, since its units' position
    assert 0 < rep.records_replayed <= rep.events // 2


def test_host_loss_with_forced_eviction(tmp_path):
    holder = {}

    def make(pkg):
        holder[pkg] = _session_engine(pkg, slots=1024)
        return holder[pkg]

    rep = _both(tmp_path, make, _session_oracle,
                _steps(num_keys=9000, per_step=2000))
    assert not rep.diverged and rep.hosts_lost == 1
    assert holder["port"].spill_counters()["rows_evicted"] > 0


def test_host_loss_signature_is_seed_deterministic(tmp_path):
    sigs = [tharness.run_shard_loss_verify(
        lambda: _session_engine("port"), lambda: _session_oracle("port"),
        _steps(), _plan(tchaos), seed=7,
        ckpt_root=str(tmp_path / f"c{i}"), checkpoint_every=2).signature()
        for i in range(2)]
    assert sigs[0] == sigs[1] and sigs[0]["hosts_lost"] == 1


def test_window_engine_host_loss(tmp_path):
    rep = _both(tmp_path, _window_engine, _window_oracle, _steps(), seed=11)
    assert not rep.diverged
    assert rep.hosts_lost == 1 and rep.shards_lost == 4


def test_host_loss_before_the_first_checkpoint_replays_cold(tmp_path):
    rep = _both(tmp_path, _session_engine, _session_oracle, _steps(),
                nth=2, every=4)
    assert not rep.diverged and rep.hosts_lost == 1


# ------------------------------------------- units across the packages


def test_reference_units_restore_one_host_into_the_port(tmp_path):
    """The reference's 2x4 session engine writes per-shard units; the
    port's engine, fed the same stream except host 1's records, restores
    host 1's ranges alone from those units (read through the reference's
    storage, converted by ``from_jax_checkpoint_state``) and finishes
    with the reference's rows bit for bit (host 1's sessions that fired
    before the cut fired in the reference only)."""
    from flink_tpu.checkpoint.sharded import ShardedCheckpointStorage
    from flink_tpu.state.keygroups import (
        assign_key_groups,
        host_key_group_ranges,
    )
    from flink_tpu_torch.convert import from_jax_checkpoint_state

    steps = _steps(n_steps=6)
    cut = 4
    g0, g1 = host_key_group_ranges(2, 4, 128)[1]

    def host1(batches):
        return [b.filter(~((assign_key_groups(b[KEY_ID_FIELD], 128) >= g0)
                           & (assign_key_groups(b[KEY_ID_FIELD], 128)
                              <= g1))) for b in batches]

    ref = _session_engine("ref")
    fired_ref = []
    for i, (keys, vals, ts, wm) in enumerate(steps):
        if i == cut:
            storage = ShardedCheckpointStorage(str(tmp_path / "units"))
            units = ref.snapshot_sharded()
            storage.write_checkpoint(1, "host-units", units,
                                     positions={r: cut for r in units})
        ref.process_batch(_batch(JRecordBatch, keys, vals, ts))
        out = ref.on_watermark(wm)
        fired_ref.extend(host1(out) if i < cut else out)
    fired_ref.extend(ref.on_watermark(1 << 40))

    port = _session_engine("port")
    fired = []
    for i, (keys, vals, ts, wm) in enumerate(steps):
        if i == cut:
            found = ShardedCheckpointStorage(
                str(tmp_path / "units")).latest_units_for_groups(
                range(g0, g1 + 1))
            _cid, states, pos = found
            assert pos == cut
            restored = port.restore_key_groups(
                port.merge_unit_snapshots(
                    [from_jax_checkpoint_state(s) for s in states]),
                range(g0, g1 + 1))
            assert restored > 0
        elif i < cut:
            # before the cut, host 1's records never reach the port
            kg = assign_key_groups(keys, 128)
            keep = (kg < g0) | (kg > g1)
            keys, vals, ts = keys[keep], vals[keep], ts[keep]
        port.process_batch(_batch(RecordBatch, keys, vals, ts))
        fired.extend(port.on_watermark(wm))
    fired.extend(port.on_watermark(1 << 40))

    def rows(batches):
        return sorted((int(k), int(s), int(e), _bits(np.float32(v)).item())
                      for b in batches
                      for k, s, e, v in zip(b[KEY_ID_FIELD].tolist(),
                                            b["window_start"].tolist(),
                                            b["window_end"].tolist(),
                                            np.asarray(b["sum_v"]).tolist()))

    got, want = rows(fired), rows(fired_ref)
    assert got == want and len(got) > 500
