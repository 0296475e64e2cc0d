"""Shard-granular failure domains of the port against the reference, on the
CPU: the device watchdog, shard-unit checkpoints, the engines' shard
surgery (reshard, shard loss, unit restore) and the end-to-end
``run_shard_loss_verify`` claim.

- The watchdog: the same sections under an injected clock and the same
  boundary probes give the same counters, streaks, quarantine and errors
  in both packages.
- ``ShardedCheckpointStorage``: round trip, torn-unit fallback and
  retention, and units written by either package restored by the other.
- Engine surgery on the mesh window and session engines (the namespace
  spill layout, the paged layout and no budget): ``shard_key_groups``,
  ``snapshot_sharded`` unit by unit, the survivors' snapshot after
  ``lose_shard``, ``restore_key_groups`` and ``reshard`` 4 -> 3 -> 5 —
  every array equal to the reference's, bit for bit, rows in order.
- ``run_shard_loss_verify`` for the session and window engines (a healthy
  loss, forced eviction, a torn unit, the whole-job crash path, a loss
  before the first checkpoint, seed determinism): the report's signature
  and the committed windows equal the reference's bit for bit (the
  reference's committed output is read where it hands it to its diff).
- The joins' and CEP's units and ``restore(key_group_filter=)``, and the
  executor's watchdog wiring.

Inputs come from numpy seeds. Tolerance: none.
"""

import numpy as np
import pytest

import flink_tpu.chaos.harness as jharness
from flink_tpu.chaos import injection as jchaos
from flink_tpu.checkpoint.sharded import (
    ShardedCheckpointStorage as JStorage,
)
from flink_tpu.parallel.mesh import make_mesh as jmake_mesh
from flink_tpu.runtime import watchdog as jwd
from flink_tpu.state.keygroups import (
    shard_key_group_ranges as jranges,
)
from flink_tpu_torch.chaos import harness as tharness
from flink_tpu_torch.chaos import injection as tchaos
from flink_tpu_torch.checkpoint.sharded import (
    ShardedCheckpointStorage as TStorage,
)
from flink_tpu_torch.parallel.mesh import make_mesh
from flink_tpu_torch.parallel.shuffle import shard_records
from flink_tpu_torch.runtime import watchdog as twd
from flink_tpu_torch.state.keygroups import assign_key_groups
from tests.test_torch_restore import (
    JBatch,
    JMeshS,
    JMeshW,
    TBatch,
    TMeshS,
    TMeshW,
    assert_state_equal,
    jagg,
    jasg,
    tagg,
    tasg,
)

GAP = 100
PKGS = {"ref": (jwd, jchaos, JStorage), "port": (twd, tchaos, TStorage)}


def _steps(n_steps=8, per_step=800, num_keys=3000, seed=17):
    """``tools/chaos_smoke.py``'s stream shape at test size."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_steps):
        keys = rng.integers(0, num_keys, per_step).astype(np.int64)
        vals = rng.random(per_step).astype(np.float32)
        ts = rng.integers(s * 80, s * 80 + 60, per_step).astype(np.int64)
        out.append((keys, vals, ts, (s - 1) * 80))
    return out


def _batch(pkg, keys, vals, ts):
    cls = JBatch if pkg == "ref" else TBatch
    return cls.from_pydict({"__key_id__": keys, "v": vals}, timestamps=ts)


# ---------------------------------------------------------------- engines

#: kind -> (shards, per-shard budget, layout): the session engine paged
#: (the chaos shape) and without a budget, the window engine under the
#: namespace spill layout and without a budget
ENGINES = {
    "sessions_paged": ("sessions", 1024),
    "sessions_unbudgeted": ("sessions", 0),
    "window_spill": ("window", 1024),
    "window_unbudgeted": ("window", 0),
    "window_tumbling": ("tumbling", 0),
}


def make_engine(kind, pkg, shards=4):
    family, budget = ENGINES[kind]
    ref = pkg == "ref"
    agg = (jagg if ref else tagg).SumAggregate("v")
    mesh = jmake_mesh(shards) if ref else make_mesh(shards, "cpu")
    kw = {"max_device_slots": budget} if budget else {}
    if family == "sessions":
        return (JMeshS if ref else TMeshS)(
            GAP, agg, mesh, capacity_per_shard=1 << 14 if budget else 1024,
            max_dispatch_ahead=2, **kw)
    asgs = jasg if ref else tasg
    asg = (asgs.TumblingEventTimeWindows.of(100) if family == "tumbling"
           else asgs.SlidingEventTimeWindows.of(300, 100))
    return (JMeshW if ref else TMeshW)(asg, agg, mesh,
                                      capacity_per_shard=1024, **kw)


def _feed(eng, pkg, steps):
    out = []
    for keys, vals, ts, wm in steps:
        eng.process_batch(_batch(pkg, keys, vals, ts))
        for b in eng.on_watermark(int(wm)):
            if hasattr(b, "harvest"):
                b = b.harvest()
            if b is not None and len(b):
                out.append(b)
    return out


def _stream(kind):
    if kind == "sessions_paged":
        # past the 4 x 1024 rows: paged eviction on the path
        return _steps(n_steps=8, per_step=1500, num_keys=6000)
    if kind == "window_spill":
        # past the 4 x 1024 rows: slices leave for the spill tier
        return _steps(n_steps=8, per_step=2000, num_keys=12000)
    return _steps(n_steps=8, per_step=600, num_keys=2500)


def _fired_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_state_equal(dict(g.columns), dict(w.columns), "fired")


def _pair(kind, steps, shards=4):
    j, t = make_engine(kind, "ref", shards), make_engine(kind, "port",
                                                         shards)
    _fired_equal(_feed(t, "port", steps), _feed(j, "ref", steps))
    return j, t


# ---------------------------------------------------------------- watchdog


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _sections(pkg, script, deadline_ms=10.0, max_misses=2, shards=4,
              device_ids=None):
    """Run ``script`` (a list of ("section", op, shard, ms) and ("probe",)
    steps) on a watchdog of ``pkg``; returns what each step saw and the
    final counters."""
    wd_mod = PKGS[pkg][0]
    clock = _Clock()
    wd = wd_mod.DeviceWatchdog(shards, deadline_ms=deadline_ms,
                               max_misses=max_misses, clock=clock,
                               device_ids=device_ids)
    seen = []
    for step in script:
        if step[0] == "section":
            _, op, shard, ms = step
            with wd.section(op, shard):
                clock.t += ms / 1e3
            seen.append(dict(wd.misses_by_shard()))
        elif step[0] == "rebind":
            wd.rebind(step[1], step[2])
            seen.append(("rebind", wd.num_shards))
        else:
            try:
                wd.boundary_probe()
                seen.append("ok")
            except Exception as e:  # noqa: BLE001 — compared across pkgs
                seen.append((type(e).__name__, getattr(e, "shard", None),
                             str(e)))
    return seen, (wd.sections_timed, wd.deadline_misses, wd.declared_dead,
                  sorted(wd.quarantined), sorted(wd.quarantined_devices),
                  wd.heartbeat_age_s(), wd.available(8))


WATCHDOG_SCRIPTS = {
    # in-deadline sections heartbeat; a streak declares the shard dead at
    # the boundary only; a good section resets a streak
    "streak_then_death": [
        ("section", "fire_harvest", -1, 1.0), ("probe",),
        ("section", "evict_harvest", 2, 50.0), ("probe",),
        ("section", "evict_harvest", 1, 50.0),
        ("section", "evict_harvest", 1, 2.0),
        ("section", "evict_harvest", 2, 50.0), ("probe",),
        ("section", "fence_drain", 0, 3.0), ("probe",)],
    # every live shard past the budget from whole-mesh sections: a mesh
    # stall, not a loss of shard 0
    "mesh_stall": [
        ("section", "fence_drain", -1, 20.0),
        ("section", "fence_drain", -1, 20.0), ("probe",)],
    # a quarantined shard, then a rebuilt mesh: counters and quarantine
    # history survive the rebind, streaks restart
    "death_then_rebind": [
        ("section", "pending_harvest", 3, 30.0),
        ("section", "pending_harvest", 3, 30.0), ("probe",),
        ("rebind", 3, [10, 11, 12]),
        ("section", "pending_harvest", 1, 30.0), ("probe",),
        ("section", "pending_harvest", 1, 30.0), ("probe",)],
}


@pytest.mark.parametrize("name", sorted(WATCHDOG_SCRIPTS))
def test_watchdog_policy_equals_reference(name):
    script = WATCHDOG_SCRIPTS[name]
    ids = [10, 11, 12, 13]
    j = _sections("ref", script, device_ids=ids)
    t = _sections("port", script, device_ids=ids)
    assert t == j
    errors = [x[:2] for x in t[0] if isinstance(x, tuple)
              and x[0] != "rebind"]
    if name == "streak_then_death":
        # shard 1's streak was reset by its in-deadline section; shard 2
        # dies at the third probe, not at its second miss
        assert t[0][:4] == [{}, "ok", {2: 1}, "ok"]
        assert errors == [("ShardFailedError", 2)]
        assert t[1][3] == [2] and t[1][4] == [12]
    if name == "mesh_stall":
        assert errors == [("MeshStalledError", None)]
    if name == "death_then_rebind":
        assert errors == [("ShardFailedError", 3), ("ShardFailedError", 1)]
        assert t[1][4] == [11, 13]


def test_watchdog_device_lost_fires_once_per_live_shard_at_the_boundary():
    """The ``device.lost`` point, armed with the same plan in both
    packages, kills the same shard at the same probe; a quarantined shard
    is never probed again."""
    out = {}
    for pkg, (wd_mod, chaos_mod, _) in PKGS.items():
        plan = chaos_mod.FaultPlan(rules=[chaos_mod.FaultRule(
            pattern="device.lost", nth=3, where={"shard": 1})])
        wd = wd_mod.DeviceWatchdog(4, device_ids=[0, 1, 2, 3])
        seen = []
        with chaos_mod.chaos_active(plan, 7) as ctl:
            for _ in range(5):
                try:
                    wd.boundary_probe()
                    seen.append("ok")
                except wd_mod.ShardFailedError as e:
                    seen.append(e.shard)
            hits = dict(ctl.points_hit)
        out[pkg] = (seen, hits, sorted(wd.quarantined),
                    sorted(wd.quarantined_devices))
    assert out["port"] == out["ref"]
    assert out["port"][0] == ["ok", "ok", 1, "ok", "ok"]


def test_watchdog_from_config_and_topology():
    from flink_tpu_torch.core.config import Configuration

    assert twd.watchdog_from_config(Configuration(), 8) is None
    wd = twd.watchdog_from_config(Configuration({
        "watchdog.enabled": True, "watchdog.deadline-ms": 7,
        "watchdog.max-misses": 5}), 8)
    assert (wd.num_shards, wd.deadline_ms, wd.max_misses) == (8, 7.0, 5)
    wd.set_topology(None)
    with pytest.raises(NotImplementedError, match="item 12h"):
        wd.set_topology(object())
    # the heartbeat gauges (item 12a) read the watchdog live
    from flink_tpu_torch.metrics import MetricRegistry

    reg = MetricRegistry()
    wd.register_metrics(reg.root_group("job", "j"))
    snap = reg.snapshot()
    assert snap["job.j.watchdog.sections_timed"] == 0
    assert snap["job.j.watchdog.hosts_declared_dead"] == 0
    assert sorted(snap) == sorted(f"job.j.watchdog.{n}" for n in (
        "sections_timed", "deadline_misses", "shards_quarantined",
        "declared_dead", "hosts_declared_dead", "heartbeat_age_s"))


# ------------------------------------------------- sharded checkpoint store


def _units(seed, ranges):
    rng = np.random.default_rng(seed)
    return {r: {"table": {"key_id": rng.integers(0, 99, 7),
                          "leaf_0": rng.random(7).astype(np.float32)},
                "watermark": int(seed)} for r in ranges}


RANGES = [(0, 31), (32, 63), (64, 95), (96, 127)]


def _tear(root, cid, r):
    import glob

    path = sorted(glob.glob(f"{root}/chk-{cid}/shard-{r[0]}-{r[1]}/*.npz"))
    with open(path[0], "r+b") as f:
        f.seek(40)
        f.write(b"\x00\xff" * 8)


@pytest.mark.parametrize("writer,reader", [("ref", "ref"),
                                           ("port", "port"),
                                           ("ref", "port"),
                                           ("port", "ref")])
def test_sharded_storage_round_trip_torn_fallback_and_retention(
        tmp_path, writer, reader):
    """Three checkpoints by one package, read by the same or the other:
    every unit and position round-trips; a torn unit of the newest
    falls back to THAT range's older unit (the others stay newest); a
    whole-job read assembles mixed ages; retention keeps the fallback
    chain below the torn newest."""
    root = str(tmp_path / "c")
    w = PKGS[writer][2](root)
    for cid in (1, 2, 3):
        w.write_checkpoint(cid, "job", _units(cid, RANGES),
                           positions={r: 2 * cid for r in RANGES})
    _tear(root, 3, RANGES[1])
    rd = PKGS[reader][2](root)
    assert rd.checkpoint_ids() == [1, 2, 3]
    assert rd.unit_ranges(3) == RANGES
    state, pos = rd.read_unit(2, RANGES[2])
    assert pos == 4
    assert_state_equal(state, _units(2, RANGES)[RANGES[2]], "unit")
    cid, states, pos = rd.latest_units_for_groups(range(40, 50))
    assert (cid, pos) == (2, 4)
    assert_state_equal(states[0], _units(2, RANGES)[RANGES[1]], "fallback")
    cid, states, pos = rd.latest_units_for_groups(range(0, 10))
    assert (cid, pos) == (3, 6)
    newest, got, skipped = rd.read_all_units_with_fallback()
    assert (newest, skipped) == (3, 1)
    assert [(r, p) for r, _, p in got] == [
        (RANGES[0], 6), (RANGES[1], 4), (RANGES[2], 6), (RANGES[3], 6)]
    rd.retain(1)
    # chk-2 anchors range 1's fallback: chk-1 goes, 2 and 3 stay
    assert rd.checkpoint_ids() == [2, 3]


def test_sharded_storage_delta_units_replace_data_dicts(tmp_path):
    """A delta unit materializes over its base with the port's merge
    (ROADMAP Queue C R2): a session fired between the base and the delta
    stays gone in the port; the reference's merge brings it back."""
    base = {"table": {"key_id": np.arange(3)},
            "sessions": {1: [(0, 10, 5)], 2: [(0, 12, 6)]}}
    delta = {"table": {"__delta__": np.asarray(True),
                       "key_id": np.arange(0)},
             "sessions": {2: [(0, 12, 6)]}}
    got = {}
    for pkg in ("ref", "port"):
        st = PKGS[pkg][2](str(tmp_path / pkg))
        st.write_checkpoint(1, "j", {(0, 127): base}, {(0, 127): 2})
        st.write_checkpoint(2, "j", {(0, 127): delta}, {(0, 127): 4},
                            incremental_base=1)
        got[pkg] = st.read_unit(2, (0, 127))[0]["sessions"]
    assert sorted(got["port"]) == [2]
    assert sorted(got["ref"]) == [1, 2]


# --------------------------------------------------- engine shard surgery


def test_shard_key_groups_invert_the_routing_formula():
    eng = make_engine("sessions_paged", "port")
    keys = np.arange(5000, dtype=np.int64)
    for P in (1, 3, 4, 5, 7, 8):
        for kgr in (None, (16, 79)):
            want = [tuple(r) for r in jranges(P, 128, kgr)]
            eng.P, eng.key_group_range = P, kgr
            assert eng.shard_key_groups() == want
            shards = shard_records(keys, P, 128, kgr)
            kg = assign_key_groups(keys, 128)
            for p, (g0, g1) in enumerate(want):
                sel = (shards == p) & (kg >= (kgr or (0,))[0]) \
                    & (kg <= (kgr or (0, 127))[1])
                if sel.any():
                    assert kg[sel].min() >= g0 and kg[sel].max() <= g1


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_snapshot_sharded_units_equal_reference(kind):
    """Unit by unit, bit for bit; the units' union is the full snapshot."""
    steps = _stream(kind)
    j, t = _pair(kind, steps[:5])
    ju, tu = j.snapshot_sharded("savepoint"), t.snapshot_sharded("savepoint")
    assert list(tu) == [tuple(r) for r in ju]
    for r in ju:
        assert_state_equal(tu[tuple(r)], ju[r], f"unit{r}")
    full = t.snapshot(mode="savepoint")
    merged = t.merge_unit_snapshots(list(tu.values()))
    assert_state_equal(merged, j.merge_unit_snapshots(list(ju.values())))
    n = len(full["table"]["key_id"])
    assert n and len(merged["table"]["key_id"]) == n
    # a delta splits too (the tombstones ride in every unit)
    _feed(j, "ref", steps[5:6])
    _feed(t, "port", steps[5:6])
    jd, td = j.snapshot_sharded("delta"), t.snapshot_sharded("delta")
    for r in jd:
        assert_state_equal(td[tuple(r)], jd[r], f"delta{r}")


#: the shard-loss protocol's engines held to the reference. Left out: the
#: namespace spill layout — both packages' ``restore_key_groups`` land a
#: restored range's rows resident in a namespace its shard holds spilled,
#: and the next eviction of that namespace asserts "spilled twice"
#: (ROADMAP.md Queue C R4) — and sliding windows, whose re-opened windows
#: the reference fires again for every key (R5, pinned at the end)
LOSS_KINDS = ["sessions_paged", "sessions_unbudgeted", "window_tumbling"]


@pytest.mark.parametrize("kind", LOSS_KINDS)
def test_lose_shard_survivors_and_unit_restore_equal_reference(kind):
    """``lose_shard(1)`` at P=4: the survivors' rows (dirtiness and
    recency kept) on P=3, equal to the reference's; then the dead range
    restored from a unit taken two steps earlier and the range's records
    replayed: every fire and the final snapshot equal the reference's."""
    steps = _stream(kind)
    j, t = _pair(kind, steps[:3])
    units = {"ref": j.snapshot_sharded(), "port": t.snapshot_sharded()}
    _fired_equal(_feed(t, "port", steps[3:5]), _feed(j, "ref", steps[3:5]))
    jr, tr = j.lose_shard(1), t.lose_shard(1)
    assert tuple(jr) == tr and t.P == 3
    assert t.last_shard_loss["dead_ids"] == [1]
    assert_state_equal(t.snapshot(mode="savepoint"),
                       j.snapshot(mode="savepoint"), "survivors")
    groups = range(tr[0], tr[1] + 1)
    for pkg, eng in (("ref", j), ("port", t)):
        unit = [u for r, u in units[pkg].items() if tuple(r) == tr]
        eng.restore_key_groups(eng.merge_unit_snapshots(unit), groups)
    assert_state_equal(t.snapshot(mode="savepoint"),
                       j.snapshot(mode="savepoint"), "restored")
    for pkg, eng in (("ref", j), ("port", t)):
        for keys, vals, ts, _wm in steps[3:5]:
            kg = assign_key_groups(keys, 128)
            m = (kg >= tr[0]) & (kg <= tr[1])
            eng.process_batch(_batch(pkg, keys[m], vals[m], ts[m]))
    _fired_equal(_feed(t, "port", steps[5:]), _feed(j, "ref", steps[5:]))
    assert_state_equal(t.snapshot(), j.snapshot(), "final")
    assert_state_equal(t.snapshot(mode="delta"), j.snapshot(mode="delta"),
                       "next delta")


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_reshard_4_3_5_equals_reference(kind):
    """Live reshard 4 -> 3 -> 5 between batches: the rows, their dirtiness
    (the next delta) and every fire equal the reference's."""
    steps = _stream(kind)
    j, t = _pair(kind, steps[:3])
    for to, lo, hi in ((3, 3, 5), (5, 5, 8)):
        jrep, trep = j.reshard(to), t.reshard(to)
        for k in ("from", "to", "rows_moved", "resident_rows",
                  "spilled_rows"):
            assert trep[k] == jrep[k], k
        assert t.P == to and t.reshards_completed == j.reshards_completed
        assert_state_equal(t.snapshot(mode="savepoint"),
                           j.snapshot(mode="savepoint"), f"at {to}")
        _fired_equal(_feed(t, "port", steps[lo:hi]),
                     _feed(j, "ref", steps[lo:hi]))
    assert_state_equal(t.snapshot(mode="delta"), j.snapshot(mode="delta"))
    if kind in ("sessions_paged", "window_spill"):
        assert t.spill_counters() == j.spill_counters()
        assert t.spill_counters()["rows_evicted"] > 0


def test_rebuild_replaces_everything_sized_by_p():
    """After a loss the exchange step, the staging pool, the indexes,
    the spill tiers and page maps, the dirty bits and the planes are all
    at the new P (a stale one would route rows into the wrong plane)."""
    t = make_engine("sessions_paged", "port", shards=8)
    _feed(t, "port", _stream("sessions_paged")[:3])
    pool, step = t._shuffle_pool, t._exchange_scatter_step
    t.lose_shards([6, 7])
    assert t.P == 6 and t.mesh.size == 6
    assert t._shard_ids() == [0, 1, 2, 3, 4, 5]
    assert t._shuffle_pool is not pool
    assert t._exchange_scatter_step is not step
    assert len(t.indexes) == len(t.spills) == len(t._pmaps) == 6
    assert t._dirty.shape[0] == t._slot_touch.shape[0] == 6
    assert all(a.shape[0] == 6 for a in t.accs)
    t.lose_shard(2)
    assert t._shard_ids() == [0, 1, 3, 4, 5]


@pytest.mark.parametrize("dead", [[0, 2], [4], [0, 1, 2, 3]])
def test_lose_shards_rejects_what_the_reference_rejects(dead):
    for pkg in ("ref", "port"):
        eng = make_engine("window_unbudgeted", pkg)
        if dead == [4]:
            with pytest.raises(ValueError, match="no shard 4"):
                eng.lose_shards(dead)
        elif len(dead) == 4:
            with pytest.raises(ValueError, match="whole mesh"):
                eng.lose_shards(dead)
        else:
            with pytest.raises(ValueError, match="contiguous"):
                eng.lose_shards(dead)


# ------------------------------------------------------- units across pkgs


@pytest.mark.parametrize("kind", ["sessions_paged", "window_tumbling"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_unit_written_by_one_package_restores_in_the_other(
        kind, writer, tmp_path):
    """One package writes shard units with its storage; the other reads
    the dead range's unit with ITS storage and restores it into its
    engine after the same loss: the continued fires and snapshot equal
    an engine that restored its own package's unit."""
    reader = "port" if writer == "ref" else "ref"
    steps = _stream(kind)
    w, r = make_engine(kind, writer), make_engine(kind, reader)
    _feed(w, writer, steps[:3])
    _feed(r, reader, steps[:3])
    PKGS[writer][2](str(tmp_path)).write_checkpoint(
        1, "job", w.snapshot_sharded(),
        positions={g: 3 for g in w.snapshot_sharded()})
    own = r.snapshot_sharded()
    twin = make_engine(kind, reader)
    _feed(twin, reader, steps[:3])
    _feed(r, reader, steps[3:4])
    _feed(twin, reader, steps[3:4])
    g = r.lose_shard(2)
    assert tuple(twin.lose_shard(2)) == tuple(g)
    groups = range(g[0], g[1] + 1)
    _cid, states, pos = PKGS[reader][2](
        str(tmp_path)).latest_units_for_groups(groups)
    assert pos == 3
    r.restore_key_groups(r.merge_unit_snapshots(states), groups)
    twin.restore_key_groups(twin.merge_unit_snapshots(
        [u for rg, u in own.items() if tuple(rg) == tuple(g)]), groups)
    assert_state_equal(r.snapshot(mode="savepoint"),
                       twin.snapshot(mode="savepoint"))
    _fired_equal(_feed(r, reader, steps[4:]), _feed(twin, reader, steps[4:]))


# ----------------------------------------------- run_shard_loss_verify


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
        rep = jharness.run_shard_loss_verify(mk, mo, steps, plan, seed=7,
                                             ckpt_root=root, **kw)
    finally:
        jharness._diff = diff
    return rep, seen["committed"]


def _makers(kind, pkg, shards=4):
    ref = pkg == "ref"
    agg = (jagg if ref else tagg).SumAggregate("v")
    family = ENGINES[kind][0]
    if family == "sessions":
        if ref:
            from flink_tpu.windowing.sessions import SessionWindower as S
            mo = lambda: S(GAP, agg, capacity=1 << 15)  # noqa: E731
        else:
            from flink_tpu_torch.windowing.sessions import (
                SessionWindower as S,
            )
            mo = lambda: S(GAP, agg, capacity=1 << 15,  # noqa: E731
                           spill={"device": "cpu"})
    else:
        asgs = jasg if ref else tasg
        asg = (asgs.TumblingEventTimeWindows.of(100) if family == "tumbling"
               else asgs.SlidingEventTimeWindows.of(300, 100))
        if ref:
            from flink_tpu.windowing.windower import SliceSharedWindower as W
            mo = lambda: W(asg, agg, capacity=1 << 15)  # noqa: E731
        else:
            from flink_tpu_torch.windowing.windower import (
                SliceSharedWindower as W,
            )
            mo = lambda: W(asg, agg, capacity=1 << 15,  # noqa: E731
                           spill={"device": "cpu"})
    holder = {}

    def mk():
        holder["engine"] = make_engine(kind, pkg, shards)
        return holder["engine"]

    return mk, mo, holder


SCENARIOS = {
    # (engine kind, stream, rules, expected (shards_lost, shard_restores,
    # crashes))
    "sessions_loss": ("sessions_paged", {}, [
        dict(pattern="device.lost", nth=11, where={"shard": 1})],
        (1, 1, 0)),
    "sessions_forced_eviction": (
        "sessions_paged", {"num_keys": 6000, "per_step": 1500}, [
            dict(pattern="device.lost", nth=11, where={"shard": 1})],
        (1, 1, 0)),
    "sessions_torn_unit": ("sessions_paged", {}, [
        dict(pattern="checkpoint.write.torn", nth=10, kind="drop"),
        dict(pattern="device.lost", nth=15, where={"shard": 1})],
        (1, 1, 0)),
    "sessions_crash_whole_job": ("sessions_paged", {}, [
        dict(pattern="checkpoint.write.torn", nth=10, kind="corrupt"),
        dict(pattern="mesh.session_fire", nth=5, kind="raise")],
        (0, 0, 1)),
    "sessions_loss_before_first_checkpoint": ("sessions_paged", {}, [
        dict(pattern="device.lost", nth=1, where={"shard": 1})],
        (1, 0, 0)),
    "window_loss": ("window_tumbling", {}, [
        dict(pattern="device.lost", nth=11, where={"shard": 1})],
        (1, 1, 0)),
    "window_loss_shard_3": ("window_tumbling", {}, [
        dict(pattern="device.lost", nth=12, where={"shard": 3})],
        (1, 1, 0)),
    "window_two_losses": ("window_tumbling", {}, [
        dict(pattern="device.lost", nth=7, where={"shard": 2}),
        dict(pattern="device.lost", nth=14, where={"shard": 0})],
        (2, 2, 0)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_run_shard_loss_verify_equals_reference(name, tmp_path):
    kind, stream, rules, (lost, restores, crashes) = SCENARIOS[name]
    steps = _steps(**stream)
    out = {}
    for pkg in ("ref", "port"):
        chaos_mod = PKGS[pkg][1]
        plan = chaos_mod.FaultPlan(
            rules=[chaos_mod.FaultRule(**r) for r in rules])
        mk, mo, holder = _makers(kind, pkg)
        root = str(tmp_path / pkg)
        if pkg == "ref":
            rep, committed = _ref_report(mk, mo, steps, plan, root,
                                         checkpoint_every=2)
        else:
            rep = tharness.run_shard_loss_verify(
                mk, mo, steps, plan, seed=7, ckpt_root=root,
                checkpoint_every=2)
            committed = rep.committed
        out[pkg] = (rep, committed, holder["engine"])
    (jr, jc, je), (tr, tc, te) = out["ref"], out["port"]
    assert tr.signature() == jr.signature()
    assert tr.corrupt_checkpoints_skipped == jr.corrupt_checkpoints_skipped
    assert tc == jc  # every committed window, bit for bit
    assert not tr.diverged and tr.windows > 0
    assert (tr.shards_lost, tr.shard_restores, tr.crashes) == (
        lost, restores, crashes)
    assert_state_equal(te.snapshot(mode="savepoint"),
                       je.snapshot(mode="savepoint"), "final engine")
    if lost:
        # bounded replay: only the dead range's records (none when the
        # loss came before any step completed)
        assert tr.records_replayed <= tr.events // 4 * lost
        assert (tr.records_replayed > 0) == (
            name != "sessions_loss_before_first_checkpoint")
        assert tr.shard_loss_recovery_ms > 0
        assert set(tr.shard_loss_parts_ms) == {
            "evacuate", "rebuild", "land", "unit_read", "unit_restore",
            "replay"}
    if name == "sessions_forced_eviction":
        assert te.spill_counters()["rows_evicted"] > 0
    if name == "sessions_crash_whole_job":
        assert tr.restores == 1 and tr.corrupt_checkpoints_skipped == 1


def test_run_shard_loss_verify_is_seed_deterministic(tmp_path):
    sigs = []
    for i in range(2):
        mk, mo, _ = _makers("sessions_paged", "port")
        plan = tchaos.FaultPlan(rules=[tchaos.FaultRule(
            pattern="device.lost", nth=11, where={"shard": 1})])
        rep = tharness.run_shard_loss_verify(
            mk, mo, _steps(), plan, seed=7,
            ckpt_root=str(tmp_path / f"c{i}"), checkpoint_every=2)
        sigs.append((rep.signature(), rep.committed))
    assert sigs[0] == sigs[1]
    assert sigs[0][0]["shards_lost"] == 1


def test_run_shard_loss_verify_catches_a_lossy_restore(tmp_path):
    """The harness is not vacuous: a restore that drops the unit's rows
    diverges from the oracle."""
    mk0, mo, _ = _makers("window_tumbling", "port")

    def mk():
        eng = mk0()
        real = eng.restore_key_groups
        eng.restore_key_groups = lambda snap, groups: real(
            {k: v for k, v in snap.items() if k != "table"}, groups)
        return eng

    plan = tchaos.FaultPlan(rules=[tchaos.FaultRule(
        pattern="device.lost", nth=11, where={"shard": 1})])
    rep = tharness.run_shard_loss_verify(
        mk, mo, _steps(), plan, seed=7, ckpt_root=str(tmp_path),
        checkpoint_every=2, check=False)
    assert rep.diverged


# ------------------------------------------------------- joins and CEP


def _join_engines():
    from flink_tpu.joins.engine import MeshIntervalJoinEngine as JI
    from flink_tpu.joins.engine import MeshTemporalJoinEngine as JT
    from flink_tpu_torch.joins.engine import MeshIntervalJoinEngine as TI
    from flink_tpu_torch.joins.engine import MeshTemporalJoinEngine as TT

    return {"interval": ((lambda **k: JI(-50, 50, **k)),
                         (lambda **k: TI(-50, 50, **k))),
            "temporal": ((lambda **k: JT(**k)), (lambda **k: TT(**k)))}


def _join_feed(eng, pkg, seed=3, steps=6, n=400):
    rng = np.random.default_rng(seed)
    for s in range(steps):
        for side in (0, 1):
            keys = rng.integers(0, 300, n).astype(np.int64)
            ts = np.sort(rng.integers(s * 100, s * 100 + 100, n)
                         ).astype(np.int64)
            vals = rng.random(n).astype(np.float32)
            eng.process_batch(_batch(pkg, keys, vals, ts), side)
        eng.on_watermark(s * 100 + 20)


@pytest.mark.parametrize("kind", ["interval", "temporal"])
def test_join_units_and_key_group_filter_restore(kind):
    """Units bit-equal to the reference's; each unit restored into a fresh
    engine with ``key_group_filter`` and merged equals the full snapshot,
    as does the reference's merge."""
    mj, mt = _join_engines()[kind]
    j = mj(mesh=jmake_mesh(4), capacity_per_shard=512,
           max_device_slots=512)
    t = mt(num_shards=4, capacity_per_shard=512, max_device_slots=512,
           device="cpu")
    _join_feed(j, "ref")
    _join_feed(t, "port")
    ju, tu = j.snapshot_sharded(), t.snapshot_sharded()
    assert list(tu) == [tuple(r) for r in ju]
    for r in ju:
        assert_state_equal(tu[tuple(r)], ju[r], f"unit{r}")
    restored = []
    for (g0, g1), unit in tu.items():
        fresh = mt(num_shards=4, capacity_per_shard=512,
                   max_device_slots=512, device="cpu")
        fresh.restore(unit, key_group_filter=range(g0, g1 + 1))
        restored.append(fresh.snapshot_sharded()[(g0, g1)])
    merged = t.merge_unit_snapshots(restored)
    full = t.snapshot()
    assert_state_equal(merged, t.merge_unit_snapshots(list(tu.values())))
    for side in ("left", "right"):
        want = full[side]["table"]
        if len(want.get("key_id", ())):
            assert_state_equal(merged[side]["table"], want, side)
        else:
            assert not len(merged[side]["table"].get("key_id", ()))
    if kind == "temporal":
        # the pending left rows come back by range, each range in order
        assert len(merged["pending"]["__key_id__"]) == len(
            full["pending"]["__key_id__"]) > 0
    else:
        assert len(full["left"]["table"]["key_id"]) > 0
    assert_state_equal(merged, j.merge_unit_snapshots(list(ju.values())))


def test_join_watchdog_sections_and_boundaries():
    _, mt = _join_engines()["interval"]
    t = mt(num_shards=4, capacity_per_shard=512, device="cpu")
    wd = twd.DeviceWatchdog(4)
    t.attach_watchdog(wd)
    _join_feed(t, "port", steps=2)
    assert wd.sections_timed > 0
    plan = tchaos.FaultPlan(rules=[tchaos.FaultRule(
        pattern="device.lost", nth=1, where={"shard": 2})])
    with tchaos.chaos_active(plan, 7):
        with pytest.raises(twd.ShardFailedError) as e:
            t.on_watermark(500)
    assert e.value.shard == 2


def test_cep_units_and_key_group_filter_restore():
    from tests.test_torch_mesh_cep import (
        PORT,
        REF,
        churn,
        gen_steps,
        port,
        ref,
        run,
    )

    steps = gen_steps(5, n_steps=10, n_keys=3000, batch=512)
    j, t = ref(churn, shards=4, capacity=64), port(churn, shards=4,
                                                   capacity=64)
    wd = twd.DeviceWatchdog(4)
    t.attach_watchdog(wd)
    run(j, steps, REF[2])
    run(t, steps, PORT[2])
    assert t.spill_counters()["rows_evicted"] > 0
    assert wd.sections_timed > 0
    ju, tu = j.snapshot_sharded(), t.snapshot_sharded()
    assert list(tu) == [tuple(r) for r in ju]
    for r in ju:
        assert_state_equal(tu[tuple(r)], ju[r], f"unit{r}")
    restored = []
    for (g0, g1), unit in tu.items():
        fresh = port(churn, shards=4, capacity=64)
        fresh.restore(unit, key_group_filter=range(g0, g1 + 1))
        restored.append(fresh.snapshot_sharded()[(g0, g1)])
    full = t.snapshot()
    whole = t.merge_unit_snapshots(list(tu.values()))
    merged = t.merge_unit_snapshots(restored)
    for name in ("state", "pending", "matches", "key_order"):
        assert_state_equal(merged[name], whole[name], name)
    assert merged["key_values"] == whole["key_values"] == full["key_values"]
    # the units' union is the snapshot (the merge orders state rows by
    # key, pending rows by sequence and matches by rid)
    for name, by in (("state", "key_id"), ("pending", "seq"),
                     ("matches", "rid")):
        order = np.argsort(np.asarray(full[name][by]), kind="stable")
        assert_state_equal(whole[name], {
            col: np.asarray(v)[order] for col, v in full[name].items()},
            name)
    assert_state_equal(whole, j.merge_unit_snapshots(list(ju.values())))


# ---------------------------------------------------------- the executor


def _q5(extra):
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink

    env = StreamExecutionEnvironment(Configuration({
        "parallelism.default": 8, "execution.micro-batch.size": 1 << 13,
        "execution.device": "cpu", **extra}))
    sink = CollectSink()
    build_q5(env, BidSource(total_records=60_000,
                            num_auctions=2_000)).sink_to(sink)
    return sink.rows(), env.execute()


def test_executor_watchdog_enabled_runs_and_counts():
    """``watchdog.enabled`` no longer raises at submit: one watchdog per
    job is attached to the mesh engine, the rows equal a run without it,
    and its counters land in the job result."""
    want, _ = _q5({})
    got, result = _q5({"watchdog.enabled": True,
                       "watchdog.deadline-ms": 10_000})
    assert got == want
    wd = result.metrics["watchdog"]
    assert wd["sections_timed"] > 0
    assert wd["deadline_misses"] == 0 and wd["declared_dead"] == 0


def test_executor_shard_failed_error_leaves_execute():
    plan = tchaos.FaultPlan(rules=[tchaos.FaultRule(
        pattern="device.lost", nth=4, where={"shard": 5})])
    with tchaos.chaos_active(plan, 7):
        with pytest.raises(twd.ShardFailedError) as e:
            _q5({"watchdog.enabled": True})
    assert e.value.shard == 5 and "shard 5" in str(e.value)


def test_executor_sessions_and_joins_attach_the_watchdog():
    from flink_tpu_torch.joins.operators import DeviceIntervalJoinOperator
    from flink_tpu_torch.runtime.operators import (
        OperatorContext,
        SessionWindowAggOperator,
    )

    wd = twd.DeviceWatchdog(8)
    ctx = OperatorContext(parallelism=8, device="cpu", watchdog=wd)
    op = SessionWindowAggOperator(GAP, tagg.SumAggregate("v"), "k")
    op.open(ctx)
    assert op.windower._watchdog is wd
    jop = DeviceIntervalJoinOperator(-5, 5)
    jop.open(ctx)
    assert jop.engine._watchdog is wd


def test_sliding_window_refire_stays_in_the_restored_range(tmp_path):
    """ROADMAP.md Queue C R5: the book merge re-opens the windows fired
    between the unit's checkpoint and the loss. With sliding windows
    their slices are shared with later windows and still live on the
    survivors, so the reference fires them again for every key — over the
    slices left after the first fire's expiry — and the partial sums
    overwrite the survivors' committed cells. The port fires a re-opened
    window again for the restored key groups only: its output equals the
    oracle where the reference's diverges (Q5-revenue's bids, HOP 1 s /
    200 ms, P=8, shard 3 lost at step 5's watermark)."""
    from flink_tpu.chaos.injection import FaultPlan as JPlan
    from flink_tpu.chaos.injection import FaultRule as JRule
    from flink_tpu.windowing.windower import SliceSharedWindower as JW
    from flink_tpu_torch.benchmarks.shard_loss import q5rev_steps
    from flink_tpu_torch.windowing.windower import SliceSharedWindower as TW

    steps = q5rev_steps(655360, step=1 << 16)
    reps = {}
    for pkg in ("ref", "port"):
        ref = pkg == "ref"
        asg = (jasg if ref else tasg).SlidingEventTimeWindows
        agg = (jagg if ref else tagg).SumAggregate

        def mk(ref=ref, asg=asg, agg=agg):
            mesh = jmake_mesh(8) if ref else make_mesh(8, "cpu")
            return (JMeshW if ref else TMeshW)(
                asg.of(1000, 200), agg("v"), mesh,
                capacity_per_shard=1 << 14)

        def mo(ref=ref, asg=asg, agg=agg):
            if ref:
                return JW(asg.of(1000, 200), agg("v"), capacity=1 << 18)
            return TW(asg.of(1000, 200), agg("v"), capacity=1 << 18,
                      spill={"device": "cpu"})

        plan_cls, rule_cls = ((JPlan, JRule) if ref
                              else (tchaos.FaultPlan, tchaos.FaultRule))
        plan = plan_cls(rules=[rule_cls(pattern="device.lost", nth=12,
                                        where={"shard": 3})])
        if ref:
            mk_ref, mo_ref = mk, mo
        run = (jharness if ref else tharness).run_shard_loss_verify
        reps[pkg] = run(mk, mo, steps, plan, seed=7,
                        ckpt_root=str(tmp_path / pkg), checkpoint_every=2,
                        check=False)
    j, t = reps["ref"], reps["port"]
    assert j.diverged and not t.diverged
    sig = dict(t.signature(), diverged=True)
    assert sig == j.signature()
    assert 0 < t.records_replayed <= t.events // 8
    # the bit-level witness: the port's lossy run commits exactly the
    # cells the reference's mesh engine commits on the same steps without
    # the fault — every window, bit for bit, the re-fired ones included
    _, clean = _ref_report(mk_ref, mo_ref, steps, JPlan(rules=[]),
                           str(tmp_path / "ref-clean"), checkpoint_every=2,
                           check=False)
    assert t.committed == clean
    assert len(clean) == t.windows > 0
