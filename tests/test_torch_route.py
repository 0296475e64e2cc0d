"""The native shard partition (``native/route.cpp``) that
``MeshWindowEngine._route_batch`` groups a batch by in device shuffle mode.

It is held bit for bit to the NumPy path it replaces — ``shard_records``,
``np.argsort(shards, kind="stable")``, ``np.bincount`` and the two gathers
— and to the reference's ``flink_tpu.parallel.shuffle.shard_records``, for
every form of the engine's routing (the contiguous formula, a
``key_group_range`` engine's local formula, a table installed by
``reassign_key_groups``). A table entry outside ``[0, P)`` that a record
hits makes the pass decline, and the engine then takes the NumPy path.
Last, a Q5-style job fires the same rows in the same order with the native
pass and with the library patched out.
"""

import functools

import numpy as np
import pytest

from flink_tpu.parallel.shuffle import shard_records as jshard_records
from flink_tpu.state.keygroups import KeyGroupAssignment as JAssignment
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.native import load_route, partition_by_shard
from flink_tpu_torch.parallel import sharded_windower
from flink_tpu_torch.parallel.mesh import make_mesh
from flink_tpu_torch.parallel.sharded_windower import MeshWindowEngine
from flink_tpu_torch.parallel.shuffle import shard_records
from flink_tpu_torch.state.keygroups import assign_key_groups
from flink_tpu_torch.windowing import aggregates, assigners
from flink_tpu_torch.windowing.fire_projectors import TopKFireProjector

pytestmark = pytest.mark.skipif(load_route() is None,
                                reason="native/route.cpp did not build")

SHARDS = (1, 2, 8)
MAX_PARALLELISM = (8, 128, 32768)
KEYS = ("negative", "extreme", "nexmark", "one_shard", "empty")
ROUTING = ("formula", "key_group_range", "reassigned")


@functools.lru_cache(maxsize=None)
def _engine(P: int, mp: int, routing: str) -> MeshWindowEngine:
    rng = None
    if routing == "key_group_range":
        rng = (mp // 4, mp // 4 + mp // 2 - 1)
    eng = MeshWindowEngine(assigners.SlidingEventTimeWindows.of(1000, 250),
                           aggregates.CountAggregate(), make_mesh(P, "cpu"),
                           capacity_per_shard=1024, max_parallelism=mp,
                           key_group_range=rng)
    if routing == "reassigned" and P > 1:
        # half of shard 0's groups move to the last shard
        a = eng.key_group_assignment
        g = a.groups_of_shard(0)
        eng.reassign_key_groups(a.move(g[: max(len(g) // 2, 1)], P - 1))
        assert eng._assignment is not None
    return eng


def _keys(kind: str, P: int, mp: int, routing: str) -> np.ndarray:
    rng = np.random.default_rng(
        [SHARDS.index(P), MAX_PARALLELISM.index(mp), KEYS.index(kind)])
    if kind == "negative":
        keys = rng.integers(-(1 << 40), 0, 6000)
    elif kind == "extreme":
        edge = np.array([2**63 - 1, -2**63, -(2**63 - 1), 0, -1, 1,
                         2**32, -2**32, 2**32 - 1, 2**31, -2**31,
                         2**31 - 1], dtype=np.int64)
        keys = np.concatenate([
            np.tile(edge, 50),
            rng.integers(-2**63, 2**63 - 1, 6000, dtype=np.int64,
                         endpoint=True)])
    elif kind == "nexmark":
        from streambench.gen.nexmark_bids import generate

        cols, _ = generate(np.arange(1 << 14, dtype=np.int64) + 2_000_000,
                           2**31 + 7, 2, 100, 4, 1000, 100_000)
        keys = np.asarray(cols["auction"], dtype=np.int64)
    elif kind == "one_shard":
        pool = rng.integers(-(1 << 50), 1 << 50, 20000)
        pool = pool[_in_range(pool, mp, routing)]
        shards = shard_records(pool, P, mp, _engine(P, mp, routing)
                               .key_group_range,
                               assignment=_engine(P, mp, routing)._assignment)
        keys = pool[shards == shards[0]][:4000]
    else:
        keys = np.empty(0, dtype=np.int64)
    keys = np.asarray(keys, dtype=np.int64)
    return keys[_in_range(keys, mp, routing)]


def _in_range(keys, mp: int, routing: str) -> np.ndarray:
    """Records a ``key_group_range`` engine owns (every record else)."""
    if routing != "key_group_range":
        return np.ones(len(keys), dtype=bool)
    g = assign_key_groups(keys, mp)
    return (g >= mp // 4) & (g <= mp // 4 + mp // 2 - 1)


def _numpy_route(eng, keys, nss):
    shards = eng._route(keys)
    order = np.argsort(shards, kind="stable")
    offsets = np.zeros(eng.P + 1, dtype=np.int64)
    np.cumsum(np.bincount(shards, minlength=eng.P), out=offsets[1:])
    return shards, (order, offsets, keys[order], nss[order])


def _reference_shards(eng, keys):
    a = eng._assignment
    ja = (None if a is None
          else JAssignment(int(a.first), int(a.num_shards), a.table.copy()))
    return jshard_records(keys, eng.P, eng.max_parallelism,
                          eng.key_group_range, assignment=ja)


@pytest.mark.parametrize("routing", ROUTING)
@pytest.mark.parametrize("kind", KEYS)
@pytest.mark.parametrize("mp", MAX_PARALLELISM)
@pytest.mark.parametrize("P", SHARDS)
def test_partition_equals_numpy_route(P, mp, kind, routing):
    eng = _engine(P, mp, routing)
    keys = _keys(kind, P, mp, routing)
    if kind != "empty":
        assert len(keys) > 100
    nss = np.random.default_rng(len(keys)).integers(
        -(1 << 62), 1 << 62, len(keys))
    got = partition_by_shard(keys, nss, eng._route_table(), P)
    assert got is not None
    shards, grouped = got
    want_shards, want_grouped = _numpy_route(eng, keys, nss)
    assert shards.dtype == np.int32
    np.testing.assert_array_equal(shards, want_shards)
    np.testing.assert_array_equal(shards, _reference_shards(eng, keys))
    for g, w in zip(grouped, want_grouped):
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    if kind == "one_shard":
        assert np.count_nonzero(np.diff(grouped[1])) == 1


@pytest.mark.parametrize("bad", [-1, 8, 1 << 30, -(1 << 31)])
def test_table_entry_outside_the_shards_declines(bad):
    eng = _engine(8, 128, "formula")
    keys = np.arange(-5000, 5000, dtype=np.int64)
    table = eng._route_table()
    assert partition_by_shard(keys, keys, table, 8) is not None
    hit = int(assign_key_groups(keys[:1], 128)[0])
    table[hit] = bad
    assert partition_by_shard(keys, keys, table, 8) is None
    # a group no record hits does not matter
    table = eng._route_table()
    missed = np.setdiff1d(np.arange(128), assign_key_groups(keys[:3], 128))
    table[missed] = bad
    assert partition_by_shard(keys[:3], keys[:3], table, 8) is not None


def test_more_shards_than_the_counters_decline():
    table = np.zeros(128, dtype=np.int32)
    keys = np.arange(100, dtype=np.int64)
    assert partition_by_shard(keys, keys, table, 4096) is not None
    assert partition_by_shard(keys, keys, table, 4097) is None
    assert partition_by_shard(keys, keys, table[:0], 8) is None
    with pytest.raises(ValueError):
        partition_by_shard(keys, keys[:-1], table, 8)


@pytest.mark.parametrize("routing", ["key_group_range", "reassigned"])
def test_out_of_range_groups_decline(routing):
    """A ``key_group_range`` engine's table leaves the groups outside its
    range without a shard in ``[0, P)``; an assignment's covers its range
    only. A record in such a group makes the native pass decline."""
    P, mp = 8, 128
    eng = MeshWindowEngine(assigners.TumblingEventTimeWindows.of(100),
                           aggregates.CountAggregate(), make_mesh(P, "cpu"),
                           max_parallelism=mp, key_group_range=(32, 95))
    if routing == "reassigned":
        a = eng.key_group_assignment
        eng.reassign_key_groups(a.move([32, 33, 34], P - 1))
    table = eng._route_table()
    outside = np.r_[0:32, 96:128]
    assert np.all((table[outside] < 0) | (table[outside] >= P))
    assert np.all((table[32:96] >= 0) & (table[32:96] < P))
    keys = np.arange(-20000, 20000, dtype=np.int64)
    g = assign_key_groups(keys, mp)
    inside = keys[(g >= 32) & (g <= 95)]
    assert partition_by_shard(inside, inside, table, P) is not None
    assert partition_by_shard(keys, keys, table, P) is None


def _q5_steps(seed: int, n_steps: int = 8, per_step: int = 6000):
    """Nexmark bids in batches with rising event time, and a watermark
    after each batch."""
    from streambench.gen.nexmark_bids import generate

    out = []
    for s in range(n_steps):
        idx = np.arange(s * per_step, (s + 1) * per_step, dtype=np.int64)
        cols, ts = generate(idx, seed, 2, 100, 4, 1000, 20_000)
        keys = np.asarray(cols["auction"], dtype=np.int64)
        ts = np.asarray(ts, dtype=np.int64)
        out.append((keys, ts, int(ts.max()) - 150))
    return out


def _run_q5(steps, shuffle_mode: str = "device", host_topology=None):
    eng = MeshWindowEngine(assigners.SlidingEventTimeWindows.of(1000, 200),
                           aggregates.CountAggregate(), make_mesh(8, "cpu"),
                           capacity_per_shard=1024, max_parallelism=128,
                           fire_projector=TopKFireProjector("count", k=4),
                           shuffle_mode=shuffle_mode,
                           host_topology=host_topology)
    fired = []
    for keys, ts, wm in steps:
        eng.process_batch(RecordBatch({"__key_id__": keys, "__ts__": ts}))
        fired += eng.on_watermark(wm)
    fired += eng.on_watermark(1 << 62)
    rows = [{c: np.asarray(b.columns[c]).tolist() for c in sorted(b.columns)}
            for b in fired]
    return rows, eng.route_counters()


@pytest.mark.parametrize("topology", ["flat", "two_level"])
def test_q5_fires_identical_without_the_library(monkeypatch, topology):
    from flink_tpu_torch.parallel.mesh import HostTopology

    topo = HostTopology(2, 4) if topology == "two_level" else None
    steps = _q5_steps(2**31 + 11)
    rows, counters = _run_q5(steps, host_topology=topo)
    assert counters == {"native_batches": len(steps),
                        "fallback_batches": 0}
    monkeypatch.setattr(sharded_windower, "partition_by_shard",
                        lambda *a: None)
    rows_np, counters_np = _run_q5(steps, host_topology=topo)
    assert counters_np == {"native_batches": 0,
                           "fallback_batches": len(steps)}
    assert len(rows) > 5
    assert rows == rows_np
    # host shuffle mode groups nothing here: neither side counts
    rows_host, counters_host = _run_q5(steps, shuffle_mode="host")
    assert counters_host == {"native_batches": 0, "fallback_batches": 0}
    assert rows_host == rows
