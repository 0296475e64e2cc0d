"""The join engines' four device programs (``flink_tpu_torch/joins/
kernels.py``) against the reference's (``flink_tpu/joins/kernels.py``) on
the CPU: the reference's programs on the 8 virtual devices of
``tests/conftest.py`` with the ``xla`` exchange rank (its default), the
port's on the ``[8, capacity]`` planes of its logical mesh.

- join-put: ``[P, B]`` blocks with padded lanes at the scratch slot 0;
- join-exchange-put: flat staged columns from ``stage_device_exchange``
  with padded (sentinel) lanes, destinations that receive nothing from
  some sources (empty bucket lanes), and uneven per-pair counts;
- join-gather: ``[P, G]`` slot blocks;
- join-banded-probe: bands that run past the mirror's end ``S``, empty
  bands, spilled (``-1``) and padded mirror lanes.

Float32, int32 and bool planes. Tolerance: none — every plane (and every
probe and gather output) is compared bit for bit, slot 0 included (every
write there writes zero, so it stays zero). Each put's non-zero target
slots are asserted unique: the card's scatter has no defined winner
between two writes of one slot, so no real row may share one.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from flink_tpu.joins.kernels import (
    build_banded_probe,
    build_join_exchange_put,
    build_join_gather,
    build_join_put,
)
from flink_tpu.parallel.mesh import KEY_AXIS, make_mesh as jmake_mesh
from flink_tpu_torch.joins import kernels
from flink_tpu_torch.parallel.shuffle import stage_device_exchange
from flink_tpu_torch.stateplane.rank import exchange_rank_flat

P = 8
DTYPES = ("float32", "int32", "bool")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _values(rng, n, dtype):
    if dtype == "float32":
        v = rng.standard_normal(n).astype(np.float32)
        v[::7] = -0.0
        v[3::11] = np.float32(np.nan)
        return v
    if dtype == "int32":
        return rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    return rng.random(n) < 0.5


def _planes(rng, cap):
    out = [_values(rng, P * cap, dt).reshape(P, cap) for dt in DTYPES]
    for pl in out:
        pl[:, 0] = 0   # the scratch slot holds zero, as the engine keeps it
    return out


def _shard(mesh, a):
    return jax.device_put(np.asarray(a),
                          NamedSharding(mesh, PartitionSpec(KEY_AXIS)))


def _torch(planes):
    return [torch.from_numpy(p.copy()) for p in planes]


def _assert_planes_equal(got, want):
    for g, w, dt in zip(got, want, DTYPES):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype == np.dtype(dt)
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=dt)


def _fresh_slots(rng, counts, cap):
    """Per shard, ``counts[p]`` distinct slots in [1, cap), as the side
    table allocates them."""
    return [rng.permutation(np.arange(1, cap, dtype=np.int32))[:c]
            for c in counts]


# ----------------------------------------------------------------- put


@pytest.mark.parametrize("seed,cap,B", [(0, 256, 64), (1, 4096, 1024),
                                        (2, 300, 299)])
def test_join_put_matches_reference(seed, cap, B):
    rng = np.random.default_rng(seed)
    mesh = jmake_mesh(P)
    planes = _planes(rng, cap)
    counts = rng.integers(0, B + 1, P)
    counts[0] = 0   # a shard with nothing to put
    slot_block = np.zeros((P, B), dtype=np.int32)
    for p, s in enumerate(_fresh_slots(rng, counts, cap)):
        slot_block[p, :len(s)] = s
        nz = slot_block[p][slot_block[p] != 0]
        assert len(np.unique(nz)) == len(nz)
    vals = [_values(rng, P * B, dt).reshape(P, B) for dt in DTYPES]
    for v in vals:
        v[slot_block == 0] = 0   # padded lanes carry zero
    want = build_join_put(mesh, DTYPES)(
        tuple(_shard(mesh, p) for p in planes), _shard(mesh, slot_block),
        tuple(_shard(mesh, v) for v in vals))
    got = kernels.join_put(_torch(planes), torch.from_numpy(slot_block),
                           [torch.from_numpy(v) for v in vals])
    _assert_planes_equal(got, want)


# -------------------------------------------------------- exchange-put


def _exchange_case(rng, n, cap, empty_dst=None, skew=False):
    """A batch as the engine stages it: destinations, fresh slots per
    destination, values; ``empty_dst`` receives nothing."""
    dst = rng.integers(0, P, n).astype(np.int64)
    if skew:
        dst[: n // 2] = 3
    if empty_dst is not None:
        dst[dst == empty_dst] = (empty_dst + 1) % P
    slots = np.zeros(n, dtype=np.int32)
    counts = np.bincount(dst, minlength=P)
    for p, s in enumerate(_fresh_slots(rng, counts, cap)):
        slots[dst == p] = s
    vals = [_values(rng, n, dt) for dt in DTYPES]
    return dst, slots, vals


@pytest.mark.parametrize("seed,n,cap,empty_dst,skew", [
    (0, 1000, 2048, None, False),
    (1, 5000, 8192, 5, False),      # destination 5 receives nothing
    (2, 3000, 4096, None, True),    # one destination takes half
    (3, 1, 256, None, False),       # one record: the rest is padding
    (4, 2047, 2048, 0, True),
])
def test_join_exchange_put_matches_reference(seed, n, cap, empty_dst,
                                             skew):
    rng = np.random.default_rng(seed)
    mesh = jmake_mesh(P)
    planes = _planes(rng, cap)
    dst_rec, slots, vals = _exchange_case(rng, n, cap, empty_dst, skew)
    fills = [0] + [np.dtype(dt).type(0) for dt in DTYPES]
    dst, staged, width = stage_device_exchange(dst_rec, P, [slots, *vals],
                                               fills)
    assert (dst == P).any() or n % P == 0   # padded lanes: the sentinel
    # every put's non-zero target slots are unique per destination
    for p in range(P):
        s = slots[dst_rec == p]
        assert len(np.unique(s)) == len(s) and (s != 0).all()
    want = build_join_exchange_put(mesh, DTYPES)(
        tuple(_shard(mesh, p) for p in planes), _shard(mesh, dst),
        _shard(mesh, staged[0]), tuple(_shard(mesh, v) for v in staged[1:]),
        width)
    got = kernels.join_exchange_put(
        _torch(planes), torch.from_numpy(dst), torch.from_numpy(staged[0]),
        [torch.from_numpy(v) for v in staged[1:]], width)
    _assert_planes_equal(got, want)
    # and the rows landed where the side table put them
    for p in range(P):
        sel = dst_rec == p
        np.testing.assert_array_equal(
            _bits(got[0].numpy()[p, slots[sel]]), _bits(vals[0][sel]))


def test_exchange_buckets_keep_stream_order_and_drop_sentinels():
    """The received lanes of one destination are its records in stream
    order (source shard, then rank), and the sentinel lanes (padding)
    reach no bucket."""
    rng = np.random.default_rng(9)
    n = 700
    dst_rec = rng.integers(0, P, n)
    dst, staged, width = stage_device_exchange(
        dst_rec, P, [np.arange(1, n + 1, dtype=np.int32)], [0])
    C = len(dst) // P
    flat = exchange_rank_flat(torch.from_numpy(dst).view(P, C), P, width)
    assert int((flat == P * width).sum()) == int((dst == P).sum())
    buf = torch.zeros((P, P * width + 1), dtype=torch.int32)
    buf.scatter_(1, flat, torch.from_numpy(staged[0]).view(P, C))
    recv = (buf[:, :P * width].reshape(P, P, width).transpose(0, 1)
            .reshape(P, P * width)).numpy()
    for p in range(P):
        ids = recv[p][recv[p] != 0]
        np.testing.assert_array_equal(ids, np.nonzero(dst_rec == p)[0] + 1)


# --------------------------------------------------------------- gather


@pytest.mark.parametrize("seed,cap,G", [(0, 256, 256), (1, 5000, 300)])
def test_join_gather_matches_reference(seed, cap, G):
    rng = np.random.default_rng(seed)
    mesh = jmake_mesh(P)
    planes = _planes(rng, cap)
    block = rng.integers(0, cap, (P, G)).astype(np.int32)
    block[:, G // 2:] = 0   # padded lanes
    want = build_join_gather(mesh, DTYPES)(
        tuple(_shard(mesh, p) for p in planes), _shard(mesh, block))
    got = kernels.join_gather(_torch(planes), torch.from_numpy(block))
    _assert_planes_equal(got, want)


# ---------------------------------------------------------- banded probe


@pytest.mark.parametrize("seed,cap,S,B,W", [
    (0, 512, 300, 64, 8),
    (1, 4096, 4096, 256, 64),
    (2, 256, 16, 64, 32),       # bands far past S
])
def test_banded_probe_matches_reference(seed, cap, S, B, W):
    rng = np.random.default_rng(seed)
    mesh = jmake_mesh(P)
    planes = _planes(rng, cap)
    mirror = np.full((P, S), -1, dtype=np.int32)
    for p in range(P):
        live = int(rng.integers(0, S + 1))
        s = rng.integers(1, cap, live).astype(np.int32)
        s[rng.random(live) < 0.2] = -1   # spilled rows
        mirror[p, :live] = s
    lo = rng.integers(0, S + W, (P, B)).astype(np.int32)   # past S too
    cnt = rng.integers(0, W + 1, (P, B)).astype(np.int32)
    cnt[:, ::5] = 0   # empty bands
    want = build_banded_probe(mesh, DTYPES)(
        tuple(_shard(mesh, p) for p in planes), _shard(mesh, mirror),
        _shard(mesh, lo), _shard(mesh, cnt), W)
    got = kernels.banded_probe(
        _torch(planes), torch.from_numpy(mirror), torch.from_numpy(lo),
        torch.from_numpy(cnt), W)
    for g, w, dt in zip(got, want, DTYPES):
        assert tuple(g.shape) == (P, B, W)
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(np.asarray(w)),
                                      err_msg=dt)


# ------------------------------------------------- the engine's own puts


def test_engine_puts_never_repeat_a_real_slot(monkeypatch):
    """Every put the interval engine makes under forced eviction, and the
    put of a restore, writes each non-zero slot of a shard at most once
    (the side table hands out fresh slots after making headroom), so the
    card's scatter has one writer per real slot."""
    from flink_tpu_torch.core.records import (
        KEY_ID_FIELD,
        TIMESTAMP_FIELD,
        RecordBatch,
    )
    from flink_tpu_torch.joins import MeshIntervalJoinEngine

    seen = {"exchange": 0, "put": 0}
    real_xput, real_put = kernels.join_exchange_put, kernels.join_put

    def xput(planes, dst, slots, values, width):
        d, s = dst.numpy(), slots.numpy()
        for p in range(P):
            nz = s[(d == p) & (s != 0)]
            assert len(np.unique(nz)) == len(nz), p
        seen["exchange"] += 1
        return real_xput(planes, dst, slots, values, width)

    def put(planes, slots, values):
        for row in slots.numpy():
            nz = row[row != 0]
            assert len(np.unique(nz)) == len(nz)
        seen["put"] += 1
        return real_put(planes, slots, values)

    monkeypatch.setattr(kernels, "join_exchange_put", xput)
    monkeypatch.setattr(kernels, "join_put", put)
    rng = np.random.default_rng(17)
    kw = dict(num_shards=P, device="cpu", capacity_per_shard=256,
              max_device_slots=256)
    eng = MeshIntervalJoinEngine(-40, 40, **kw)
    for step in range(10):
        for side, name in ((0, "v"), (1, "w")):
            n = 3000
            eng.process_batch(RecordBatch({
                KEY_ID_FIELD: rng.integers(0, 50_000, n).astype(np.int64),
                name: rng.random(n).astype(np.float32),
                TIMESTAMP_FIELD: step * 40 + rng.integers(0, 40, n)}), side)
        eng.on_watermark(step * 40 - 200)
    assert eng.spill_counters()["rows_evicted"] > 0
    MeshIntervalJoinEngine(-40, 40, **kw).restore(eng.snapshot())
    # each batch's ~375 rows a shard pass a shard's 255 slots: every
    # batch is split in two, one exchange-put each half
    assert seen["exchange"] == 40 and seen["put"] == 2
