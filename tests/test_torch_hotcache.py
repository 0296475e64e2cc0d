"""The port's hot-row cache planes (``flink_tpu_torch/tenancy/hot_cache.py``
and ``hot_cache_native.py`` over ``native/hotcache.cpp``, built by the
port's own loader) on the cases of ``tests/test_hotcache_native.py``:
native vs Python parity of every operation, the seeded cross-generation
fuzz against a dict oracle, deterministic torn-read coverage, packing
exactness and the ``make_hot_row_cache`` selection knobs. Then the same
seeded operations through the port's and the reference's planes give
equal results (``get_many`` and ``get_many_packed``), and ``shm_dir``
without the native plane raises in both.

The contract: ``NativeHotRowCache`` is interface- and RESULT-identical
to ``HotRowCache``; a torn native read never surfaces a mixed row — it
retries, then falls to the miss path.
"""

import numpy as np
import pytest

from flink_tpu_torch.native import hotcache_available
from flink_tpu_torch.tenancy.hot_cache import (
    HotRowCache,
    PrimeDelta,
    make_hot_row_cache,
)

native = pytest.mark.skipif(not hotcache_available(),
                            reason="native hotcache unavailable")


def _native():
    from flink_tpu_torch.tenancy.hot_cache_native import NativeHotRowCache

    return NativeHotRowCache(max_entries=1 << 12)


def _both():
    return [_native(), HotRowCache(max_entries=1 << 12)]


def _close(c):
    if hasattr(c, "close"):
        c.close()


def _delta(entries):
    """PrimeDelta from {kid: (updates{ns: {col: v}}, removals[ns],
    flags)} — the adapters' flat shape, hand-built for tests."""
    kids = sorted(entries)
    uoff = [0]
    u_ns = []
    u_rows = []
    roff = [0]
    r_ns = []
    flags = []
    cols = None
    for kid in kids:
        ups, rem, fl = entries[kid]
        for ns, row in (ups or {}).items():
            if cols is None:
                cols = tuple(row.keys())
            u_ns.append(ns)
            u_rows.append([row[c] for c in cols])
        uoff.append(len(u_ns))
        r_ns.extend(rem)
        roff.append(len(r_ns))
        flags.append(fl)
    u_cols = []
    if cols is not None:
        mat = np.asarray(u_rows, dtype=np.float64)
        u_cols = [(c, mat[:, i]) for i, c in enumerate(cols)]
    return PrimeDelta(
        keys=np.asarray(kids, dtype=np.int64),
        uoff=np.asarray(uoff, dtype=np.int64),
        u_ns=np.asarray(u_ns, dtype=np.int64),
        u_cols=u_cols,
        roff=np.asarray(roff, dtype=np.int64),
        r_ns=np.asarray(r_ns, dtype=np.int64),
        flags=np.asarray(flags, dtype=np.uint8))


@native
class TestParity:
    """Every operation, native vs Python, result-identical."""

    def test_put_get_roundtrip_exact_types(self):
        # int64 beyond 2^53 and float64 must round-trip EXACTLY (the
        # packed entry stores raw bit patterns with a dtype tag)
        val = {100: {"a": 2 ** 53 + 1, "b": 1.0 / 3.0},
               200: {"a": -5, "b": -0.0}}
        for c in _both():
            c.put("j", "op", 7, 1, val)
            hit, got = c.get("j", "op", 7, 1, exact=False)
            assert hit
            assert got == val
            assert isinstance(got[100]["a"], int)
            assert got[100]["a"] == 2 ** 53 + 1
            assert np.float64(got[200]["b"]).view(np.int64) == \
                np.float64(-0.0).view(np.int64)
            _close(c)

    def test_exact_generation_semantics(self):
        for c in _both():
            c.put("j", "op", 1, 3, {1: {"v": 1.0}})
            assert c.get("j", "op", 1, 3, exact=True)[0]
            assert not c.get("j", "op", 1, 4, exact=True)[0]
            # presence-implies-validity mode hits whatever generation
            c.put("j", "op", 2, 3, {1: {"v": 2.0}})
            assert c.get("j", "op", 2, 99, exact=False)[0]
            _close(c)

    def test_put_never_downgrades(self):
        for c in _both():
            c.put("j", "op", 1, 5, {1: {"v": 5.0}})
            c.put("j", "op", 1, 4, {1: {"v": 4.0}})  # stale worker
            assert c.get("j", "op", 1, 5, exact=False)[1] == \
                {1: {"v": 5.0}}
            _close(c)

    def test_prime_fold_insert_remove_drop(self):
        for c in _both():
            c.put("j", "op", 1, 1, {10: {"v": 1.0}, 20: {"v": 2.0}})
            c.put("j", "op", 2, 1, {30: {"v": 3.0}})
            c.prime_batch("j", "op", 2, _delta({
                1: ({20: {"v": 9.0}, 40: {"v": 4.0}}, [10], 0),
                2: (None, [], 2),            # drop
                3: ({50: {"v": 5.0}}, [], 1),  # insert_ok
                4: ({60: {"v": 6.0}}, [], 0),  # absent, no insert
            }))
            assert c.get("j", "op", 1, 2, exact=False)[1] == \
                {20: {"v": 9.0}, 40: {"v": 4.0}}
            assert not c.get("j", "op", 2, 2, exact=False)[0]
            assert c.get("j", "op", 3, 2, exact=False)[1] == \
                {50: {"v": 5.0}}
            assert not c.get("j", "op", 4, 2, exact=False)[0]
            _close(c)

    def test_get_many_batch_shapes(self):
        for c in _both():
            for k in range(8):
                c.put("j", "op", k, 1, {k: {"v": float(k)}})
            out = [None] * 12
            misses = []
            hits = c.get_many("j", "op",
                              np.arange(12, dtype=np.int64), 1, out,
                              misses, exact=False)
            assert hits == 8
            assert [int(k) for _i, k in misses] == [8, 9, 10, 11]
            assert out[:8] == [{k: {"v": float(k)}} for k in range(8)]
            _close(c)

    def test_empty_composed_state_hits(self):
        # a key cached with an EMPTY composed dict is a HIT returning
        # {} — distinct from a miss (the key is known to have no state)
        for c in _both():
            c.put("j", "op", 5, 1, {6: {"v": 1.0}})  # schema known
            c.put("j", "op", 9, 1, {})
            hit, got = c.get("j", "op", 9, 1, exact=False)
            assert hit and got == {}
            _close(c)

    def test_non_packable_values_identical(self):
        # join-style list results cannot pack: the native plane routes
        # them through its overflow store with identical semantics
        val = [{"ts": 1, "rid": 2, "x": "obj"}]
        for c in _both():
            c.put("j", "join", 1, 1, val)
            hit, got = c.get("j", "join", 1, 1, exact=False)
            assert hit and got == val
            _close(c)

    def test_invalidate_op_and_job(self):
        for c in _both():
            c.put("a", "op1", 1, 1, {1: {"v": 1.0}})
            c.put("a", "op2", 1, 1, {1: {"v": 2.0}})
            c.put("b", "op1", 1, 1, {1: {"v": 3.0}})
            c.invalidate_op("a", "op1")
            assert not c.get("a", "op1", 1, 1, exact=False)[0]
            assert c.get("a", "op2", 1, 1, exact=False)[0]
            c.invalidate_job("a")
            assert not c.get("a", "op2", 1, 1, exact=False)[0]
            assert c.get("b", "op1", 1, 1, exact=False)[0]
            _close(c)

    def test_drop(self):
        for c in _both():
            c.put("j", "op", 1, 1, {1: {"v": 1.0}})
            c.drop("j", "op", 1)
            assert not c.get("j", "op", 1, 1, exact=False)[0]
            _close(c)

    def test_stats_shape(self):
        for c in _both():
            c.put("j", "op", 1, 1, {1: {"v": 1.0}})
            c.get("j", "op", 1, 1, exact=False)
            c.get("j", "op", 2, 1, exact=False)
            s = c.stats()
            assert s["hot_row_hits"] == 1.0
            assert s["hot_row_misses"] == 1.0
            assert s["hot_row_entries"] == 1.0
            assert 0 < s["hot_row_hit_rate"] < 1
            assert c.hit_rate() == s["hot_row_hit_rate"]
            assert len(c) == 1
            _close(c)


@native
class TestNativeSpecific:
    def test_oversize_composition_stays_a_miss(self):
        from flink_tpu_torch.tenancy.hot_cache_native import ENTRY_CAP

        c = _native()
        big = {i: {"v": float(i)} for i in range(ENTRY_CAP + 3)}
        c.put("j", "op", 1, 1, {0: {"v": 0.0}})  # schema: packable op
        c.put("j", "op", 2, 1, big)
        # oversize rides the overflow store — still served, identically
        hit, got = c.get("j", "op", 2, 1, exact=False)
        assert hit and got == big
        _close(c)

    def test_eviction_under_pressure(self):
        from flink_tpu_torch.tenancy.hot_cache_native import (
            NativeHotRowCache,
        )

        c = NativeHotRowCache(max_entries=64)
        for k in range(1000):
            c.put("j", "op", k, 1, {1: {"v": float(k)}})
        assert len(c) <= 2 * 64  # bounded (pow2 slots, windowed evict)
        assert c.evictions > 0
        _close(c)

    def test_torn_read_falls_to_miss_never_mixed(self):
        # freeze a key's slot stamp ODD (a write frozen mid-flight):
        # the probe must retry, count the torn read, and MISS — never
        # return a half-written row. Unfreeze: it hits again.
        from flink_tpu_torch.native import load_hotcache

        lib = load_hotcache()
        c = _native()
        c.put("j", "op", 7, 1, {1: {"v": 1.0}})
        assert c.get("j", "op", 7, 1, exact=False)[0]
        tbl = c._tables[("j", "op")]
        assert lib.hc_debug_lock_slot(tbl.ptr, 7) == 1
        hit, got = c.get("j", "op", 7, 1, exact=False)
        assert not hit and got is None
        assert c.torn_retries > 0 and c.torn_misses > 0
        assert lib.hc_debug_unlock_slot(tbl.ptr, 7) == 1
        assert c.get("j", "op", 7, 1, exact=False) == \
            (True, {1: {"v": 1.0}})
        _close(c)

    def test_concurrent_prime_probe_never_mixed(self):
        # a writer re-priming one key with generation-consistent rows
        # while a reader hammers probes: every observed value is one of
        # the complete published states, never a mix
        import threading

        c = _native()
        states = [{1: {"a": float(g), "b": float(g)}} for g in range(50)]
        c.put("j", "op", 1, 0, states[0])
        stop = threading.Event()
        bad = []

        def reader():
            while not stop.is_set():
                hit, got = c.get("j", "op", 1, 0, exact=False)
                if hit and got[1]["a"] != got[1]["b"]:
                    bad.append(got)

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        for g in range(1, 50):
            c.prime_batch("j", "op", g, _delta({
                1: ({1: {"a": float(g), "b": float(g)}}, [], 0)}))
        stop.set()
        t.join(timeout=5)
        assert not bad, f"mixed-generation rows observed: {bad[:3]}"
        _close(c)


@native
class TestCrossGenerationFuzz:
    """Randomized interleaved prime/probe/put/drop/retire against a
    plain dict oracle, seeded — native and Python planes both tracked.
    Capacity is large enough that no eviction fires, so all three
    must agree EXACTLY at every probe."""

    def _oracle_prime(self, oracle, kid, gen, ups, rem, insert_ok):
        ent = oracle.get(kid)
        if ent is None and not insert_ok:
            return
        if ent is not None and ent[0] > gen:
            return
        val = dict(ent[1]) if ent is not None else {}
        for ns in rem:
            val.pop(ns, None)
        if ups:
            val.update(ups)
        oracle[kid] = (gen, val)

    def test_fuzz_vs_dict_oracle(self):
        rng = np.random.default_rng(1234)
        planes = _both()
        oracle = {}  # kid -> (gen, {ns: {col: val}})
        gen = 1
        KEYS = 64
        for step in range(1500):
            op = rng.integers(0, 10)
            kid = int(rng.integers(0, KEYS))
            if op < 3:  # put (worker feed), occasionally stale gen
                g = gen - int(rng.integers(0, 3))
                val = {int(ns): {"v": float(rng.random())}
                       for ns in rng.integers(0, 8,
                                              int(rng.integers(0, 4)))}
                for c in planes:
                    c.put("j", "op", kid, g, val)
                ent = oracle.get(kid)
                if ent is None or ent[0] <= g:
                    oracle[kid] = (g, val)
            elif op < 6:  # publish prime (fold) over a few keys
                gen += 1
                batch = {}
                for _ in range(int(rng.integers(1, 5))):
                    k2 = int(rng.integers(0, KEYS))
                    if k2 in batch:
                        continue  # a publish delta has ONE entry/key
                    kind = int(rng.integers(0, 4))
                    if kind == 0:  # drop
                        batch[k2] = (None, [], 2)
                        self._oracle_prime(oracle, k2, gen, None, [],
                                           False)
                        oracle.pop(k2, None)
                        continue
                    ups = {int(ns): {"v": float(rng.random())}
                           for ns in rng.integers(
                               0, 8, int(rng.integers(0, 3)))}
                    rem = [int(r) for r in rng.integers(
                        0, 8, int(rng.integers(0, 2)))]
                    insert_ok = kind == 1
                    batch[k2] = (ups, rem,
                                 1 if insert_ok else 0)
                    self._oracle_prime(oracle, k2, gen, ups, rem,
                                       insert_ok)
                for c in planes:
                    c.prime_batch("j", "op", gen, _delta(batch))
            elif op < 7:  # retire (drop)
                for c in planes:
                    c.drop("j", "op", kid)
                oracle.pop(kid, None)
            else:  # probe a batch, compare all three
                qk = rng.integers(0, KEYS, 16).astype(np.int64)
                want = [oracle.get(int(k), (None, None))[1]
                        for k in qk]
                for c in planes:
                    out = [None] * len(qk)
                    misses = []
                    c.get_many("j", "op", qk, gen, out, misses,
                               exact=False)
                    assert out == want, \
                        f"step {step}: {type(c).__name__} diverged"
                    assert sorted(i for i, _k in misses) == \
                        [i for i, w in enumerate(want) if w is None]
        for c in planes:
            _close(c)


class TestFactory:
    def test_knob_forces_python_plane(self, monkeypatch):
        monkeypatch.setenv("FLINK_TPU_NATIVE_HOTCACHE", "0")
        assert type(make_hot_row_cache(64)) is HotRowCache

    @native
    def test_selects_native_when_available(self, monkeypatch):
        from flink_tpu_torch.tenancy.hot_cache_native import NativeHotRowCache

        monkeypatch.delenv("FLINK_TPU_NATIVE_HOTCACHE", raising=False)
        monkeypatch.delenv("FLINK_TPU_NO_NATIVE", raising=False)
        c = make_hot_row_cache(64)
        assert type(c) is NativeHotRowCache
        _close(c)

    def test_blanket_native_off(self, monkeypatch):
        monkeypatch.setenv("FLINK_TPU_NO_NATIVE", "1")
        assert type(make_hot_row_cache(64)) is HotRowCache


class TestAcrossPackages:
    """The same seeded prime / put / drop / probe sequence through the
    reference's and the port's planes (native and Python each): every
    probe's answers, misses and packed form equal, and the counters."""

    def _ops(self, seed=7, steps=600, keys=96):
        rng = np.random.default_rng(seed)
        ops, gen = [], 1
        for _ in range(steps):
            op = int(rng.integers(0, 10))
            kid = int(rng.integers(0, keys))
            if op < 3:
                val = {int(ns): {"v": float(rng.random()),
                                 "n": int(rng.integers(0, 1 << 40))}
                       for ns in rng.integers(0, 8, int(rng.integers(1, 4)))}
                ops.append(("put", kid, gen - int(rng.integers(0, 2)), val))
            elif op < 6:
                gen += 1
                batch = {}
                for _ in range(int(rng.integers(1, 5))):
                    k2 = int(rng.integers(0, keys))
                    if k2 in batch:
                        continue
                    ups = {int(ns): {"v": float(rng.random()),
                                     "n": int(rng.integers(0, 1 << 40))}
                           for ns in rng.integers(0, 8,
                                                  int(rng.integers(1, 3)))}
                    batch[k2] = (ups, [int(rng.integers(0, 8))],
                                 int(rng.integers(0, 2)))
                ops.append(("prime", gen, batch))
            elif op < 7:
                ops.append(("drop", kid))
            else:
                ops.append(("probe", gen,
                            rng.integers(0, keys, 24).astype(np.int64)))
        return ops

    def _run(self, make, delta):
        from flink_tpu_torch.tenancy.hot_cache import PrimeDelta as TPD

        c = make()
        seen = []
        for op in self._ops():
            if op[0] == "put":
                c.put("j", "op", op[1], op[2], op[3])
            elif op[0] == "prime":
                d = _delta({k: v for k, v in op[2].items()})
                if delta is not TPD:
                    d = delta(d.keys, d.uoff, d.u_ns, d.u_cols, d.roff,
                              d.r_ns, d.flags)
                c.prime_batch("j", "op", op[1], d)
            elif op[0] == "drop":
                c.drop("j", "op", op[1])
            else:
                out, misses = [None] * len(op[2]), []
                c.get_many("j", "op", op[2], op[1], out, misses,
                           exact=False)
                seen.append((out, sorted(i for i, _ in misses)))
                packed = getattr(c, "get_many_packed", None)
                if packed is not None:
                    pout, pm = [None] * len(op[2]), []
                    hits, probe = packed("j", "op", op[2], op[1], pout, pm,
                                         exact=False)
                    got = [probe.materialize(i) if probe is not None
                           and pout[i] is None and i not in
                           {j for j, _ in pm} else pout[i]
                           for i in range(len(op[2]))]
                    assert got == out
        stats = c.stats()
        _close(c)
        return seen, stats

    @native
    @pytest.mark.parametrize("plane", ["native", "python"])
    def test_same_ops_same_answers_as_reference(self, plane):
        from flink_tpu.tenancy import hot_cache as ref_hc
        from flink_tpu.tenancy import hot_cache_native as ref_native
        from flink_tpu_torch.tenancy import hot_cache_native as port_native

        if plane == "native":
            mk_ref = lambda: ref_native.NativeHotRowCache(1 << 12)
            mk_port = lambda: port_native.NativeHotRowCache(1 << 12)
        else:
            mk_ref = lambda: ref_hc.HotRowCache(1 << 12)
            mk_port = lambda: HotRowCache(1 << 12)
        got = self._run(mk_port, PrimeDelta)
        want = self._run(mk_ref, ref_hc.PrimeDelta)
        assert got == want
        assert sum(1 for out, _ in got[0] for v in out if v) > 0

    def test_shm_dir_without_native_raises_like_reference(self, monkeypatch,
                                                          tmp_path):
        from flink_tpu.tenancy.hot_cache import (
            make_hot_row_cache as ref_make,
        )

        monkeypatch.setenv("FLINK_TPU_NATIVE_HOTCACHE", "0")
        for make in (make_hot_row_cache, ref_make):
            with pytest.raises(RuntimeError, match="shm_dir"):
                make(64, shm_dir=str(tmp_path))
