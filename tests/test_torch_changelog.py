"""The changelog backend of the port against the reference's on the CPU:
every case of ``tests/test_changelog.py`` (the writer's round trip, torn
frames, truncation; offset-only checkpoints, materialization and
subsumption, a truncated checkpoint failing loudly, recovery after a torn
tail, replayed frees, a randomized restore), each run on both packages;
the restored tables' float32 sums are equal bit for bit (tolerance:
none). Added: each package restores a changelog directory the other
wrote (the log is pickled NumPy frames, the materialization a
``SlotTable`` snapshot), and the restored table's snapshot equals the
writer's bit for bit.
"""

import os

import numpy as np
import pytest

from flink_tpu.checkpoint import changelog as jcl
from flink_tpu.windowing.aggregates import SumAggregate as JSum
from flink_tpu_torch.checkpoint import changelog as tcl
from flink_tpu_torch.windowing.aggregates import SumAggregate as TSum

PKGS = {
    "ref": (jcl, lambda d: jcl.ChangelogKeyedBackend(JSum("v"), d)),
    "port": (tcl, lambda d: tcl.ChangelogKeyedBackend(TSum("v"), d,
                                                       device="cpu")),
}


def scatter(backend, keys, ns, vals):
    backend.scatter(np.asarray(keys, dtype=np.int64),
                    np.asarray(ns, dtype=np.int64),
                    (np.asarray(vals, dtype=np.float32),))


def sums(backend, ns):
    """{key: float32 sum bits} of one namespace."""
    s = backend.table.slots_for_namespace(ns)
    res = backend.table.fire(s[:, None])
    return dict(zip(backend.table.keys_of_slots(s).tolist(),
                    np.asarray(res["sum_v"], np.float32).view(
                        np.uint32).tolist()))


def _f(bits):
    return {k: float(np.uint32(v).view(np.float32)) for k, v in bits.items()}


def _both(tmp_path, scenario):
    got = {}
    for name, (mod, make) in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        got[name] = scenario(mod, make, d)
    assert got["port"] == got["ref"]
    return got["port"]


class TestWriter:
    def test_append_flush_read_roundtrip(self, tmp_path):
        def s(mod, make, d):
            p = str(d / "log.bin")
            w = mod.ChangelogWriter(p)
            w.append("op", "scatter", {"x": np.arange(3)})
            w.append("op", "free", {"namespaces": [1, 2]})
            w.flush()
            entries = list(mod.read_entries(p))
            w.close()
            w2 = mod.ChangelogWriter(p)
            seq = w2.append("op", "free", {"namespaces": []})
            w2.close()
            return [e[0] for e in entries], entries[1][2], seq, \
                open(p, "rb").read()

        seqs, kind, seq, _ = _both(tmp_path, s)
        assert seqs == [0, 1] and kind == "free" and seq == 2

    def test_torn_final_frame_is_ignored(self, tmp_path):
        def s(mod, make, d):
            p = str(d / "log.bin")
            w = mod.ChangelogWriter(p)
            w.append("op", "scatter", {"x": np.arange(3)})
            w.flush()
            w.close()
            with open(p, "ab") as f:  # a crash mid-append
                f.write(b"FTCL\x99\x00\x00\x00\x00\x00\x00\x00partial")
            return len(list(mod.read_entries(p)))

        assert _both(tmp_path, s) == 1

    def test_truncate_drops_materialized_prefix(self, tmp_path):
        def s(mod, make, d):
            p = str(d / "log.bin")
            w = mod.ChangelogWriter(p)
            for i in range(5):
                w.append("op", "free", {"namespaces": [i]})
            w.truncate(3)
            out = [e[0] for e in mod.read_entries(p)]
            seq = w.append("op", "free", {"namespaces": []})
            w.close()
            return out, seq

        assert _both(tmp_path, s) == ([3, 4], 5)

    @pytest.mark.parametrize("writer", ["ref", "port"])
    def test_each_package_reads_the_others_log(self, tmp_path, writer):
        reader = {"ref": "port", "port": "ref"}[writer]
        p = str(tmp_path / "log.bin")
        w = PKGS[writer][0].ChangelogWriter(p)
        w.append("op", "scatter", {"key_id": np.arange(4),
                                   "values": (np.ones(4, np.float32),)})
        w.close()
        (seq, uid, kind, payload), = PKGS[reader][0].read_entries(p)
        assert (seq, uid, kind) == (0, "op", "scatter")
        np.testing.assert_array_equal(payload["key_id"], np.arange(4))
        w2 = PKGS[reader][0].ChangelogWriter(p)
        assert w2.append("op", "free", {"namespaces": [1]}) == 1
        w2.close()


class TestChangelogBackend:
    def test_checkpoint_is_offset_only_and_restores_exactly(self, tmp_path):
        def s(mod, make, d):
            b = make(str(d / "cl"))
            scatter(b, [1, 2, 1], [10, 10, 10], [1.0, 2.0, 3.0])
            ck = b.checkpoint()
            scatter(b, [1], [10], [100.0])  # after the checkpoint's cut
            b.close()
            b2 = make(str(d / "cl"))
            b2.restore(ck)
            out = sums(b2, 10)
            b2.close()
            return ck, out

        ck, out = _both(tmp_path, s)
        assert _f(out) == {1: 4.0, 2: 2.0}

    def test_materialize_and_subsumption_bound_replay(self, tmp_path):
        def s(mod, make, d):
            b = make(str(d / "cl"))
            scatter(b, [1, 2], [10, 10], [1.0, 2.0])
            mat_ck = b.materialize()
            log = os.path.join(str(d / "cl"), "changelog.bin")
            n_before = len(list(mod.read_entries(log)))
            b.truncate_subsumed(mat_ck["changelog_seq"])
            n_after = len(list(mod.read_entries(log)))
            scatter(b, [2, 3], [10, 10], [5.0, 7.0])
            b.free_namespaces([99])  # a no-op free is still logged
            ck = b.checkpoint()
            b.close()
            b2 = make(str(d / "cl"))
            b2.restore(ck)
            out = sums(b2, 10)
            b2.close()
            return n_before, n_after, out

        n_before, n_after, out = _both(tmp_path, s)
        assert (n_before, n_after) == (1, 0)
        assert _f(out) == {1: 1.0, 2: 7.0, 3: 7.0}

    def test_checkpoint_survives_later_materialization(self, tmp_path):
        def s(mod, make, d):
            b = make(str(d / "cl"))
            scatter(b, [1], [10], [1.0])
            early_ck = b.checkpoint()
            scatter(b, [1], [10], [10.0])
            b.materialize()
            b.close()
            b2 = make(str(d / "cl"))
            b2.restore(early_ck)
            out = sums(b2, 10)
            b2.close()
            return out

        assert _f(_both(tmp_path, s)) == {1: 1.0}

    def test_truncated_checkpoint_fails_loudly(self, tmp_path):
        for name, (mod, make) in PKGS.items():
            d = str(tmp_path / name)
            b = make(d)
            scatter(b, [1], [10], [1.0])
            early_ck = b.checkpoint()
            scatter(b, [1], [10], [10.0])
            mat = b.materialize()
            b.truncate_subsumed(mat["changelog_seq"])
            b.close()
            b2 = make(d)
            with pytest.raises(RuntimeError, match="not\\s+restorable"):
                b2.restore(early_ck)
            b2.close()

    def test_recovery_after_torn_tail_preserves_new_appends(self, tmp_path):
        def s(mod, make, d):
            p = str(d / "cl" / "changelog.bin")
            b = make(str(d / "cl"))
            scatter(b, [1], [10], [1.0])
            b.writer.flush()
            b.close()
            with open(p, "ab") as f:
                f.write(b"FTCL" + b"\xff" * 12)  # a torn frame
            b2 = make(str(d / "cl"))
            b2.restore({"changelog_seq": b2.writer.next_sequence,
                        "materialized_seq": 0})
            scatter(b2, [2], [10], [2.0])
            ck = b2.checkpoint()
            b2.close()
            b3 = make(str(d / "cl"))
            b3.restore(ck)
            out = sums(b3, 10)
            b3.close()
            return out

        assert _f(_both(tmp_path, s)) == {1: 1.0, 2: 2.0}

    def test_free_is_replayed(self, tmp_path):
        def s(mod, make, d):
            b = make(str(d / "cl"))
            scatter(b, [1, 2], [10, 10], [1.0, 2.0])
            scatter(b, [1, 2], [20, 20], [3.0, 4.0])
            b.free_namespaces([10])
            ck = b.checkpoint()
            b.close()
            b2 = make(str(d / "cl"))
            b2.restore(ck)
            out = sums(b2, 10), sums(b2, 20)
            b2.close()
            return out

        s10, s20 = _both(tmp_path, s)
        assert s10 == {} and _f(s20) == {1: 3.0, 2: 4.0}

    def test_restore_equals_direct_state_randomized(self, tmp_path):
        """The reference's test holds the restore within 1e-3; here the
        replay re-runs the scatters in log order, so the restored sums
        equal the live table's bit for bit, in both packages, and the
        port's equal the reference's."""
        def s(mod, make, d):
            rng = np.random.default_rng(11)
            b = make(str(d / "cl"))
            for step in range(10):
                keys = rng.integers(0, 40, 100)
                ns = rng.integers(1, 4, 100) * 10
                vals = rng.random(100)
                scatter(b, keys, ns, vals)
                if step == 4:
                    b.materialize()
                if step == 7:
                    b.free_namespaces([10])
            expected = {ns: sums(b, ns) for ns in (10, 20, 30)}
            ck = b.checkpoint()
            b.close()
            b2 = make(str(d / "cl"))
            b2.restore(ck)
            got = {ns: sums(b2, ns) for ns in (10, 20, 30)}
            b2.close()
            assert got == expected
            return got

        _both(tmp_path, s)


def _write_log(backend):
    rng = np.random.default_rng(17)
    for step in range(12):
        keys = rng.integers(0, 200, 500)
        ns = rng.integers(0, 5, 500)
        vals = rng.normal(size=500).astype(np.float32)
        vals[::37] = np.float32("nan")
        scatter(backend, keys, ns, vals)
        if step == 5:
            backend.materialize()
        if step == 8:
            backend.free_namespaces([1])
    ck = backend.checkpoint()
    snap = backend.table.snapshot()
    backend.close()
    return ck, snap


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_package_restores_the_others_changelog(tmp_path, writer,
                                                    reader):
    """A materialization plus a log tail written by one package restores
    in the other: every column of the restored table's snapshot equals
    the writer's live snapshot bit for bit (float32 sums, NaN lanes
    included)."""
    d = str(tmp_path / "cl")
    ck, want = _write_log(PKGS[writer][1](d))
    b = PKGS[reader][1](d)
    b.restore(ck)
    got = b.table.snapshot()
    b.close()
    assert sorted(got) == sorted(want)
    for col in want:
        g, w = np.asarray(got[col]), np.asarray(want[col])
        assert g.dtype == w.dtype, col
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
