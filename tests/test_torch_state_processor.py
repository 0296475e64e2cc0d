"""The State Processor API (``SavepointReader``, ``SavepointWriter``,
``KeyedStateBootstrap``) of the port against the reference, on the CPU.

The cases are the ``SavepointReader``/``SavepointWriter`` cases of
``tests/test_savepoints.py`` (``TestStateProcessor``, ``TestRestoreModes``
and the monotonic-id case). The same count pipeline checkpoints in both
packages; each package's reader reads both packages' checkpoints (the
on-disk format is the reference's) and the keyed tables compare bit for
bit; a savepoint bootstrapped or transformed by the port's writer restores
into a port job with the rows the reference's gives.
"""

import os

import numpy as np
import pytest

from tests.test_torch_mesh_sessions import _bits
from tests.test_torch_sql import PKGS, assert_batches_equal


def _sp(p):
    return p.mod("state_processor")


def build_count_pipeline(p, env, total, num_keys=40, rate=10_000):
    sink = p.CollectSink()
    src = p.mod("connectors.sources").DataGenSource(
        total_records=total, num_keys=num_keys,
        events_per_second_of_eventtime=rate)
    wm = p.mod("runtime.watermarks").WatermarkStrategy
    win = p.mod("windowing.assigners").TumblingEventTimeWindows
    (env.add_source(src, wm.for_bounded_out_of_orderness(0)).key_by("key")
        .window(win.of(1000)).count().sink_to(sink))
    return sink


def _checkpointed(p, ck, total=8_000, num_keys=16, every=2, **kw):
    env = p.Env(p.config(**{
        "execution.micro-batch.size": 512, "state.checkpoints.dir": ck,
        "execution.checkpointing.every-n-source-batches": every}))
    sink = build_count_pipeline(p, env, total, num_keys=num_keys, **kw)
    result = env.execute("sp")
    return sink, result


def _keyed_uid(reader):
    uids = [u for u in reader.operators() if reader.has_keyed_state(u)]
    assert len(uids) == 1
    return uids[0]


def test_read_keyed_state_equals_the_reference_across_packages(tmp_path):
    cks = {}
    for name, p in PKGS.items():
        cks[name] = str(tmp_path / name)
        _checkpointed(p, cks[name])
    tables = {}
    for reader_pkg in ("port", "reference"):
        for ck_pkg in ("port", "reference"):
            reader = _sp(PKGS[reader_pkg]).SavepointReader.load(cks[ck_pkg])
            uid = _keyed_uid(reader)
            batch = reader.read_keyed_state(uid)
            tables[(reader_pkg, ck_pkg)] = (
                uid, reader.job_name, reader.checkpoint_id, sorted(
                    reader.operators()),
                {c: _bits(np.asarray(batch[c])).tolist()
                 for c in batch.columns})
    first = tables[("reference", "reference")]
    assert all(v == first for v in tables.values())
    cols = first[4]
    assert {"key_id", "namespace", "key_group", "leaf_0"} <= set(cols)
    assert 0 <= min(cols["key_group"]) and max(cols["key_group"]) < 128


def test_read_state_and_source_position(tmp_path):
    p = PKGS["port"]
    ck = str(tmp_path / "ck")
    _checkpointed(p, ck)
    reader = _sp(p).SavepointReader.load(ck)
    src_uid = [u for u in reader.operators()
               if "source" in reader.read_state(u)][0]
    assert reader.read_source_position(src_uid)
    with pytest.raises(KeyError, match="no state for operator"):
        reader.read_state("nope")
    with pytest.raises(ValueError, match="not a source"):
        reader.read_source_position(_keyed_uid(reader))


def _counts(rows):
    return {(int(r["key"]), int(r["window_start"])): int(r["count"])
            for r in rows}


def test_bootstrap_and_restore(tmp_path):
    """A savepoint written from raw columns seeds a job: key 0's first
    window gets 1,000 more counts, every other row equals the plain run's
    (the reference's case), in both packages."""
    seeded_by = {}
    for name, p in PKGS.items():
        d = tmp_path / name
        _checkpointed(p, str(d / "probe-ck"), total=4_000, num_keys=4,
                      every=1, rate=4_000)
        reader = _sp(p).SavepointReader.load(str(d / "probe-ck"))
        window_uid = _keyed_uid(reader)
        source_uid = [u for u in reader.operators()
                      if "source" in reader.read_state(u)][0]
        probe = reader.read_state(window_uid)
        boot = _sp(p).KeyedStateBootstrap(
            key_ids=[0], namespaces=[1000], leaves=[np.array([1000])])
        state = {k: v for k, v in probe.items() if k != "windower"}
        state["windower"] = {"table": boot.table, "pending": [1000],
                             "slice_last_window": {1000: 1000}}
        fresh = p.mod("connectors.sources").DataGenSource(
            total_records=4_000, num_keys=4,
            events_per_second_of_eventtime=4_000)
        fresh.open()
        (_sp(p).SavepointWriter.new_savepoint("boot-job")
         .with_operator(window_uid, state)
         .with_operator(source_uid, {"source": fresh.snapshot_position()})
         .write(str(d / "boot")))
        plain_env = p.Env(p.config(**{"execution.micro-batch.size": 512}))
        plain = build_count_pipeline(p, plain_env, 4_000, num_keys=4,
                                     rate=4_000)
        plain_env.execute("plain")
        env = p.Env(p.config(**{"execution.micro-batch.size": 512}))
        seeded = build_count_pipeline(p, env, 4_000, num_keys=4, rate=4_000)
        env.execute("from-boot", restore_from=str(d / "boot"))
        want = _counts(plain.rows())
        want[(0, 0)] += 1000
        assert _counts(seeded.rows()) == want
        seeded_by[name] = seeded.result()
    assert_batches_equal(seeded_by["port"], seeded_by["reference"])


def test_remove_operator_and_transform(tmp_path):
    p = PKGS["port"]
    ck = str(tmp_path / "ck")
    _checkpointed(p, ck)
    sp = _sp(p)
    w = sp.SavepointWriter.from_existing(ck)
    uid = list(w._states)[0]
    w.remove_operator(uid).write(str(tmp_path / "derived"))
    assert uid not in sp.SavepointReader.load(
        str(tmp_path / "derived")).operators()
    keyed = _keyed_uid(sp.SavepointReader.load(ck))

    def double(state):
        t = dict(state["windower"]["table"])
        t["leaf_0"] = np.asarray(t["leaf_0"]) * 2
        return {**state, "windower": {**state["windower"], "table": t}}

    sp.SavepointWriter.from_existing(ck).transform_operator(
        keyed, double).write(str(tmp_path / "doubled"))
    a = sp.SavepointReader.load(ck).read_keyed_state(keyed)
    b = sp.SavepointReader.load(
        str(tmp_path / "doubled")).read_keyed_state(keyed)
    np.testing.assert_array_equal(np.asarray(a["leaf_0"]) * 2, b["leaf_0"])
    with pytest.raises(KeyError, match="no operator"):
        sp.SavepointWriter.from_existing(ck).transform_operator(
            "nope", double)


def test_writer_refuses_overwrite(tmp_path):
    sp = _sp(PKGS["port"])
    target = str(tmp_path / "x")
    sp.SavepointWriter.new_savepoint().with_operator(
        "op", {"table": {"key_id": np.array([1]), "namespace": np.array([1]),
                         "key_group": np.array([0])}}).write(target)
    with pytest.raises(FileExistsError):
        sp.SavepointWriter.new_savepoint().with_operator(
            "op", {"k": np.array([1])}).write(target)


def test_bootstrap_rejects_misaligned_columns():
    for p in PKGS.values():
        with pytest.raises(ValueError, match="align"):
            _sp(p).KeyedStateBootstrap(key_ids=[1, 2], namespaces=[1],
                                       leaves=[np.array([1, 2])])
        with pytest.raises(ValueError, match="align"):
            _sp(p).KeyedStateBootstrap(key_ids=[1, 2], namespaces=[1, 2],
                                       leaves=[np.array([1])])


@pytest.mark.parametrize("mode", ["no-claim", "claim"])
def test_restore_modes_from_a_written_savepoint(tmp_path, mode):
    p = PKGS["port"]
    src_ck = str(tmp_path / "ck-src")
    _checkpointed(p, src_ck, total=5_000, num_keys=40, every=3)
    sp_dir = str(tmp_path / "the-savepoint")
    _sp(p).SavepointWriter.from_existing(src_ck).write(sp_dir)
    env = p.Env(p.config(**{
        "execution.micro-batch.size": 512,
        "state.checkpoints.dir": str(tmp_path / "ck-new"),
        "execution.checkpointing.every-n-source-batches": 2}))
    build_count_pipeline(p, env, 20_000)
    env.execute("resume", restore_from=sp_dir, restore_mode=mode)
    assert os.path.exists(os.path.join(sp_dir, "manifest.json")) == (
        mode == "no-claim")


def test_restore_older_savepoint_keeps_checkpoint_ids_monotonic(tmp_path):
    p = PKGS["port"]
    ck = str(tmp_path / "ck")
    _checkpointed(p, ck, total=5_000, num_keys=40, every=1)
    stale_max = max(int(n[4:]) for n in os.listdir(ck)
                    if n.startswith("chk-"))
    sp_dir = str(tmp_path / "old-sp")
    w = _sp(p).SavepointWriter.from_existing(ck)
    w.checkpoint_id = 1
    w.write(sp_dir)
    env = p.Env(p.config(**{
        "execution.micro-batch.size": 256, "state.checkpoints.dir": ck,
        "execution.checkpointing.every-n-source-batches": 1}))
    build_count_pipeline(p, env, 10_000)
    r = env.execute("resumed", restore_from=sp_dir)
    ids = [c["id"] for c in r.metrics["checkpoints"]]
    assert ids and min(ids) > stale_max
    latest = p.mod("checkpoint.storage").resolve_snapshot_dir(ck)
    assert int(latest.rsplit("chk-", 1)[1]) > stale_max
