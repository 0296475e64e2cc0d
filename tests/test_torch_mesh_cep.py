"""The port's device CEP engine (``flink_tpu_torch/cep/mesh_engine.py``)
against the reference's (``flink_tpu/cep/mesh_engine.py``) on the CPU:
the reference's device backend on the virtual devices of
``tests/conftest.py`` (P=8 and P=4 meshes), the port on a logical mesh of
as many shards on the CPU, and both against the port's ``backend="host"``
(the host ``CepOperator``).

The counterparts of ``tests/test_mesh_cep.py`` and
``tools/cep_smoke.py``:
- the 3-stage within sequence under both skips, the consecutive
  ``times(2, 3)`` loop and the two widest layouts (Q=29 with R=7 and
  R=29): every emitted batch equal, in order, to the reference's device
  engine and to the host backend;
- forced eviction (the always-alive pattern, keys far above the slot
  budget): spill counters equal to the reference's and engaged, every
  advance's real lanes on unique non-zero slots and its padded lanes on
  slot 0 with no due events;
- late rows dropped and counted like the reference; ``query_match_batch``
  equal to the reference's;
- snapshots equal to the reference's key for key and array for array,
  restores (from either package's snapshot) continuing equal;
- ``MeshCepOperator``: the loud host fallback and the executor path;
- each feature that is not ported raising and naming its ROADMAP item;
- the default device (the card) raising without CUDA;
- ``benchmarks/cep.py``'s check at a small record count.

Tolerance: none — batches compared column by column, bit for bit, with
their names, dtypes and timestamps.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from flink_tpu.cep import MeshCepEngine as JEngine
from flink_tpu.cep.pattern import AfterMatchSkipStrategy as JSkip
from flink_tpu.cep.pattern import Pattern as JPattern
from flink_tpu.core.records import RecordBatch as JRecordBatch
from flink_tpu.parallel.mesh import make_mesh as jmake_mesh
from flink_tpu_torch.cep import kernels
from flink_tpu_torch.cep.mesh_engine import MeshCepEngine, host_fallbacks
from flink_tpu_torch.cep.pattern import AfterMatchSkipStrategy as Skip
from flink_tpu_torch.cep.pattern import Pattern
from flink_tpu_torch.core.records import RecordBatch

PORT = (Pattern, Skip, RecordBatch)
REF = (JPattern, JSkip, JRecordBatch)


def seq3(P, S, skip="past", within=50):
    sk = S.SKIP_PAST_LAST_EVENT if skip == "past" else S.NO_SKIP
    p = (P.begin("a", skip=sk)
         .where(lambda b: np.asarray(b["v"]) % 3 == 0)
         .next("b").where(lambda b: np.asarray(b["v"]) % 3 == 1)
         .next("c").where(lambda b: np.asarray(b["v"]) % 3 == 2))
    return p.within(within) if within else p


def churn(P, S):
    """Always-alive: the virtual start keeps every seen key resident, so
    eviction is FORCED once keys exceed the slot budget."""
    return (P.begin("a", skip=S.SKIP_PAST_LAST_EVENT)
            .next("b").where(lambda b: np.asarray(b["v"]) == 7))


def loop(P, S):
    return (P.begin("a", skip=S.NO_SKIP)
            .where(lambda b: np.asarray(b["v"]) < 5)
            .times(2, 3).consecutive()
            .next("end").where(lambda b: np.asarray(b["v"]) >= 7)
            .within(60))


def wide_r7(P, S):
    """times(1,3)/(1,3)/(1,2) consecutive within 100: Q=29, R=7."""
    return (P.begin("a", skip=S.NO_SKIP)
            .where(lambda b: np.asarray(b["v"]) % 3 == 0)
            .times(1, 3).consecutive()
            .next("b").where(lambda b: np.asarray(b["v"]) % 3 == 1)
            .times(1, 3).consecutive()
            .next("c").where(lambda b: np.asarray(b["v"]) % 3 == 2)
            .times(1, 2).consecutive().within(100))


def wide_r29(P, S):
    """times(1,30).consecutive(): Q=29, R=29."""
    return (P.begin("a", skip=S.NO_SKIP)
            .where(lambda b: np.asarray(b["v"]) < 8)
            .times(1, 30).consecutive())


def gen_steps(seed, n_steps=10, n_keys=40, batch=256, stride=25, spread=30):
    rng = np.random.default_rng(seed)
    ts = 0
    steps = []
    for _ in range(n_steps):
        keys = rng.integers(0, n_keys, size=batch).astype(np.int64)
        vals = rng.integers(0, 9, size=batch).astype(np.int64)
        tss = ts + np.sort(rng.integers(0, spread, size=batch)).astype(
            np.int64)
        ts += stride
        steps.append((keys, vals, tss, ts - 5))
    return steps


def mk_batch(cls, keys, vals, tss):
    return cls.from_pydict({"k": keys, "v": vals, "__key_id__": keys},
                           timestamps=tss)


def run(engine, steps, cls, hook=None):
    out = []
    for i, (keys, vals, tss, wm) in enumerate(steps):
        out.extend(engine.process_batch(mk_batch(cls, keys, vals, tss)))
        out.extend(engine.on_watermark(wm))
        if hook:
            engine = hook(engine, i) or engine
    return out, engine


_U = {1: np.uint8, 4: np.uint32, 8: np.uint64}


def _bits(a):
    a = np.asarray(a)
    return a.view(_U[a.dtype.itemsize]) if a.dtype.kind == "f" else a


def assert_batches_equal(got, want):
    """Same batches, same order, same columns and dtypes, equal bits."""
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(got, want):
        assert sorted(a.names()) == sorted(b.names())
        assert len(a) == len(b)
        for n in b.names():
            x, y = np.asarray(a[n]), np.asarray(b[n])
            assert x.dtype == y.dtype, (n, x.dtype, y.dtype)
            np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=n)


def assert_snapshots_equal(got, want, path=""):
    """Snapshot dicts equal key by key, arrays bit for bit."""
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_snapshots_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        g = np.asarray(got)
        assert g.dtype == want.dtype, (path, g.dtype, want.dtype)
        np.testing.assert_array_equal(_bits(g), _bits(want), err_msg=path)
    else:
        assert got == want, path


def port(make, shards=2, capacity=256, **kw):
    return MeshCepEngine(make(*PORT[:2]), key_field="k", num_shards=shards,
                         device="cpu", capacity_per_shard=capacity, **kw)


def ref(make, shards=2, capacity=256, **kw):
    return JEngine(make(*REF[:2]), key_field="k", mesh=jmake_mesh(shards),
                   capacity_per_shard=capacity, max_parallelism=128, **kw)


def host(make):
    return MeshCepEngine(make(*PORT[:2]), key_field="k", backend="host")


CASES = {
    "seq3_skip_past": (lambda P, S: seq3(P, S, "past"),
                       dict(seed=7, n_steps=12, n_keys=17, batch=64)),
    "seq3_no_skip": (lambda P, S: seq3(P, S, "none"),
                     dict(seed=7, n_steps=12, n_keys=17, batch=64)),
    "times_loop": (loop, dict(seed=11, n_keys=40)),
    "wide_r7": (wide_r7, dict(seed=13, n_steps=8, n_keys=24, batch=128)),
    "wide_r29": (wide_r29, dict(seed=17, n_steps=6, n_keys=30, batch=128,
                                spread=60)),
}


@pytest.mark.parametrize("shards", [8, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_engine_equals_reference_and_host_backend(case, shards):
    make, gen = CASES[case]
    steps = gen_steps(**gen)
    want, _ = run(ref(make, shards), steps, JRecordBatch)
    got, eng = run(port(make, shards), steps, RecordBatch)
    hst, _ = run(host(make), steps, RecordBatch)
    assert want, "vacuous: the reference emitted nothing"
    assert_batches_equal(got, want)
    assert_batches_equal(got, hst)
    if case.startswith("wide"):
        assert (eng._layout.n_states, eng._layout.ring) == (
            (29, 7) if case == "wide_r7" else (29, 29))


@pytest.mark.parametrize("shards,batch", [(2, 256), (8, 1024)])
def test_forced_eviction_equals_reference_with_unique_slots(
        shards, batch, tmp_path, monkeypatch):
    """Keys >> slot budget: the spill tier churns (asserted), output and
    counters equal the reference's, and every advance writes real lanes
    to unique non-zero slots (padded lanes: slot 0, no due events)."""
    steps = gen_steps(11, n_keys=5000, batch=batch)
    want_eng = ref(churn, shards, spill_dir=str(tmp_path / "ref"))
    want, want_eng = run(want_eng, steps, JRecordBatch)
    calls = []
    plain = kernels.cep_advance

    def checked(planes, pending, slots, idx, wok, nev, tables, steps=None):
        s, n = slots.numpy(), nev.numpy()
        for p in range(s.shape[0]):
            real = s[p] != 0
            assert len(np.unique(s[p][real])) == int(real.sum())
            assert not n[p][~real].any()
        calls.append(int((s != 0).sum()))
        return plain(planes, pending, slots, idx, wok, nev, tables,
                     steps=steps)

    monkeypatch.setattr(kernels, "cep_advance", checked)
    got, eng = run(port(churn, shards, spill_dir=str(tmp_path / "port")),
                   steps, RecordBatch)
    assert_batches_equal(got, want)
    assert_batches_equal(got, run(host(churn), steps, RecordBatch)[0])
    sc = eng.spill_counters()
    assert sc == want_eng.spill_counters()
    assert sc["rows_evicted"] > 0 and sc["rows_reloaded"] > 0
    assert eng.shard_resident_rows() == want_eng.shard_resident_rows()
    assert len(calls) == len(steps) and sum(calls) > 0


def test_late_rows_dropped_like_reference():
    steps = gen_steps(3, n_keys=10, batch=32)
    keys, vals, tss, _ = steps[0]
    engines = [(ref(seq3), JRecordBatch), (port(seq3), RecordBatch),
               (host(seq3), RecordBatch)]
    outs = []
    for e, cls in engines:
        out, _ = run(e, steps, cls)
        outs.append(out)
        assert e.process_batch(mk_batch(cls, keys, vals, tss)) == []
        assert e.late_dropped >= len(keys)
    assert engines[0][0].late_dropped == engines[1][0].late_dropped \
        == engines[2][0].late_dropped
    assert_batches_equal(outs[1], outs[0])
    assert_batches_equal(outs[1], outs[2])


def test_query_match_batch_equals_reference():
    def pat(P, S):
        return (P.begin("a", skip=S.SKIP_PAST_LAST_EVENT)
                .where(lambda b: np.asarray(b["v"]) % 3 == 0)
                .next("b").where(lambda b: np.asarray(b["v"]) % 3 == 1)
                .within(50))

    steps = gen_steps(3, n_steps=10, n_keys=30, batch=128)
    _, j = run(ref(pat, 8, match_capacity=64), steps, JRecordBatch)
    _, e = run(port(pat, 8, match_capacity=64), steps, RecordBatch)
    q = np.arange(30, dtype=np.int64)
    live = e.query_match_batch(q)
    assert live == j.query_match_batch(q)
    assert sum(len(r) for r in live) > 0
    assert e.matches_emitted == j.matches_emitted > 0


@pytest.mark.parametrize("case,shards", [("seq3_skip_past", 8),
                                         ("times_loop", 4),
                                         ("wide_r7", 8)])
def test_snapshot_equals_reference_and_restores(case, shards, tmp_path):
    make, gen = CASES[case]
    steps = gen_steps(**{**gen, "n_keys": 300, "batch": 256})
    snaps = {}

    def grab(tag):
        def hook(e, i):
            if i == 5:
                snaps[tag] = e.snapshot()
        return hook

    want, _ = run(ref(make, shards), steps, JRecordBatch, grab("ref"))
    got, _ = run(port(make, shards), steps, RecordBatch, grab("port"))
    assert_batches_equal(got, want)
    assert_snapshots_equal(snaps["port"], snaps["ref"])

    for src in ("port", "ref"):
        def restore(e, i, src=src):
            if i == 5:
                e2 = port(make, shards)
                e2.restore(snaps[src])
                return e2

        cont, _ = run(port(make, shards), steps, RecordBatch, restore)
        assert_batches_equal(cont, want)


def test_snapshot_with_pages_equals_reference(tmp_path):
    """A snapshot taken while the page tier holds cold keys: its state
    table (resident rows, then page rows) equals the reference's, and a
    restore continues equal."""
    steps = gen_steps(11, n_steps=8, n_keys=5000, batch=256)
    snaps = {}

    def grab(tag):
        def hook(e, i):
            if i == 4:
                snaps[tag] = e.snapshot()
        return hook

    want, _ = run(ref(churn, 2, spill_dir=str(tmp_path / "r")), steps,
                  JRecordBatch, grab("ref"))
    run(port(churn, 2, spill_dir=str(tmp_path / "p")), steps, RecordBatch,
        grab("port"))
    assert snaps["port"]["spill"]["rows_evicted"] > 0
    assert_snapshots_equal(snaps["port"], snaps["ref"])

    def restore(e, i):
        if i == 4:
            e2 = port(churn, 2, spill_dir=str(tmp_path / "p2"))
            e2.restore(snaps["ref"])
            return e2

    cont, _ = run(port(churn, 2, spill_dir=str(tmp_path / "p3")), steps,
                  RecordBatch, restore)
    assert_batches_equal(cont, want)


def test_host_backend_snapshot_restores():
    steps = gen_steps(5, n_keys=20, batch=64)
    want, _ = run(host(seq3), steps, RecordBatch)

    def restore(e, i):
        if i == 4:
            e2 = host(seq3)
            e2.restore(e.snapshot())
            return e2

    got, _ = run(host(seq3), steps, RecordBatch, restore)
    assert_batches_equal(got, want)


# ------------------------------------------------------------ the operator


class _Ctx:
    parallelism = 8
    max_parallelism = 128
    device = "cpu"
    shuffle_mode = "device"


def test_operator_falls_back_loudly():
    from flink_tpu_torch.cep import MeshCepOperator

    pat = (Pattern.begin("a").where(lambda b: np.asarray(b["v"]) > 0)
           .one_or_more().greedy()
           .next("b").where(lambda b: np.asarray(b["v"]) < 0))
    op = MeshCepOperator(pat, key_field="k")
    before = host_fallbacks()
    op.open(_Ctx())
    assert host_fallbacks() == before + 1
    assert op.engine.backend == "host"
    ok = MeshCepOperator(seq3(Pattern, Skip), key_field="k")
    ok.open(_Ctx())
    assert host_fallbacks() == before + 1
    assert ok.engine.backend == "device" and ok.engine.P == 8


def test_operator_through_execute_equals_host_operator():
    """A ``Transformation`` whose factory is ``MeshCepOperator`` (as the
    reference's SQL planner builds one) through ``env.execute`` at P=8:
    rows equal, in order, to ``CEP.pattern(keyed, p).select()``'s."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.cep import CEP, MeshCepOperator
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.datastream.stream import DataStream
    from flink_tpu_torch.graph.transformations import Transformation

    rng = np.random.default_rng(4)
    n = 3000
    rows = [{"k": int(k), "v": int(v), "t": int(t)} for k, v, t in zip(
        rng.integers(0, 50, n), rng.integers(0, 9, n),
        np.arange(n) * 3 + rng.integers(0, 8, n))]
    pat = seq3(Pattern, Skip)
    outs = []
    for mode in ("device", "host"):
        env = StreamExecutionEnvironment(Configuration({
            "parallelism.default": 8, "execution.micro-batch.size": 256,
            "execution.device": "cpu"}))
        keyed = env.from_collection(rows, timestamp_field="t").key_by("k")
        if mode == "device":
            t = Transformation(
                name="match_recognize", kind="one_input",
                operator_factory=lambda: MeshCepOperator(
                    pat, key_field="k", capacity=256),
                inputs=[keyed.transformation], keyed=True, key_field="k")
            stream = DataStream(env, t)
        else:
            stream = CEP.pattern(keyed, pat).select()
        sink = CollectSink()
        stream.sink_to(sink)
        env.execute()
        outs.append(sink.batches)
    assert sum(len(b) for b in outs[1]) > 0
    assert_batches_equal(outs[0], outs[1])


# ------------------------------------------------------- not in this slice

_ROADMAP = (pathlib.Path(__file__).resolve().parent.parent
            / "ROADMAP.md").read_text()


def _item(exc) -> str:
    m = re.search(r"Queue A item (\w+)", str(exc.value))
    assert m, str(exc.value)
    assert f"**Item {m.group(1)} " in _ROADMAP, m.group(1)
    return m.group(1)


@pytest.mark.parametrize("call,item", [
    (lambda e: e.reshard(2), "12g"),
    (lambda e: e.arm_match_replica(), "12f"),
    (lambda e: MeshCepEngine(seq3(Pattern, Skip), num_shards=2,
                             device="cpu", shuffle_mode="host"), "12h"),
])
def test_unported_features_raise_naming_their_item(call, item):
    if item == "12g":
        # item 12g is ported: a reshard mid-stream (4 -> 2 shards) lifts
        # state, pending rows and matches like the reference's, and the
        # rest of the stream matches bit for bit
        eng, want = port(seq3, shards=4), ref(seq3, shards=4)
        steps = gen_steps(5, n_steps=8, n_keys=23, batch=96)
        got_out, _ = run(eng, steps[:4], RecordBatch)
        want_out, _ = run(want, steps[:4], JRecordBatch)
        got_rep, want_rep = call(eng), call(want)
        assert got_rep["rows_moved"] == want_rep["rows_moved"] > 0
        assert eng.P == want.P == 2
        got_more, _ = run(eng, steps[4:], RecordBatch)
        want_more, _ = run(want, steps[4:], JRecordBatch)
        assert_batches_equal(got_out + got_more, want_out + want_more)
        assert_batches_equal(eng.on_watermark(1 << 40),
                             want.on_watermark(1 << 40))
        return
    if item == "12f":
        # item 12f is ported: the matched-pattern replica answers as the
        # reference's at every fire (tests/test_torch_replica.py at size)
        eng, want = port(seq3), ref(seq3)
        ta, ja = call(eng), call(want)
        steps = gen_steps(7, n_steps=6, n_keys=17, batch=64)
        run(eng, steps, RecordBatch)
        run(want, steps, JRecordBatch)
        q = list(range(20))
        got = ta.lookup_batch(q)
        assert got == ja.lookup_batch(q) and any(got[0])
        assert got[0] == eng.query_match_batch(np.asarray(q, np.int64))
        return
    if item == "12h":
        # item 12h is ported: the host bucketing (shuffle_mode="host")
        # builds, and matches as the reference's host mode and as the
        # port's device exchange, bit for bit
        assert call(None).shuffle_mode == "host"
        steps = gen_steps(9, n_steps=6, n_keys=23, batch=96)
        got, _ = run(port(seq3, shuffle_mode="host"), steps, RecordBatch)
        want, _ = run(ref(seq3, shuffle_mode="host"), steps, JRecordBatch)
        dev, _ = run(port(seq3), steps, RecordBatch)
        assert sum(len(b) for b in got) > 0
        assert_batches_equal(got, want)
        assert_batches_equal(got, dev)
        return
    with pytest.raises(NotImplementedError) as e:
        call(port(seq3))
    assert _item(e) == item


def test_cep_metric_group_equals_the_references():
    """``register_metrics`` (ROADMAP item 12a): the ``cep`` group's gauges
    read the same names and, after the same steps, the same values as the
    reference engine's (``host_fallbacks`` is each package's process-wide
    count, so only its presence is compared)."""
    from flink_tpu.metrics import MetricRegistry as JRegistry
    from flink_tpu_torch.metrics import MetricRegistry

    snaps = []
    for eng, reg, cls in ((ref(seq3), JRegistry(), JRecordBatch),
                          (port(seq3), MetricRegistry(), RecordBatch)):
        eng.register_metrics(reg.root_group("job", "j"))
        for keys, vals, tss, wm in gen_steps(11, n_steps=6):
            eng.process_batch(mk_batch(cls, keys, vals, tss))
            eng.on_watermark(wm)
        snap = reg.snapshot()
        snap.pop("job.j.cep.host_fallbacks")
        snaps.append(snap)
    assert snaps[0] == snaps[1]
    assert snaps[1]["job.j.cep.matches_emitted"] > 0


def test_host_backend_takes_host_shuffle():
    e = MeshCepEngine(seq3(Pattern, Skip), backend="host",
                      shuffle_mode="host")
    assert e.backend == "host"


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        MeshCepEngine(seq3(Pattern, Skip), num_shards=8)


def test_bench_check_at_a_small_size():
    from flink_tpu_torch.benchmarks import cep

    r = cep.run(70_000, "cpu", host_records=0)
    c = cep.check(70_000, "cpu")
    assert c["equal_to_host_backend"] and c["records"] == 70_000
    assert c["batches_compared"] > 0 and r["matches"] > 0
    assert c["host_backend"]["matches"] == r["matches"]
    assert r["events"] == 70_000 and r["batches"] == 3
    assert "host_backend" not in r


def test_operator_crash_and_restore_from_checkpoints(tmp_path):
    """A ``MeshCepOperator`` job at P=8 checkpointing every 2 source
    batches fails mid-stream, and a fresh job resumes with
    ``restore_from=``: the rows of both runs together are the rows of an
    uninterrupted run (the failed run's rows after its last checkpoint
    repeat, as a non-transactional sink sees them)."""
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.cep import MeshCepOperator
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.datastream.stream import DataStream
    from flink_tpu_torch.graph.transformations import Transformation

    rng = np.random.default_rng(4)
    n = 3000
    rows = [{"k": int(k), "v": int(v), "t": int(t)} for k, v, t in zip(
        rng.integers(0, 50, n), rng.integers(0, 9, n),
        np.arange(n) * 3 + rng.integers(0, 8, n))]
    pat = seq3(Pattern, Skip)

    class FailAfter:
        def __init__(self, after):
            self.seen, self.after = 0, after

        def __call__(self, b):
            self.seen += len(b)
            if self.after is not None and self.seen > self.after:
                raise RuntimeError("injected failure")
            return b

    def job(ckpt_dir, fail_after=None, restore_from=None):
        env = StreamExecutionEnvironment(Configuration({
            "parallelism.default": 8, "execution.micro-batch.size": 256,
            "execution.device": "cpu", "state.checkpoints.dir": ckpt_dir,
            "execution.checkpointing.every-n-source-batches": 2}))
        keyed = (env.from_collection(rows, timestamp_field="t")
                 .map(FailAfter(fail_after), name="failmap").key_by("k"))
        sink = CollectSink()
        DataStream(env, Transformation(
            name="match_recognize", kind="one_input",
            operator_factory=lambda: MeshCepOperator(
                pat, key_field="k", capacity=256),
            inputs=[keyed.transformation], keyed=True,
            key_field="k")).sink_to(sink)
        if fail_after is None:
            env.execute(restore_from=restore_from)
        else:
            with pytest.raises(RuntimeError, match="injected"):
                env.execute()
        return [tuple(sorted(r.items())) for b in sink.batches
                for r in b.to_rows()]

    full = job(str(tmp_path / "full"))
    crashed = job(str(tmp_path / "crash"), fail_after=1500)
    resumed = job(str(tmp_path / "resume"),
                  restore_from=str(tmp_path / "crash"))
    assert full and resumed
    assert set(crashed + resumed) == set(full)
    assert len(crashed + resumed) >= len(full)
