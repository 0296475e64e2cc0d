"""Live rescale through the runtime (ROADMAP item 12g) on the CPU, the
port against the reference:

- ``RescaleRequest`` through ``LocalExecutor`` on BASELINE row 1's Q5 at
  P=8: 8 -> 4 mid-stream, then back to 8, at the same batch boundaries in
  both packages (source pumps off, so the boundary is deterministic);
  the same rows moved at each handoff and rows equal the uninterrupted
  run (exact: Q5's counts);
- the stage executor fails a ``RescaleRequest`` as the reference's does;
- the interval join and the mesh CEP engine resharded 8 -> 4 mid-stream:
  outputs equal, in order and bit for bit, to the reference's resharded
  run and to the port's run without a reshard;
- the chaos harness's ``rebalances=`` with a crash at the
  ``rebalance.handoff`` commit point: the port's report signature and
  committed output equal the reference's;
- the read replica rebuilds and republishes after a live reshard and
  after a rebalance (the reference's ``test_reshard_rebuild_republishes``):
  replica lookups equal live queries and the reference's replica.
"""

import importlib
import queue

import numpy as np
import pytest

from flink_tpu.chaos import harness as jharness
from flink_tpu.chaos import injection as jchaos
from flink_tpu.core.records import RecordBatch as JRecordBatch
from flink_tpu_torch.chaos import harness as tharness
from flink_tpu_torch.chaos import injection as tchaos
from flink_tpu_torch.core.records import RecordBatch

PKGS = {"port": "flink_tpu_torch", "ref": "flink_tpu"}


def mod(pkg, name):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


# ---------------------------------------------------------- Q5 executor


def _q5_rescaled(pkg, plan, total=60_000, par=8):
    """Q5 at P=``par`` with ``plan`` = {batch -> new shards}: each
    RescaleRequest is queued as the source hands out that batch and
    served at the boundary after it. Returns (rows, handoff reports)."""
    top = importlib.import_module(PKGS[pkg])
    nx = mod(pkg, "benchmarks.nexmark")
    le = mod(pkg, "cluster.local_executor")
    conf = {"parallelism.default": par, "execution.micro-batch.size": 4096,
            "execution.pipeline.in-flight-batches": 0}
    if pkg == "port":
        conf["execution.device"] = "cpu"
    control = queue.Queue()
    reqs = []

    class Queueing(nx.BidSource):
        polled = 0

        def poll_batch(self, n):
            b = super().poll_batch(n)
            self.polled += 1
            if self.polled in plan:
                reqs.append(le.RescaleRequest(plan[self.polled]))
                control.put(reqs[-1])
            return b

    env = top.StreamExecutionEnvironment(top.Configuration(conf))
    sink = mod(pkg, "connectors.sinks").CollectSink()
    nx.build_q5(env, Queueing(total_records=total, num_auctions=500)
                ).sink_to(sink)
    cfg = env.config if pkg == "port" else env._effective_config()
    le.LocalExecutor(cfg).run(env.get_stream_graph(), "q5",
                              control_queue=control)
    rows = sorted(tuple(sorted((k, v.item() if hasattr(v, "item") else v)
                               for k, v in r.items())) for r in sink.rows())
    return rows, [r.wait(timeout=5) for r in reqs]


def test_rescale_request_q5_down_and_back_equals_the_reference():
    plan = {3: 4, 9: 8}
    got, got_reps = _q5_rescaled("port", plan)
    want, want_reps = _q5_rescaled("ref", plan)
    clean, _ = _q5_rescaled("port", {})
    assert len(got) > 0 and got == want == clean
    assert [(r["from"], r["to"]) for r in got_reps] == \
        [(r["from"], r["to"]) for r in want_reps] == [(8, 4), (4, 8)]
    assert [r["rows_moved"] for r in got_reps] == \
        [r["rows_moved"] for r in want_reps]
    assert all(r["rows_moved"] > 0 for r in got_reps)


def test_stage_executor_fails_a_rescale_like_the_reference():
    errs, rows = {}, {}
    for pkg in PKGS:
        top = importlib.import_module(PKGS[pkg])
        le = mod(pkg, "cluster.local_executor")
        src_mod = mod(pkg, "connectors.sources")
        control = queue.Queue()
        req = le.RescaleRequest(4)

        class Queueing(src_mod.DataGenSource):
            polled = 0

            def poll_batch(self, n):
                self.polled += 1
                if self.polled == 2:
                    control.put(req)
                return super().poll_batch(n)

        conf = {"execution.micro-batch.size": 512,
                "execution.stage-parallelism": 2,
                "execution.pipeline.in-flight-batches": 0}
        if pkg == "port":
            conf["execution.device"] = "cpu"
        env = top.StreamExecutionEnvironment(top.Configuration(conf))
        sink = mod(pkg, "connectors.sinks").CollectSink()
        wm = mod(pkg, "runtime.watermarks").WatermarkStrategy
        asg = mod(pkg, "windowing.assigners").TumblingEventTimeWindows
        (env.from_source(Queueing(total_records=8_000, num_keys=50,
                                  events_per_second_of_eventtime=4_000,
                                  seed=3),
                         wm.for_bounded_out_of_orderness(0))
         .key_by("key").window(asg.of(1000)).count().sink_to(sink))
        cfg = env.config if pkg == "port" else env._effective_config()
        mod(pkg, "cluster.stage_executor").StageParallelExecutor(cfg).run(
            env.get_stream_graph(), "stage", control_queue=control)
        with pytest.raises(RuntimeError) as e:
            req.wait(timeout=30)
        errs[pkg] = str(e.value)
        rows[pkg] = sorted((int(r["key"]), int(r["window_start"]),
                            int(r["count"])) for r in sink.rows())
    for msg in errs.values():
        assert msg.startswith("unsupported control <")
        assert ".RescaleRequest object" in msg
    assert rows["port"] == rows["ref"] and rows["port"]


# ------------------------------------------------------- joins and CEP


def test_interval_join_resharded_mid_stream():
    from tests.test_torch_joins import (
        JInterval,
        MeshIntervalJoinEngine,
        assert_batches_equal,
        interval_stream,
        port,
        ref,
    )

    stream = interval_stream(steps=8, n=300, seed=4)
    outs = {}
    for name, eng, cls, at in (
            ("port", port(MeshIntervalJoinEngine, -20, 20, shards=8),
             RecordBatch, 8),
            ("ref", ref(JInterval, -20, 20, shards=8), JRecordBatch, 8),
            ("port-solo", port(MeshIntervalJoinEngine, -20, 20, shards=8),
             RecordBatch, None)):
        out = []
        for i, (side, c, wm) in enumerate(stream):
            if i == at:
                rep = eng.reshard(4)
                assert rep["shards"] == eng.P == 4 and rep["rows_moved"] > 0
                outs[name + "-moved"] = rep["rows_moved"]
            out += eng.process_batch(cls(c), side)
            eng.on_watermark(wm)
        outs[name] = out
    assert outs["port-moved"] == outs["ref-moved"]
    assert_batches_equal(outs["port"], outs["ref"])
    # without the reshard the matches are the same rows, emitted in the
    # order of 8 shards instead of 4: equal as sorted rows, bit for bit
    assert _sorted_rows(outs["port"]) == _sorted_rows(outs["port-solo"])
    assert len(_sorted_rows(outs["port"])) > 0


def _sorted_rows(batches):
    out = []
    for b in batches:
        names = sorted(b.names())
        cols = [np.asarray(b[n]) for n in names]
        cols = [c.view(np.uint32) if c.dtype == np.float32 else c
                for c in cols]
        out.extend(zip(*[c.tolist() for c in cols]))
    return sorted(out)


def test_cep_resharded_mid_stream():
    from tests.test_torch_mesh_cep import (
        assert_batches_equal,
        gen_steps,
        port,
        ref,
        run,
        seq3,
    )

    steps = gen_steps(13, n_steps=10, n_keys=60, batch=128)

    def hook(eng, i):
        if i == 4:
            rep = eng.reshard(4)
            assert eng.P == 4 and rep["rows_moved"] > 0
            moved.append(rep["rows_moved"])

    moved = []
    got, _ = run(port(seq3, shards=8), steps, RecordBatch, hook)
    want, _ = run(ref(seq3, shards=8), steps, JRecordBatch, hook)
    solo, _ = run(port(seq3, shards=8), steps, RecordBatch)
    assert moved[0] == moved[1]
    assert len(got) > 0
    assert_batches_equal(got, want)
    assert_batches_equal(got, solo)


def test_operators_support_live_rescale_like_the_reference():
    from flink_tpu.cep.operators import MeshCepOperator as JCep
    from flink_tpu.joins.operators import (
        DeviceIntervalJoinOperator as JIJ,
    )
    from flink_tpu_torch.cep.operators import MeshCepOperator
    from flink_tpu_torch.joins.operators import DeviceIntervalJoinOperator

    assert DeviceIntervalJoinOperator(-1, 1).supports_live_rescale() is \
        JIJ(-1, 1).supports_live_rescale() is True
    assert callable(MeshCepOperator.reshard) and callable(JCep.reshard)


# -------------------------------------------------------------- chaos


def test_chaos_rebalance_crash_at_commit_equals_the_reference(
        tmp_path, monkeypatch, eight_device_mesh):
    """The reference's ``TestRebalanceUnderChaos``: a key-group move
    crashed at ``rebalance.handoff``'s commit (rows lifted, planes empty),
    recovered by a checkpoint restore that comes back contiguous and
    re-applies the move on replay. Both harnesses give the same report
    signature and the same committed output (exact)."""
    from flink_tpu.parallel.mesh import make_mesh as jmake_mesh
    from flink_tpu.parallel.sharded_sessions import (
        MeshSessionEngine as JSess,
    )
    from flink_tpu.windowing import aggregates as jagg
    from flink_tpu.windowing.sessions import SessionWindower as JSW
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_sessions import MeshSessionEngine
    from flink_tpu_torch.windowing import aggregates as tagg
    from flink_tpu_torch.windowing.sessions import SessionWindower
    from tests.test_torch_skew import _stream

    steps = _stream(num_keys=5_000, per_step=1_500)

    def move_first_groups(engine):
        cur = engine.key_group_assignment
        src = int(cur.table[0])
        groups = np.nonzero(cur.table == src)[0][:8] + cur.first
        return cur.move(groups, (src + 1) % engine.P)

    makers = {
        "ref": (lambda: JSess(100, jagg.SumAggregate("v"), jmake_mesh(4),
                              capacity_per_shard=1 << 14,
                              max_device_slots=1024),
                lambda: JSW(100, jagg.SumAggregate("v"), capacity=1 << 15),
                jharness, jchaos),
        "port": (lambda: MeshSessionEngine(
            100, tagg.SumAggregate("v"), make_mesh(4, "cpu"),
            capacity_per_shard=1 << 14, max_device_slots=1024),
                 lambda: SessionWindower(100, tagg.SumAggregate("v"),
                                         capacity=1 << 15,
                                         spill={"device": "cpu"}),
                 tharness, tchaos)}
    out = {}
    for pkg, (mk, oracle, harness, cmod) in makers.items():
        captured = {}
        real = harness._diff

        def spy(expected, got, *a, _real=real, _c=captured, **k):
            _c["committed"] = dict(got)
            return _real(expected, got, *a, **k)

        monkeypatch.setattr(harness, "_diff", spy)
        plan = cmod.FaultPlan(rules=[cmod.FaultRule(
            pattern="rebalance.handoff", nth=1, kind="raise",
            where={"stage": "commit"})])
        report = harness.run_crash_restore_verify(
            mk, oracle, steps, plan, seed=11,
            ckpt_root=str(tmp_path / pkg), checkpoint_every=2,
            rebalances={3: move_first_groups})
        out[pkg] = (report, captured["committed"])
    t, tc = out["port"]
    j, jc = out["ref"]
    assert not t.diverged and t.crashes == 1 and t.restores >= 1
    assert t.faults_injected.get("rebalance.handoff", 0) == 1
    assert t.live_handoffs >= 1
    assert t.signature() == j.signature()
    bits = {k: {n: np.float32(v).view(np.uint32) for n, v in f.items()}
            for k, f in tc.items()}
    jbits = {k: {n: np.float32(v).view(np.uint32) for n, v in f.items()}
             for k, f in jc.items()}
    assert bits == jbits


# --------------------------------------------------- replica rebuild


def _replica_drive(engine, batch_of, n_batches=3, t0=0, rng=None):
    rng = rng or np.random.default_rng(7)
    t = t0
    for _ in range(n_batches):
        ks = rng.integers(0, 64, 256)
        ts = t + rng.integers(0, 500, 256)
        vs = rng.random(256).astype(np.float32)
        engine.process_batch(batch_of({
            "__key_id__": np.asarray(ks, dtype=np.int64),
            "__ts__": np.asarray(ts, dtype=np.int64),
            "value": vs}))
        t += 700
        engine.on_watermark(t - 600)
    return t


@pytest.mark.parametrize("change", ["reshard", "rebalance"])
def test_reshard_rebuild_republishes(change):
    """The reference's ``test_reshard_rebuild_republishes`` (and the
    same after a rebalance): the engine's planes change under the
    replica's shadow, so the next boundary rebuilds the replica plane
    (``ReplicaPlane.rebuild`` and its ``on_rebuild`` hook) and
    republishes every row; lookups then equal the live queries and the
    reference replica's answers."""
    from flink_tpu.parallel.mesh import make_mesh as jmake_mesh
    from flink_tpu.parallel.sharded_windower import (
        MeshWindowEngine as JWin,
    )
    from flink_tpu.tenancy.replica import WindowReplicaAdapter as JAd
    from flink_tpu.windowing.aggregates import SumAggregate as JSum
    from flink_tpu.windowing.assigners import TumblingEventTimeWindows as JT
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_windower import MeshWindowEngine
    from flink_tpu_torch.tenancy.replica import WindowReplicaAdapter
    from flink_tpu_torch.windowing.aggregates import SumAggregate
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

    eng = MeshWindowEngine(TumblingEventTimeWindows(5000),
                           SumAggregate("value"), make_mesh(4, "cpu"),
                           capacity_per_shard=4096, max_parallelism=128)
    jeng = JWin(JT(5000), JSum("value"), jmake_mesh(4),
                capacity_per_shard=4096, max_parallelism=128)
    plane, jplane = eng.arm_replica(), jeng.arm_replica()
    rebuilds = []
    inner = plane.on_rebuild

    def on_rebuild():
        rebuilds.append(eng.P)
        if inner is not None:
            inner()

    plane.on_rebuild = on_rebuild
    for e, b in ((eng, RecordBatch), (jeng, JRecordBatch)):
        _replica_drive(e, b)
    before = len(rebuilds)
    if change == "reshard":
        eng.reshard(2)
        jeng.reshard(2)
    else:
        for e in (eng, jeng):
            cur = e.key_group_assignment
            e.reassign_key_groups(cur.move(cur.groups_of_shard(0)[:16], 3))
    for e, b in ((eng, RecordBatch), (jeng, JRecordBatch)):
        _replica_drive(e, b, t0=3 * 700)
    assert len(rebuilds) == before + 1
    assert rebuilds[-1] == (2 if change == "reshard" else 4)
    ad = WindowReplicaAdapter(plane, eng.agg, eng.assigner)
    ad.cold_fetch = lambda ks: eng.query_batch(np.asarray(ks, np.int64))
    jad = JAd(jplane, jeng.agg, jeng.assigner)
    jad.cold_fetch = lambda ks: jeng.query_batch(np.asarray(ks, np.int64))
    qk = list(range(32))
    got = ad.lookup_batch(qk)[0]
    assert got == eng.query_batch(np.asarray(qk, dtype=np.int64))
    assert got == jad.lookup_batch(qk)[0]
    assert any(got)


# ------------------------------------------ chip_smoke phase 26, cut size


def test_phase_26_rehearses_on_the_cpu():
    """``chip_smoke.phase_scaleout(torch, "cpu", small=True)``: every part
    of phase 26 at a cut size — row 5c's Zipf run moving key groups live
    and salting keys with fires bit-identical to the unsplit replay, Q5
    rescaled 8 -> 4 -> 8 by RescaleRequest and the autoscaled 2 -> 4 -> 2
    ramp equal to their plain runs, the join and CEP resharded, the
    arbiter's live tick, and the rank's plain path at every D."""
    import torch

    import chip_smoke

    out = chip_smoke.phase_scaleout(torch, "cpu", small=True)
    a, b, c, d, e = (out[k] for k in "abcde")
    assert a["bit_identical_to_unsplit"]
    assert a["skew"]["rebalances"] >= 1 and a["skew"]["salted_records"] > 0
    assert [(h["from"], h["to"]) for h in b["handoffs"]] == [(8, 4), (4, 8)]
    assert (2, 4) in b["ramp_path"] and (4, 2) in b["ramp_path"]
    assert c["join_rows"] > 0 and c["cep_matches"] > 0
    assert sum(d["served"].values()) >= 1 and not any(d["errors"].values())
    assert [r["D"] for r in e["cases"]] == list(chip_smoke.SCALE_RANK_DS)
    assert all(r["max_abs_err"] == 0.0 for r in e["cases"])
