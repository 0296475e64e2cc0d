"""Point queries of the port's sharded engines against the reference's
on the CPU (the reference on the 8 virtual devices of
``tests/conftest.py``, the port on logical meshes): the mesh window
engine's ``query_windows`` / ``query_batch`` with and without a device
budget (spilled slices answered from the shards' host tiers), the mesh
session engine's ``query_sessions`` / ``query_batch`` over the paged tier,
the join engines' ``query_side_batch`` (device and host backends, cold
rows from the page tiers) and CEP's ``query_match_batch``.

The same seeded NumPy streams go through both packages and the same keys
are queried at every cut. Tolerance: none — ``same_answers`` compares the
answers' structure with ``==``, every float on its raw bits and every
scalar's Python type; ``_read_only`` asserts that a query batch leaves the
engine's planes, indexes, spill tiers, page maps and sticky buckets as
they were (the joins' and CEP's gathers move their sticky buckets in the
reference too, so those two are held to their metadata and pages).
"""

import numpy as np
import pytest

from flink_tpu.core.records import RecordBatch as JRecordBatch
from flink_tpu.joins import MeshIntervalJoinEngine as JInterval
from flink_tpu.joins import MeshTemporalJoinEngine as JTemporal
from flink_tpu.parallel.sharded_sessions import MeshSessionEngine as JMeshSess
from flink_tpu.parallel.sharded_windower import MeshWindowEngine as JMesh
from flink_tpu.windowing import aggregates as jagg
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.joins import MeshIntervalJoinEngine
from flink_tpu_torch.joins import MeshTemporalJoinEngine
from flink_tpu_torch.parallel.mesh import make_mesh
from flink_tpu_torch.parallel.sharded_sessions import (
    MeshSessionEngine as TMeshSess,
)
from flink_tpu_torch.parallel.sharded_windower import MeshWindowEngine as TMesh
from flink_tpu_torch.windowing import aggregates as tagg

from tests.test_torch_joins import cols, interval_stream, port, ref
from tests.test_torch_mesh_cep import gen_steps
from tests.test_torch_mesh_cep import port as cep_port
from tests.test_torch_mesh_cep import ref as cep_ref
from tests.test_torch_mesh_cep import run as cep_run
from tests.test_torch_queries import (
    AGGS,
    P,
    _assigners,
    _drive_and_query,
    _query_keys,
    _session_stream,
    _stream,
    same_answers,
)

# ------------------------------------------------------ the mesh engines

@pytest.mark.parametrize("budget", [0, 1024])
@pytest.mark.parametrize("agg", ["count", "sum", "multi"])
def test_mesh_window_queries_equal_reference(eight_device_mesh, agg, budget):
    """Every key routes to its owning shard; all shards' hits gather in one
    ``[P, G]`` block; under a budget the spilled slices answer from the
    shards' host tiers."""
    ja, ta = _assigners("sliding")
    kw = {"max_device_slots": budget} if budget else {}
    j = JMesh(ja, AGGS[agg][0](), eight_device_mesh,
              capacity_per_shard=1 << 13, **kw)
    t = TMesh(ta, AGGS[agg][1](), make_mesh(P, "cpu"),
              capacity_per_shard=1 << 13, **kw)
    stream = _stream(len(agg) + budget, keys=4000, n=6000, steps=6)
    answered, spilled = _drive_and_query(
        j, t, stream, _query_keys(5, 4000, 256),
        lambda w, k: w.query_batch(k))
    assert answered > 0
    assert bool(spilled) == bool(budget)
    for k in _query_keys(6, 4000, n=8).tolist():
        same_answers(t.query_windows(k), j.query_windows(k))


@pytest.mark.parametrize("budget", [0, 1024])
def test_mesh_session_queries_equal_reference(eight_device_mesh, budget):
    kw = {"max_device_slots": budget} if budget else {}
    j = JMeshSess(400, jagg.SumAggregate("v"), eight_device_mesh,
                  capacity_per_shard=1 << 11, **kw)
    t = TMeshSess(400, tagg.SumAggregate("v"), make_mesh(P, "cpu"),
                  capacity_per_shard=1 << 11, **kw)
    answered, _ = _drive_and_query(
        j, t, _session_stream(7 + budget, keys=20_000, n=6000, steps=8),
        _query_keys(1, 20_000, 512), lambda w, k: w.query_batch(k))
    assert answered > 0
    assert bool(t.spill_counters()["rows_evicted"]) == bool(budget)
    for k in _query_keys(3, 20_000, n=8).tolist():
        same_answers(t.query_sessions(k), j.query_sessions(k))




# ------------------------------------------------------------------ joins

def _side_sig(eng):
    """A join engine's side metadata, pages and page-map counters (a
    query counts ``cold_rows_served``, in the reference too)."""
    sig = []
    for side in eng.sides:
        if side is None:
            sig.append(None)
            continue
        sig.append((
            [(m.key.tolist(), m.ts.tolist(), m.rid.tolist(), m.slot.tolist())
             for m in side.meta],
            [sorted(int(x) for x in sp.namespaces) for sp in side.spills],
            [pm.counters() for pm in side.pmaps]))
    return sig


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("budget", [256, 0])
def test_join_side_queries_equal_reference(budget, backend):
    """The interval engine's buffered rows per key, both sides, at every
    step; under a 256-row budget a shard the sides evict to pages and cold
    rows answer from them (``cold_rows_served`` equal to the
    reference's)."""
    kw = ({"capacity_per_shard": 256, "max_device_slots": 256} if budget
          else {"capacity_per_shard": 1 << 12})
    t = port(MeshIntervalJoinEngine, -30, 30, backend=backend, **kw)
    j = ref(JInterval, -30, 30, **kw)
    q = np.arange(0, 2000, 7, dtype=np.int64)
    seen = 0
    for side, c, wm in interval_stream(steps=6, n=700, keys=2000, span=40,
                                       seed=4):
        t.process_batch(RecordBatch(dict(c)), side)
        j.process_batch(JRecordBatch(dict(c)), side)
        t.on_watermark(wm)
        j.on_watermark(wm)
        for s in (0, 1):
            before = _side_sig(t)
            got = t.query_side_batch(s, q)
            assert _side_sig(t) == before
            want = j.query_side_batch(s, q)
            same_answers(got, want)
            seen += sum(len(r) for r in want)
    assert seen > 0
    cold = [s.cold_rows_served for s in t.sides]
    assert cold == [s.cold_rows_served for s in j.sides]
    assert (sum(cold) > 0) == bool(budget)


def test_temporal_join_side_query_equals_reference():
    t = port(MeshTemporalJoinEngine, shards=4)
    j = ref(JTemporal, shards=4)
    rng = np.random.default_rng(2)
    for step in range(4):
        k = rng.integers(0, 50, 80)
        ts = step * 100 + rng.integers(0, 100, 80)
        v = rng.random(80).astype(np.float32)
        c = cols(k, v, ts, name="rate")
        t.process_batch(RecordBatch(dict(c)), 1)
        j.process_batch(JRecordBatch(dict(c)), 1)
    q = np.arange(60, dtype=np.int64)
    same_answers(t.query_side_batch(1, q), j.query_side_batch(1, q))
    same_answers(t.query_side_batch(0, q), j.query_side_batch(0, q))


# -------------------------------------------------------------------- CEP

def _seq2(P, S):
    return (P.begin("a", skip=S.SKIP_PAST_LAST_EVENT)
            .where(lambda b: np.asarray(b["v"]) % 3 == 0)
            .next("b").where(lambda b: np.asarray(b["v"]) % 3 == 1)
            .within(50))


@pytest.mark.parametrize("shards", [8, 4])
def test_cep_match_queries_equal_reference(shards):
    """The match store per key at every step (keys with and without
    matches), as the reference answers it."""
    steps = gen_steps(5, n_steps=8, n_keys=40, batch=128)
    q = np.arange(45, dtype=np.int64)
    answers = []

    def sig(e):
        """The engine's match store, key index and planes: what a query
        must leave as they were (its put bucket moves in the reference
        too)."""
        return ([(sh.m_used.copy(), sh.m_key.copy(), sh.key_of.copy(),
                  sh.touch.copy()) for sh in e._st],
                [p.clone() for p in e._match_planes])

    def hook_t(e, i):
        before = sig(e)
        answers.append(e.query_match_batch(q))
        after = sig(e)
        for (a, b) in zip(before[0], after[0]):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert all(x.equal(y) for x, y in zip(before[1], after[1]))

    want = []

    def hook_j(e, i):
        want.append(e.query_match_batch(q))

    cep_run(cep_port(_seq2, shards, match_capacity=64), steps, RecordBatch,
            hook=hook_t)
    cep_run(cep_ref(_seq2, shards, match_capacity=64), steps, JRecordBatch,
            hook=hook_j)
    same_answers(answers, want)
    assert sum(len(r) for a in want for r in a) > 0
