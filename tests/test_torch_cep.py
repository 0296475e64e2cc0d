"""The port's host CEP (``flink_tpu_torch/cep/pattern.py``, ``nfa.py``,
``operator.py``) against the reference's (``flink_tpu/cep/``) on the same
inputs.

- ``Pattern`` building (persistent builders) and every ``validate()``
  error, message for message;
- ``CepOperator`` against the reference's ``CepOperator`` for the patterns
  of ``tests/test_cep.py`` and ``tests/test_cep_negatives.py`` (strict and
  relaxed contiguity, loops, combinations, optionals, within, both skips,
  negations, until, timesOrMore, greedy, iterative conditions) over a
  keyed stream made from a numpy seed, out of order within a bounded lag:
  every emitted batch equal in order (names, dtypes, values, timestamps);
- ``CEP.pattern(keyed, p).select()`` through the port's ``env.execute``
  (CPU) against the reference's job: rows equal in order;
- ``snapshot_state`` / ``restore_state``: the port's snapshot equals the
  reference's, a restore (from either package's snapshot) mid-stream
  continues equal to the uninterrupted run.

Tolerance: none — rows are compared exactly.
"""

import numpy as np
import pytest

from flink_tpu.cep import CEP as JCEP
from flink_tpu.cep import AfterMatchSkipStrategy as JSkip
from flink_tpu.cep import KeyNFA as JKeyNFA
from flink_tpu.cep import Pattern as JPattern
from flink_tpu.cep.operator import CepOperator as JCepOperator
from flink_tpu.core.records import RecordBatch as JRecordBatch
from flink_tpu_torch.cep import CEP, AfterMatchSkipStrategy, KeyNFA, Pattern
from flink_tpu_torch.cep.operator import CepOperator
from flink_tpu_torch.core.records import RecordBatch

PORT = (Pattern, AfterMatchSkipStrategy)
REF = (JPattern, JSkip)


def starts(letter):
    return lambda b: np.char.startswith(np.asarray(b["v"], dtype=str), letter)


def kind_is(x):
    return lambda b: np.asarray(b["kind"]) == x


def amount_lt(x):
    return lambda b: np.asarray(b["amount"]) < x


# every pattern of tests/test_cep.py and tests/test_cep_negatives.py, as a
# builder over (Pattern, AfterMatchSkipStrategy) of either package
PATTERNS = {
    "strict_next": lambda P, S: P.begin("A").where(starts("a"))
    .next("B").where(starts("b")),
    "relaxed": lambda P, S: P.begin("A").where(starts("a"))
    .followed_by("B").where(starts("b")),
    "one_or_more": lambda P, S: P.begin("A").where(starts("a"))
    .one_or_more().followed_by("B").where(starts("b")),
    "times": lambda P, S: P.begin("A").where(starts("a")).times(2)
    .followed_by("B").where(starts("b")),
    "combinations": lambda P, S: P.begin("A").where(starts("a")).times(2)
    .allow_combinations().followed_by("B").where(starts("b")),
    "consecutive": lambda P, S: P.begin("A").where(starts("a")).times(2)
    .consecutive().followed_by("B").where(starts("b")),
    "optional_middle": lambda P, S: P.begin("A").where(starts("a"))
    .next("B").where(starts("b")).optional().next("C").where(starts("c")),
    "optional_first": lambda P, S: P.begin("A").where(starts("a"))
    .optional().next("B").where(starts("b")),
    "optional_last": lambda P, S: P.begin("A").where(starts("a"))
    .followed_by("B").where(starts("b")).optional(),
    "within": lambda P, S: P.begin("A").where(starts("a"))
    .followed_by("B").where(starts("b")).within(15),
    "skip_past": lambda P, S: P.begin("A").where(starts("a"))
    .followed_by("B").where(starts("b"))
    .with_skip_strategy(S.SKIP_PAST_LAST_EVENT),
    "single_loop": lambda P, S: P.begin("A").where(starts("a")).times(2),
    "fraud": lambda P, S: P.begin("small").where(amount_lt(1.0))
    .followed_by("big").where(lambda b: np.asarray(b["amount"]) > 5.0)
    .within(60),
    "not_followed_by": lambda P, S: P.begin("a").where(kind_is("a"))
    .not_followed_by("nc").where(kind_is("c"))
    .followed_by("b").where(kind_is("b")),
    "trailing_not_followed_by": lambda P, S: P.begin("a")
    .where(kind_is("a")).not_followed_by("nc").where(kind_is("c"))
    .within(50),
    "not_next": lambda P, S: P.begin("a").where(kind_is("a"))
    .not_next("nc").where(kind_is("c")).followed_by("b").where(kind_is("b")),
    "until": lambda P, S: P.begin("small").where(amount_lt(3.0))
    .one_or_more().until(lambda b: np.asarray(b["amount"]) > 8.0)
    .followed_by("end").where(kind_is("b")),
    "times_or_more": lambda P, S: P.begin("s").where(kind_is("a"))
    .times_or_more(2).followed_by("e").where(kind_is("b")),
    "until_count0": lambda P, S: P.begin("a").where(kind_is("a"))
    .followed_by("b").where(kind_is("b")).one_or_more()
    .until(kind_is("x")),
    "trailing_skip_past": lambda P, S: P.begin(
        "a", skip=S.SKIP_PAST_LAST_EVENT).where(kind_is("a"))
    .not_followed_by("nc").where(kind_is("c")).within(10),
    "greedy": lambda P, S: P.begin("A").where(starts("a")).one_or_more()
    .greedy().next("B").where(amount_lt(5.0)),
    "iterative": lambda P, S: P.begin("A").where(starts("a"))
    .followed_by("B").where(starts("b")).where_iterative(
        lambda ev, ctx: ev["amount"] > ctx.events_for("A")[0]["amount"]),
    "within_no_skip_loop": lambda P, S: P.begin("A", skip=S.NO_SKIP)
    .where(amount_lt(6.0)).times(2, 3).consecutive().next("B")
    .where(starts("c")).within(40),
}


def rows_of_stream(seed=0, n=80, keys=5, lag=12):
    """Keyed rows with ``v`` (a letter and a number), ``kind`` (the
    letter), ``amount`` and an event time that trails an increasing clock
    by up to ``lag`` ms."""
    rng = np.random.default_rng(seed)
    letters = np.array(["a", "b", "c", "x"])
    ls = letters[rng.integers(0, 4, n)]
    ts = np.arange(n, dtype=np.int64) * 5 + rng.integers(0, lag, n)
    return [{"k": int(k), "v": f"{l}{i}", "kind": str(l),
             "amount": float(a), "t": int(t)}
            for i, (k, l, a, t) in enumerate(zip(
                rng.integers(0, keys, n), ls,
                np.round(rng.random(n) * 10, 2), ts))]


def batches_of(rows, cls, size=7):
    out = []
    for i in range(0, len(rows), size):
        part = rows[i:i + size]
        out.append(cls.from_pydict({
            "k": np.array([r["k"] for r in part], dtype=np.int64),
            "v": np.array([r["v"] for r in part], dtype=object),
            "kind": np.array([r["kind"] for r in part], dtype=object),
            "amount": np.array([r["amount"] for r in part]),
            "__key_id__": np.array([r["k"] for r in part], dtype=np.int64)},
            timestamps=np.array([r["t"] for r in part], dtype=np.int64)))
    return out


def select_events(key, m, events):
    return {"key": key, "start": m.start_ts, "end": m.end_ts,
            "events": "|".join(f"{name}:" + ",".join(e["v"] for e in evs)
                               for name, evs in sorted(events.items()))}


def drive(op, batches, lag=12, hook=None):
    out = []
    wm = None
    for i, b in enumerate(batches):
        out += op.process_batch(b)
        wm = int(np.asarray(b.timestamps).max()) - lag if wm is None \
            else max(wm, int(np.asarray(b.timestamps).max()) - lag)
        out += op.process_watermark(wm)
        if hook is not None:
            op = hook(i, op) or op
    out += op.process_watermark(1 << 62)
    return out


def as_rows(batches):
    """Every batch as (names, dtypes, rows, timestamps), in order."""
    return [(sorted(b.names()),
             [str(np.asarray(b[n]).dtype) for n in sorted(b.names())],
             b.to_rows(), np.asarray(b.timestamps).tolist())
            for b in batches]


@pytest.mark.parametrize("select", [None, select_events],
                         ids=["default", "events"])
@pytest.mark.parametrize("name", list(PATTERNS))
def test_operator_equals_reference(name, select):
    rows = rows_of_stream(seed=len(name))
    make = PATTERNS[name]
    want = drive(JCepOperator(make(*REF), "k", select=select),
                 batches_of(rows, JRecordBatch))
    got = drive(CepOperator(make(*PORT), "k", select=select),
                batches_of(rows, RecordBatch))
    assert as_rows(got) == as_rows(want)


def test_stream_exercises_every_pattern():
    """Vacuity guard: the shared stream makes most patterns match."""
    matched = sum(bool(drive(CepOperator(m(*PORT), "k"),
                             batches_of(rows_of_stream(seed=len(n)),
                                        RecordBatch)))
                  for n, m in PATTERNS.items())
    assert matched >= len(PATTERNS) - 2


def test_key_nfa_advance_equals_reference():
    """The NFA alone, event by event (``tests/test_cep.py``'s
    ``_advance_all`` form), on every pattern."""
    rows = rows_of_stream(seed=5, keys=1)
    for name, make in PATTERNS.items():
        out = []
        for P, cls in ((PORT, RecordBatch), (REF, JRecordBatch)):
            pat = make(*P).validate()
            nfa = (KeyNFA if P is PORT else JKeyNFA)(pat)
            got = []
            for r in sorted(rows, key=lambda r: r["t"]):
                b = cls.from_pydict({k: [v] for k, v in r.items()})
                hits = [bool(st.evaluate(b)[0]) for st in pat.stages]
                hits += [bool(st.until_condition(b)[0])
                         for st in pat.stages
                         if st.until_condition is not None]
                for m in nfa.advance(r, r["t"], hits):
                    got.append((m.start_ts, m.end_ts,
                                sorted(m.events_by_stage.items())))
                for m in nfa.prune(r["t"]):
                    got.append((m.start_ts, m.end_ts,
                                sorted(m.events_by_stage.items())))
            out.append(got)
        assert out[0] == out[1], name


# ------------------------------------------------------------- the builder


def test_pattern_builder_is_persistent():
    base = Pattern.begin("a").where(lambda b: b["x"] > 0)
    p1 = base.next("b")
    p2 = base.followed_by("c").within(500)
    assert [s.name for s in base.stages] == ["a"]
    assert [s.name for s in p1.stages] == ["a", "b"]
    assert [s.name for s in p2.stages] == ["a", "c"]
    assert base.within_ms is None and p1.within_ms is None
    assert p2.within_ms == 500
    p3 = p1.times(3)
    assert p1.stages[-1].min_times == 1
    assert p3.stages[-1].min_times == 3


def _cond(b):
    return np.asarray(b["v"]) > 0


INVALID = {
    "duplicate names": lambda P: P.begin("a").where(_cond).next("a"),
    "all optional": lambda P: P.begin("a").where(_cond).optional(),
    "begins negated": lambda P: P([
        __import__("dataclasses").replace(
            P.begin("a").where(_cond).stages[0], negated=True)]),
    "negated quantifier": lambda P: P.begin("a").where(_cond)
    .not_next("n").where(_cond).times(2).next("b").where(_cond),
    "negated without where": lambda P: P.begin("a").where(_cond)
    .not_followed_by("n").next("b").where(_cond),
    "negated before optional": lambda P: P.begin("a").where(_cond)
    .not_followed_by("n").where(_cond).followed_by("b").where(_cond)
    .optional().followed_by("d").where(_cond),
    "ends with notNext": lambda P: P.begin("a").where(_cond)
    .not_next("n").where(_cond).within(5),
    "trailing notFollowedBy without within": lambda P: P.begin("a")
    .where(_cond).not_followed_by("n").where(_cond),
}


@pytest.mark.parametrize("name", list(INVALID))
def test_validate_errors_equal_reference(name):
    with pytest.raises(ValueError) as want:
        INVALID[name](JPattern).validate()
    with pytest.raises(ValueError) as got:
        INVALID[name](Pattern).validate()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("call", [
    lambda P: P.begin("a").where(_cond).times(2).until(_cond),
    lambda P: P.begin("a").where(_cond).greedy(),
    lambda P: P.begin("a").where(_cond).times(2).allow_combinations()
    .greedy(),
])
def test_builder_errors_equal_reference(call):
    with pytest.raises(ValueError) as want:
        call(JPattern)
    with pytest.raises(ValueError) as got:
        call(Pattern)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------- the public API


def _job(pkg, pattern_name, rows, select, batch_size=4, lag=10):
    if pkg == "port":
        from flink_tpu_torch import Configuration, StreamExecutionEnvironment
        from flink_tpu_torch.connectors.sinks import CollectSink
        from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
        cep, P = CEP, PORT
        cfg = {"execution.micro-batch.size": batch_size,
               "execution.device": "cpu"}
    else:
        from flink_tpu import Configuration, StreamExecutionEnvironment
        from flink_tpu.connectors.sinks import CollectSink
        from flink_tpu.runtime.watermarks import WatermarkStrategy
        cep, P = JCEP, REF
        cfg = {"execution.micro-batch.size": batch_size}
    env = StreamExecutionEnvironment(Configuration(cfg))
    sink = CollectSink()
    s = env.from_collection(
        rows, timestamp_field="t",
        watermark_strategy=WatermarkStrategy.for_bounded_out_of_orderness(
            lag))
    cep.pattern(s.key_by("k"), PATTERNS[pattern_name](*P)) \
        .select(select).sink_to(sink)
    env.execute()
    return sink.batches


@pytest.mark.parametrize("name", ["fraud", "relaxed", "not_followed_by",
                                  "trailing_not_followed_by",
                                  "within_no_skip_loop", "optional_first"])
def test_cep_select_through_execute_equals_reference(name):
    rows = rows_of_stream(seed=11, n=120)
    for select in (None, select_events):
        want = _job("ref", name, rows, select)
        got = _job("port", name, rows, select)
        assert as_rows(got) == as_rows(want)
    assert want, "vacuous: no match"


def test_cep_end_to_end_keyed_fraud_pattern():
    rows = [{"card": c, "amount": a, "ts": t} for c, a, t in [
        (1, 0.5, 0), (1, 900.0, 10_000), (2, 0.4, 5_000), (2, 3.0, 12_000),
        (2, 0.6, 20_000), (2, 700.0, 90_000), (3, 0.9, 30_000),
        (3, 600.0, 80_000)]]
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy

    p = (Pattern.begin("small").where(lambda b: b["amount"] < 1.0)
         .followed_by("big").where(lambda b: b["amount"] > 500.0)
         .within(60_000))
    env = StreamExecutionEnvironment(Configuration(
        {"execution.micro-batch.size": 3, "execution.device": "cpu"}))
    sink = CollectSink()
    s = env.from_collection(
        rows, timestamp_field="ts",
        watermark_strategy=WatermarkStrategy.for_bounded_out_of_orderness(
            0))
    CEP.pattern(s.key_by("card"), p).select(lambda key, m, ev: {
        "card": key, "big": ev["big"][0]["amount"]}).sink_to(sink)
    env.execute()
    out = sink.result()
    assert sorted(zip(out["card"].tolist(), out["big"].tolist())) == [
        (1, 900.0), (3, 600.0)]


# ------------------------------------------------------------- checkpoints


def _snap_rows(snap):
    """A CepOperator snapshot with its tuples as lists (pickling-neutral)."""
    return {"nfas": {int(k): {**v, "partials": [
        {**p, "events": [list(e) for e in p["events"]]}
        for p in v["partials"]]} for k, v in snap["nfas"].items()},
        "pending": {int(k): [list(e) for e in v]
                    for k, v in snap["pending"].items()},
        "key_values": snap["key_values"]}


@pytest.mark.parametrize("name", ["one_or_more", "not_followed_by",
                                  "trailing_skip_past", "within"])
def test_snapshot_equals_reference_and_restores(name):
    rows = rows_of_stream(seed=21, n=90)
    make = PATTERNS[name]
    pb, jb = batches_of(rows, RecordBatch), batches_of(rows, JRecordBatch)
    want = drive(CepOperator(make(*PORT), "k"), pb)
    snaps = {}

    def take(tag, fresh):
        def hook(i, op):
            if i == 5:
                snaps[tag] = op.snapshot_state()
                if fresh is None:
                    return None
                nxt = fresh()
                nxt.restore_state(snaps[tag])
                return nxt
        return hook

    drive(JCepOperator(make(*REF), "k"), jb, hook=take("ref", None))
    got = drive(CepOperator(make(*PORT), "k"), pb, hook=take(
        "port", lambda: CepOperator(make(*PORT), "k")))
    assert as_rows(got) == as_rows(want)
    assert _snap_rows(snaps["port"]) == _snap_rows(snaps["ref"])
    # the reference's snapshot restores into the port and continues equal

    def from_ref(i, op):
        if i == 5:
            nxt = CepOperator(make(*PORT), "k")
            nxt.restore_state(snaps["ref"])
            return nxt

    cross = drive(CepOperator(make(*PORT), "k"), pb, hook=from_ref)
    assert as_rows(cross) == as_rows(want)
