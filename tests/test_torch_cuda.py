"""The port on a CUDA card: its kernels and the device paths against
their CPU runs. Every test is marked ``cuda`` and skips without a card
(decided inside the test). This file imports no JAX, so it also runs on a
GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the rank and Count are integers, bit-identical; Q5's rows are
counts, equal; the join and CEP engines' batches, snapshots and planes
(and the CEP advance's and prune's outputs) are compared byte for byte; the ordered fold, its grouping, the slice merge
and the float32 Sum job are compared on their raw bits against the CPU
(NaN payloads included).
"""

import numpy as np
import pytest
import torch


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_rank_kernel_bit_identical_to_plain():
    """Shapes across tile boundaries (4096 lanes), with out-of-range
    lanes, the [C] and [R, C] forms, and the largest D the kernel holds."""
    _need_card()
    from flink_tpu_torch.stateplane.rank import rank, rank_plain

    rng = np.random.default_rng(3)
    for R, C, D in [(1, 1, 1), (1, 1023, 3), (3, 1025, 8), (8, 131072, 8),
                    (2, 5000, 64), (1, 70000, 1024), (2, 4097, 1024)]:
        d = torch.from_numpy(
            rng.integers(-3, D + 3, size=(R, C)).astype(np.int32)).cuda()
        assert torch.equal(rank(d, D), rank_plain(d, D))
        assert torch.equal(rank(d[0], D), rank_plain(d[0], D))


@pytest.mark.cuda
def test_flat_rank_one_launch_per_call():
    """The flat form is the same kernel with its int64 epilogue: one
    launch per call, equal to exchange_rank_flat_plain across tile
    boundaries, with ranks past the bucket width and negative lanes."""
    _need_card()
    from flink_tpu_torch.stateplane.rank import (
        exchange_rank_flat,
        exchange_rank_flat_plain,
        rank,
    )

    rng = np.random.default_rng(5)
    for R, C, D, W in [(1, 1, 1, 1), (1, 4095, 3, 100), (3, 4097, 8, 64),
                       (8, 131072, 8, 32768), (2, 70000, 64, 300),
                       (8, 4096 * 33 + 7, 5, 1), (1, 9000, 1024, 3)]:
        d = torch.from_numpy(
            rng.integers(-3, D + 3, size=(R, C)).astype(np.int32)).cuda()
        for _ in range(3):  # repeated calls reuse the status buffer
            before = rank.launches
            got = exchange_rank_flat(d, D, W)
            assert rank.launches == before + 1
            assert got.dtype == torch.int64
            assert torch.equal(got, exchange_rank_flat_plain(d, D, W))


@pytest.mark.cuda
def test_ordered_fold_bit_identical_to_cpu():
    """The ordered fold on the card against index_add_ on the CPU (the
    stream-order fold), as one plane: uniform slots, Zipf(1.1) over 100k
    keys, and half the lanes at the identity slot 0 (dropped by the
    kernel, folded with the identity by the CPU); max/min with NaN and
    signed zeros against the plain version."""
    _need_card()
    from flink_tpu_torch.stateplane.fold import (
        ordered_fold_planes,
        ordered_scatter_reduce_plain,
    )

    rng = np.random.default_rng(8)
    n = 1 << 18
    p = np.arange(1, 100_001, dtype=np.float64) ** -1.1
    cases = {
        "uniform": rng.integers(0, 4096, n),
        "zipf": rng.choice(100_000, size=n, p=p / p.sum()) + 1,
        "slot0": np.where(rng.random(n) < 0.5, 0, rng.integers(1, 64, n)),
    }
    for name, t in cases.items():
        target = torch.from_numpy(t.astype(np.int64))
        slots = target.to(torch.int32)[None].cuda()
        v = torch.from_numpy((rng.standard_normal(n)
                              * np.exp(rng.uniform(-8, 8, n)))
                             .astype(np.float32))
        v[target == 0] = 0.0                 # the identity slot's lanes
        size = int(t.max()) + 1
        want = torch.zeros(size).index_add_(0, target, v)
        before = ordered_fold_planes.launches
        got = ordered_fold_planes(torch.zeros(1, size, device="cuda"), slots,
                                  v[None].cuda(), "sum")
        assert ordered_fold_planes.launches == before + 1
        assert torch.equal(got[0].cpu().view(torch.int32),
                           want.view(torch.int32)), name
        vs = v.clone()
        pick = torch.from_numpy(rng.random(n))
        vs[pick < 0.02] = float("nan")
        vs[(pick >= 0.02) & (pick < 0.3)] = 0.0
        vs[(pick >= 0.3) & (pick < 0.6)] = -0.0
        for reduce, ident in (("max", -np.inf), ("min", np.inf)):
            vr = vs.masked_fill(target == 0, float(ident))
            acc = torch.full((size,), float(ident))
            want = ordered_scatter_reduce_plain(acc.clone(), target, vr,
                                                reduce)
            got = ordered_fold_planes(acc[None].cuda(), slots,
                                      vr[None].cuda(), reduce)
            assert torch.equal(got[0].cpu().view(torch.int32),
                               want.view(torch.int32)), (name, reduce)


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


def _special_values(rng, n, dtype):
    """Wide-range values with NaN payloads (signalling, quiet, negative),
    +inf and -inf sprinkled in."""
    v = rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))
    v = v.astype(np.float32 if dtype == torch.float32 else np.float64)
    ib = v.view(np.int32 if v.itemsize == 4 else np.int64)
    pick = rng.random(n)
    if v.itemsize == 4:
        nans = [0x7FA00001, 0x7FC0000A, -0x003FFFFB]      # 0xffc00005
    else:
        nans = [0x7FF4000000000001, 0x7FF800000000000A,
                -0x0007FFFFFFFFFFFB]
    for j, b in enumerate(nans):
        sel = (pick >= 0.002 * j) & (pick < 0.002 * (j + 1))
        ib[sel] = b + rng.integers(0, 1 << 10, int(sel.sum()))
    v[(pick >= 0.01) & (pick < 0.02)] = np.inf
    v[(pick >= 0.02) & (pick < 0.03)] = -np.inf
    return torch.from_numpy(v)


@pytest.mark.cuda
def test_fold_planes_edge_cases_bit_identical_to_cpu():
    """ordered_fold_planes on the card against its plain version on the
    CPU: an empty plane, L = 0, a plane whose every lane is on slot 0, a
    cap that is not a power of two, runs past the long-run threshold,
    sums that meet NaN payloads and inf - inf, and float64."""
    _need_card()
    from flink_tpu_torch.stateplane.fold import (
        ordered_fold_planes,
        ordered_fold_planes_plain,
    )

    rng = np.random.default_rng(12)
    for dtype in (torch.float32, torch.float64):
        for P, L, cap in [(3, 0, 100), (1, 1, 1), (4, 5000, 1000),
                          (8, 20000, 65536), (2, 70000, 70001),
                          (3, 300000, 5)]:
            slots = rng.integers(0, cap, (P, L)).astype(np.int32)
            if L:
                slots[0] = 0                     # every lane on slot 0
                slots[-1, : L // 2] = min(cap - 1, 3)   # one hot slot
            s = torch.from_numpy(slots)
            for reduce, ident in (("sum", 0.0), ("max", -np.inf),
                                  ("min", np.inf)):
                v = _special_values(rng, P * L, dtype).view(P, L)
                v[s == 0] = ident                # padding carries identity
                acc = _special_values(rng, P * cap, dtype).view(P, cap)
                acc[:, 0] = ident
                if reduce != "sum":   # max/min write the canonical NaN
                    acc[torch.isnan(acc)] = 0.0
                want = ordered_fold_planes_plain(acc.clone(), s, v, reduce)
                before = ordered_fold_planes.launches
                got = ordered_fold_planes(acc.cuda(), s.cuda(), v.cuda(),
                                          reduce)
                torch.cuda.synchronize()
                assert ordered_fold_planes.launches == before + (L > 0)
                assert torch.equal(_bits(got.cpu()), _bits(want)), \
                    (dtype, P, L, cap, reduce)


@pytest.mark.cuda
def test_grouping_equals_stable_sort():
    """The radix grouping alone against a stable sort on the CPU: one,
    two and three passes, identity-slot and out-of-range lanes dropped."""
    _need_card()
    from flink_tpu_torch.stateplane.fold import (
        group_planes,
        group_planes_plain,
    )

    rng = np.random.default_rng(13)
    for P, L, cap in [(2, 9000, 200), (8, 40000, 1 << 16),
                      (1, 100000, (1 << 17) + 3), (3, 5000, 1 << 20)]:
        slots = torch.from_numpy(
            rng.integers(-2, cap + 2, (P, L)).astype(np.int32))
        v = torch.from_numpy(rng.standard_normal((P, L)).astype(np.float32))
        got = group_planes(slots.cuda(), v.cuda(), cap)
        want = group_planes_plain(slots, v, cap)
        for (gk, gv), (wk, wv) in zip(got, want):
            assert torch.equal(gk.cpu(), wk), (P, L, cap)
            assert torch.equal(_bits(gv.cpu()), _bits(wv)), (P, L, cap)


@pytest.mark.cuda
def test_merge_sum_nan_card_equals_cpu():
    """The fire's slice merge of float sums on the card against the CPU,
    NaN payloads and inf - inf included, float32 and float64."""
    _need_card()
    from flink_tpu_torch.ops.segment_ops import MERGE_FN

    rng = np.random.default_rng(14)
    for dtype in (torch.float32, torch.float64):
        for k in (1, 2, 5, 16):
            x = _special_values(rng, 8 * 512 * k, dtype).view(8, 512, k)
            want = MERGE_FN["sum"](x)
            got = MERGE_FN["sum"](x.cuda())
            assert torch.equal(_bits(got.cpu()), _bits(want)), (dtype, k)


@pytest.mark.cuda
def test_fold_planes_checks_and_counts():
    """One counted launch per call that has lanes; what the kernel does
    not take raises (no fallback)."""
    _need_card()
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes

    acc = torch.zeros(2, 64, device="cuda")
    s = torch.ones(2, 10, dtype=torch.int32, device="cuda")
    v = torch.ones(2, 10, device="cuda")
    before = ordered_fold_planes.launches
    ordered_fold_planes(acc, s, v, "sum")
    ordered_fold_planes(acc, s[:, :0], v[:, :0], "sum")
    assert ordered_fold_planes.launches == before + 1
    assert acc[:, 1].tolist() == [10.0, 10.0]
    with pytest.raises(TypeError):
        ordered_fold_planes(acc, s.to(torch.int64), v, "sum")
    with pytest.raises(TypeError):
        ordered_fold_planes(acc, s, v.double(), "sum")
    with pytest.raises(ValueError):
        ordered_fold_planes(acc, s, v, "mean")
    with pytest.raises(ValueError):
        ordered_fold_planes(acc, s.t().contiguous().t(), v, "sum")
    with pytest.raises(ValueError):
        ordered_fold_planes(acc, s[:1], v[:1], "sum")


@pytest.mark.cuda
def test_rank_wrapper_checks_and_counts():
    _need_card()
    from flink_tpu_torch.stateplane.rank import rank

    d = torch.zeros(64, dtype=torch.int32, device="cuda")
    before = rank.launches
    rank(d, 4)
    assert rank.launches == before + 1
    with pytest.raises(TypeError):
        rank(d.to(torch.int64), 4)
    with pytest.raises(ValueError):
        rank(d, 1025)
    with pytest.raises(ValueError):
        rank(torch.zeros(4, 64, dtype=torch.int32, device="cuda").t(), 4)


@pytest.mark.cuda
def test_q5_on_card_equals_cpu_run():
    _need_card()
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.stateplane.rank import rank

    def run(device):
        env = StreamExecutionEnvironment(Configuration({
            "execution.micro-batch.size": 1 << 14,
            "parallelism.default": 8, "execution.device": device}))
        sink = CollectSink()
        build_q5(env, BidSource(total_records=150_000, num_auctions=3_000,
                                events_per_second_of_eventtime=100_000)
                 ).sink_to(sink)
        env.execute()
        return sorted(sorted(r.items()) for r in sink.rows())

    before = rank.launches
    on_card = run("cuda")
    assert rank.launches > before
    assert on_card == run("cpu")


@pytest.mark.cuda
def test_q5_revenue_on_card_equals_cpu_run():
    """The float32 Sum job (Q5-revenue) at a small size: the card's fired
    rows equal the CPU run's bit for bit, through the ordered fold."""
    _need_card()
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows

    def run(device):
        env = StreamExecutionEnvironment(Configuration({
            "execution.micro-batch.size": 1 << 14,
            "parallelism.default": 8, "execution.device": device}))
        sink = CollectSink()
        (env.from_source(BidSource(total_records=150_000,
                                   num_auctions=3_000,
                                   events_per_second_of_eventtime=100_000),
                         WatermarkStrategy.for_bounded_out_of_orderness(0))
         .key_by("auction")
         .window(SlidingEventTimeWindows.of(10_000, 2_000))
         .sum("price").sink_to(sink))
        env.execute()
        res = sink.result()
        return {c: np.asarray(res[c]) for c in
                ("auction", "window_end", "sum_price")}

    before = ordered_fold_planes.launches
    on_card = run("cuda")
    assert ordered_fold_planes.launches > before
    on_cpu = run("cpu")
    assert len(on_card["sum_price"]) > 0
    for c in ("auction", "window_end"):
        np.testing.assert_array_equal(on_card[c], on_cpu[c])
    np.testing.assert_array_equal(on_card["sum_price"].view(np.int32),
                                  on_cpu["sum_price"].view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("job", ["q5", "revenue"])
def test_parallelism_one_on_card_equals_cpu_run(job):
    """Q5 (device top-k 16) and Q5-revenue at parallelism 1, bench.py's
    slot layout: the card's sink rows equal the CPU run's, in order and
    bit for bit; the float Sum folds through the ordered fold."""
    _need_card()
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows

    def run(device):
        env = StreamExecutionEnvironment(Configuration({
            "execution.micro-batch.size": 1 << 14,
            "parallelism.default": 1, "execution.device": device,
            "state.window-layout": "slots"}))
        sink = CollectSink()
        src = BidSource(total_records=150_000, num_auctions=3_000,
                        events_per_second_of_eventtime=20_000)
        if job == "q5":
            build_q5(env, src, device_top_k=16).sink_to(sink)
        else:
            (env.from_source(src,
                             WatermarkStrategy.for_bounded_out_of_orderness(0))
             .key_by("auction")
             .window(SlidingEventTimeWindows.of(10_000, 2_000))
             .sum("price").sink_to(sink))
        env.execute()
        return [{k: np.asarray(v).tobytes() for k, v in r.items()}
                for r in sink.rows()]

    before = ordered_fold_planes.launches
    on_card = run("cuda")
    if job == "revenue":
        assert ordered_fold_planes.launches > before
    assert on_card and on_card == run("cpu")


@pytest.mark.cuda
def test_slot_table_under_eviction_on_card_equals_cpu():
    """A float32 Sum table with NaN payloads and +-inf over a device
    budget of 1024 slots: spills, reloads, device and hybrid fires on the
    card equal the CPU's bit for bit."""
    _need_card()
    from flink_tpu_torch.state.slot_table import SlotTable
    from flink_tpu_torch.windowing.aggregates import SumAggregate

    rng = np.random.default_rng(21)
    tables = {d: SlotTable(SumAggregate("v"), capacity=1024,
                           max_device_slots=1024, device=d)
              for d in ("cuda", "cpu")}
    keys = np.arange(1, 401, dtype=np.int64)
    for ns in (2, 4, 6, 8, 10, 2):
        vals = _special_values(rng, 400, torch.float32).numpy()
        for t in tables.values():
            t.upsert(keys, np.full(400, ns, np.int64), (vals,))
    card, cpu = tables["cuda"], tables["cpu"]
    assert len(card.spill) > 0
    assert sorted(card.spill.namespaces) == sorted(cpu.spill.namespaces)
    resident = sorted(int(n) for n in card.index.namespaces)
    gk, gm = card.build_slice_matrix(resident)
    wk, wm = cpu.build_slice_matrix(resident)
    np.testing.assert_array_equal(gk, wk)
    got, want = card.fire(gm), cpu.fire(wm)
    assert np.array_equal(got["sum_v"].view(np.int32),
                          want["sum_v"].view(np.int32))
    gk, got = card.fire_hybrid([2, 4, 6, 8, 10])
    wk, want = cpu.fire_hybrid([2, 4, 6, 8, 10])
    np.testing.assert_array_equal(gk, wk)
    assert np.array_equal(got["sum_v"].view(np.int32),
                          want["sum_v"].view(np.int32))
    assert card.spill_counters() == cpu.spill_counters()


@pytest.mark.cuda
def test_merge_sum_past_27_slices_card_equals_cpu():
    """The vector-lane and chunked orders of the slice merge past 27
    slices on the card equal the CPU's."""
    _need_card()
    from flink_tpu_torch.ops.segment_ops import MERGE_FN

    rng = np.random.default_rng(15)
    for dtype in (torch.float32, torch.float64):
        for k in (28, 31, 32, 33, 47, 64, 80, 129):
            x = _special_values(rng, 4096 * k, dtype).view(4096, k)
            want = MERGE_FN["sum"](x)
            got = MERGE_FN["sum"](x.cuda())
            assert torch.equal(_bits(got.cpu()), _bits(want)), (dtype, k)


@pytest.mark.cuda
def test_top_k_project_on_card_equals_cpu():
    """The device top-k keeps lax.top_k's order on the card: ties lowest
    index first, integer and float scores."""
    _need_card()
    from flink_tpu_torch.windowing.fire_projectors import TopKFireProjector

    rng = np.random.default_rng(16)
    n = 100_000
    valid = torch.from_numpy(rng.random(n) < 0.9)
    for score in (torch.from_numpy(rng.integers(0, 5, n).astype(np.int32)),
                  _special_values(rng, n, torch.float32)):
        for desc in (True, False):
            p = TopKFireProjector("s", k=16, descending=desc)
            want = p.project({"s": score}, valid)[0]
            got = p.project({"s": score.cuda()}, valid.cuda())[0]
            assert torch.equal(got.cpu(), want), (score.dtype, desc)


def _payload_specials(rng, shape, dtype):
    """NaN payloads (signalling, quiet, negative), +-1, +-0 and +-inf."""
    bits = {torch.float32: np.array(
        [0x7FA00001, 0x7FC00002, 0xFFC00003, 0xFFA00004, 0x3F800000,
         0xBF800000, 0, 0x80000000, 0x7F800000, 0xFF800000], np.uint32),
        torch.float64: np.array(
        [0x7FF4000000000001, 0x7FF8000000000002, 0xFFF8000000000003,
         0xFFF4000000000004, 0x3FF0000000000000, 0xBFF0000000000000, 0,
         0x8000000000000000, 0x7FF0000000000000, 0xFFF0000000000000],
        np.uint64)}[dtype]
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    return torch.from_numpy(rng.choice(bits, shape).view(np_dt))


@pytest.mark.cuda
def test_max_min_nan_payloads_card_equal_cpu():
    """The ordered fold's max/min modes keep the CPU's NaN payloads on the
    card (first priority-signed NaN, else the last NaN, starting values
    included), and the fires' max/min merges — the slot fires' last axis
    and the pane fire's leading axis, with the slices met in vector lanes
    from 23 to 32 — give the CPU's bits."""
    _need_card()
    from flink_tpu_torch.ops.segment_ops import MERGE_FN, MERGE_ROWS_FN
    from flink_tpu_torch.stateplane.fold import (
        ordered_fold_planes,
        ordered_fold_planes_plain,
    )

    rng = np.random.default_rng(25)
    for dtype in (torch.float32, torch.float64):
        for reduce in ("max", "min"):
            for cap, n in ((64, 1 << 16), (1 << 17, 1 << 18)):
                acc = _payload_specials(rng, (2, cap), dtype)
                acc[:, 0] = float("-inf" if reduce == "max" else "inf")
                slots = torch.from_numpy(rng.integers(
                    0, cap, (2, n)).astype(np.int32))
                v = _payload_specials(rng, (2, n), dtype)
                v[slots == 0] = acc[0, 0]
                want = ordered_fold_planes_plain(acc.clone(), slots, v,
                                                 reduce)
                got = ordered_fold_planes(acc.cuda(), slots.cuda(),
                                          v.cuda(), reduce)
                assert torch.equal(_bits(got.cpu()), _bits(want)), \
                    (dtype, reduce, cap)
            for k in (1, 5, 22, 23, 24, 25, 28, 32, 33):
                x = _payload_specials(rng, (1024, k), dtype)
                for fn, arg in ((MERGE_FN[reduce], x),
                                (MERGE_ROWS_FN[reduce], x.T.contiguous())):
                    assert torch.equal(_bits(fn(arg.cuda()).cpu()),
                                       _bits(fn(arg))), (dtype, reduce, k)


@pytest.mark.cuda
def test_pane_programs_on_card_equal_cpu():
    """The pane programs on the card — the combined scatter of a float32
    Sum with NaN payloads and +-inf through the ordered fold on the
    [1, R*C] view, the fire and the window-partial fold — equal the
    CPU's bit for bit, and the scatter launches the kernel."""
    _need_card()
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes
    from flink_tpu_torch.stateplane.pane import pane_programs
    from flink_tpu_torch.windowing.aggregates import (
        CountAggregate,
        MinAggregate,
        MultiAggregate,
        SumAggregate,
    )

    rng = np.random.default_rng(26)
    agg = MultiAggregate([SumAggregate("v", output="s"),
                          CountAggregate(output="n"),
                          MinAggregate("v", output="lo")])
    prog = pane_programs(agg)
    R, C, n = 16, 1 << 14, 1 << 18
    flat = torch.from_numpy((rng.integers(1, R, n) * C
                             + rng.integers(1, C, n)).astype(np.int32))
    flat[torch.from_numpy(rng.random(n) < 0.1)] = 0
    v = _special_values(rng, n, torch.float32)
    v[flat == 0] = 0.0
    vmin = v.clone()
    vmin[flat == 0] = float("inf")
    out = {}
    for dev in ("cpu", "cuda"):
        accs = tuple(torch.full((R, C), float(i), dtype=dt, device=dev)
                     for i, dt in ((0.0, torch.float32), (0, torch.int32),
                                   (float("inf"), torch.float32))) + (
            torch.zeros((R, C), dtype=torch.int8, device=dev),)
        before = ordered_fold_planes.launches
        accs = prog[0](accs, flat.to(dev), (v.to(dev), vmin.to(dev)))
        if dev == "cuda":
            assert ordered_fold_planes.launches == before + 2
        rows = torch.tensor([3, 0, 7, 1, 9], dtype=torch.int32, device=dev)
        cols, valid = prog[2](accs, rows, C)
        accs = prog[5](accs, 2, rows, C)
        out[dev] = [a.cpu() for a in accs] + [valid.cpu()] + [
            cols[k].cpu() for k in sorted(cols)]
    for got, want in zip(out["cuda"], out["cpu"]):
        if got.dtype.is_floating_point:
            got, want = _bits(got), _bits(want)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("preagg", [True, False])
@pytest.mark.parametrize("job", ["q5", "revenue"])
def test_panes_on_card_equal_cpu_run(job, preagg):
    """Q5 (device top-k 16) and Q5-revenue at parallelism 1 in the pane
    layout, with and without pre-aggregation: the card's sink rows equal
    the CPU run's, in order and bit for bit."""
    _need_card()
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows

    def run(device):
        env = StreamExecutionEnvironment(Configuration({
            "execution.micro-batch.size": 1 << 14,
            "parallelism.default": 1, "execution.device": device,
            "state.window-layout": "panes",
            "state.slot-table.capacity": 1 << 14,
            "latency.pane-preagg": preagg}))
        sink = CollectSink()
        src = BidSource(total_records=150_000, num_auctions=3_000,
                        events_per_second_of_eventtime=20_000)
        if job == "q5":
            build_q5(env, src, device_top_k=16).sink_to(sink)
        else:
            (env.from_source(src,
                             WatermarkStrategy.for_bounded_out_of_orderness(0))
             .key_by("auction")
             .window(SlidingEventTimeWindows.of(10_000, 2_000))
             .sum("price").sink_to(sink))
        env.execute()
        return [{k: np.asarray(v).tobytes() for k, v in r.items()}
                for r in sink.rows()]

    before = ordered_fold_planes.launches
    on_card = run("cuda")
    if job == "revenue":
        assert ordered_fold_planes.launches > before
    assert on_card and on_card == run("cpu")


@pytest.mark.cuda
def test_flat_merge_pairs_on_card_equals_cpu():
    """The session merge on the card (the ordered fold for float leaves,
    one launch per float leaf) against the CPU: duplicate destinations,
    padded 0/0 lanes, NaN payloads, +-inf and signed zeros; every plane
    bit for bit apart from the reserved slot 0, which both leave at the
    identity."""
    _need_card()
    from flink_tpu_torch.stateplane.families import flat_merge_pairs
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes
    from flink_tpu_torch.windowing import aggregates as tagg

    rng = np.random.default_rng(21)
    cap, pairs, size = 1 << 19, 30_000, 32_768
    for agg in (tagg.CountAggregate(), tagg.SumAggregate("v"),
                tagg.SumAggregate("v", dtype=np.float64),
                tagg.MaxAggregate("v"), tagg.MinAggregate("v"),
                tagg.AvgAggregate("v")):
        planes = []
        for leaf in agg.leaves:
            if np.dtype(leaf.dtype).kind == "f":
                p = _special_values(rng, cap, torch.float64 if np.dtype(
                    leaf.dtype).itemsize == 8 else torch.float32)
                if leaf.reduce != "sum":
                    p[torch.from_numpy(rng.random(cap) < 0.2)] = 0.0
                    p[torch.from_numpy(rng.random(cap) < 0.2)] = -0.0
            else:
                p = torch.from_numpy(rng.integers(0, 1000, cap)
                                     .astype(leaf.dtype))
            p[0] = float(leaf.identity)
            planes.append(p)
        perm = rng.permutation(np.arange(1, cap))
        dst = np.zeros(size, np.int32)
        src = np.zeros(size, np.int32)
        dst[:pairs] = rng.choice(perm[:pairs // 5], pairs)
        src[:pairs] = perm[cap // 2:cap // 2 + pairs]
        prog = flat_merge_pairs(agg.leaves)
        want = prog(tuple(p.clone() for p in planes), torch.from_numpy(dst),
                    torch.from_numpy(src))
        before = ordered_fold_planes.launches
        got = prog(tuple(p.cuda() for p in planes),
                   torch.from_numpy(dst).cuda(), torch.from_numpy(src).cuda())
        torch.cuda.synchronize()
        floats = sum(np.dtype(l.dtype).kind == "f" for l in agg.leaves)
        assert ordered_fold_planes.launches == before + floats
        for g, w in zip(got, want):
            assert torch.equal(_bits(g.cpu()) if g.is_floating_point()
                               else g.cpu(),
                               _bits(w) if w.is_floating_point() else w), \
                type(agg).__name__


@pytest.mark.cuda
def test_session_job_on_card_equals_cpu_run():
    """A float32 Sum session job through the public API under a device
    budget (the paged tier evicts and reloads): the card's sink rows equal
    the CPU's, in order and bit for bit, with equal spill counters."""
    _need_card()
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.connectors.sources import DataGenSource
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.windowing.assigners import EventTimeSessionWindows

    def run(device):
        env = StreamExecutionEnvironment(Configuration({
            "execution.micro-batch.size": 1 << 13,
            "state.slot-table.capacity": 1 << 15,
            "state.slot-table.max-device-slots": 1 << 15,
            "execution.device": device}))
        sink = CollectSink()
        (env.from_source(DataGenSource(400_000, 200_000, 400_000, seed=3),
                         WatermarkStrategy.for_bounded_out_of_orderness(0))
            .key_by("key").window(EventTimeSessionWindows.with_gap(2_000))
            .sum("value").sink_to(sink))
        env.execute()
        return sink.result()

    got, want = run("cuda"), run("cpu")
    assert len(got) == len(want) > 0
    for name in want.names():
        a, b = np.asarray(got[name]), np.asarray(want[name])
        if a.dtype.kind == "f":
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(a, b, err_msg=name)


def _mesh_planes(rng, agg, P, cap):
    """One ``[P, cap]`` plane per leaf on the CPU: specials for floats
    (signed zeros too for max/min), integers otherwise; slot 0 the
    identity."""
    planes = []
    for leaf in agg.leaves:
        if np.dtype(leaf.dtype).kind == "f":
            td = (torch.float64 if np.dtype(leaf.dtype).itemsize == 8
                  else torch.float32)
            p = _special_values(rng, P * cap, td).view(P, cap)
            if leaf.reduce != "sum":
                p[torch.from_numpy(rng.random((P, cap)) < 0.2)] = 0.0
                p[torch.from_numpy(rng.random((P, cap)) < 0.2)] = -0.0
        else:
            p = torch.from_numpy(rng.integers(0, 1000, (P, cap))
                                 .astype(leaf.dtype))
        p[:, 0] = float(leaf.identity)
        planes.append(p)
    return planes


def _planes_equal(got, want, what):
    for g, w in zip(got, want):
        g = g.cpu()
        assert torch.equal(_bits(g) if g.is_floating_point() else g,
                           _bits(w) if w.is_floating_point() else w), what


@pytest.mark.cuda
def test_session_merge_step_on_card_equals_cpu():
    """The mesh session merge on the card (the ordered fold on the
    [P, cap] planes for float leaves, one launch per float leaf) against
    the CPU: [8, M] blocks with repeated destinations, shards with few or
    no pairs, padded 0/0 lanes, NaN payloads, +-inf and signed zeros;
    every plane bit for bit."""
    _need_card()
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_sessions import (
        build_session_merge_step,
    )
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes
    from flink_tpu_torch.windowing import aggregates as tagg

    rng = np.random.default_rng(22)
    P, cap, M = 8, 1 << 16, 8192
    for agg in (tagg.CountAggregate(), tagg.SumAggregate("v"),
                tagg.SumAggregate("v", dtype=np.float64),
                tagg.MaxAggregate("v"), tagg.MinAggregate("v"),
                tagg.AvgAggregate("v")):
        planes = _mesh_planes(rng, agg, P, cap)
        dst = np.zeros((P, M), np.int32)
        src = np.zeros((P, M), np.int32)
        for p in range(P):
            n = M if p == 0 else int(rng.integers(0, M))
            perm = rng.permutation(np.arange(1, cap))
            dst[p, :n] = rng.choice(perm[: max(n // 5, 1)], n)
            src[p, :n] = perm[cap // 2: cap // 2 + n]
        want = build_session_merge_step(make_mesh(P, "cpu"), agg)(
            tuple(p.clone() for p in planes), torch.from_numpy(dst),
            torch.from_numpy(src))
        before = ordered_fold_planes.launches
        got = build_session_merge_step(make_mesh(P, "cuda"), agg)(
            tuple(p.cuda() for p in planes), torch.from_numpy(dst).cuda(),
            torch.from_numpy(src).cuda())
        torch.cuda.synchronize()
        floats = sum(np.dtype(l.dtype).kind == "f" for l in agg.leaves)
        assert ordered_fold_planes.launches == before + floats
        _planes_equal(got, want, type(agg).__name__)


@pytest.mark.cuda
def test_delta_fire_step_on_card_equals_cpu():
    """The delta fire on the card against the CPU: fired columns and the
    planes after the reset, bit for bit, padded lanes at slot 0."""
    _need_card()
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_windower import (
        build_delta_fire_step,
    )
    from flink_tpu_torch.windowing import aggregates as tagg

    rng = np.random.default_rng(23)
    P, cap, W = 8, 1 << 16, 4096
    for agg in (tagg.CountAggregate(), tagg.SumAggregate("v"),
                tagg.MaxAggregate("v"), tagg.AvgAggregate("v")):
        planes = _mesh_planes(rng, agg, P, cap)
        sm = np.zeros((P, W, 1), np.int32)
        rs = np.zeros((P, W), np.int32)
        for p in range(P):
            n = int(rng.integers(0, W))
            sm[p, :n, 0] = rs[p, :n] = rng.permutation(
                np.arange(1, cap))[:n]
        w_accs, w_out = build_delta_fire_step(make_mesh(P, "cpu"), agg)(
            tuple(p.clone() for p in planes), torch.from_numpy(sm),
            torch.from_numpy(rs))
        g_accs, g_out = build_delta_fire_step(make_mesh(P, "cuda"), agg)(
            tuple(p.cuda() for p in planes), torch.from_numpy(sm).cuda(),
            torch.from_numpy(rs).cuda())
        torch.cuda.synchronize()
        _planes_equal(g_accs, w_accs, type(agg).__name__)
        assert sorted(g_out) == sorted(w_out)
        _planes_equal([g_out[n] for n in sorted(w_out)],
                      [w_out[n] for n in sorted(w_out)], type(agg).__name__)


@pytest.mark.cuda
@pytest.mark.parametrize("agg", ["sum", "max"])
def test_mesh_session_job_on_card_equals_cpu_run(agg):
    """A session job at parallelism 8 through the public API under a
    1<<10-row budget per shard (the mesh paged tier evicts and reloads):
    the card's sink rows equal the CPU's, in order and bit for bit, with
    equal spill counters and merge groups. ``max``: out-of-order records
    with NaN payloads and signed zeros, so sessions merge."""
    _need_card()
    from flink_tpu_torch.benchmarks.session_profile import run_sessions
    from flink_tpu_torch.connectors.sources import DataGenSource, _splitmix64

    settings = {"parallelism.default": 8,
                "execution.micro-batch.size": 1 << 12,
                "state.slot-table.capacity": 1 << 10,
                "state.slot-table.max-device-slots": 1 << 10}
    src_cls = DataGenSource
    kw = {}
    if agg == "max":
        class Jittered(DataGenSource):
            def _generate(self, idx):
                b = super()._generate(idx)
                late = (_splitmix64(idx, 99) % np.uint64(3000)).astype(
                    np.int64)
                vals = _special_values(np.random.default_rng(int(idx[0])),
                                       len(idx), torch.float32).numpy()
                vals[np.random.default_rng(int(idx[0]) + 1)
                     .random(len(idx)) < 0.2] = -0.0
                return b.with_column("value", vals).with_timestamps(
                    b.timestamps - late)

        src_cls, kw = Jittered, {"agg": "max", "out_of_orderness": 3000}
    runs = [run_sessions(src_cls(300_000, 30_000, 400_000, seed=3), dev,
                         settings, **kw) for dev in ("cuda", "cpu")]
    (got, _, _, geng), (want, _, _, weng) = runs
    g, w = got.result(), want.result()
    assert len(g) == len(w) > 0
    for name in w.names():
        a, b = np.asarray(g[name]), np.asarray(w[name])
        if a.dtype.kind == "f":
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert geng.spill_counters() == weng.spill_counters()
    assert geng.spill_counters()["rows_evicted"] > 0
    assert geng.merge_groups == weng.merge_groups
    if agg == "max":
        assert geng.merge_groups > 0


def _engine(kind, device):
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_sessions import MeshSessionEngine
    from flink_tpu_torch.parallel.sharded_windower import MeshWindowEngine
    from flink_tpu_torch.windowing.aggregates import SumAggregate
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.windowing.sessions import SessionWindower
    from flink_tpu_torch.windowing.windower import (
        PaneWindower,
        SliceSharedWindower,
    )

    agg = SumAggregate("v")
    asg = SlidingEventTimeWindows.of(3000, 1000)
    if kind == "slots_spill":
        return SliceSharedWindower(asg, agg, capacity=1024, spill={
            "device": device, "max_device_slots": 1024})
    if kind == "mesh_window":
        return MeshWindowEngine(asg, agg, make_mesh(8, device),
                                capacity_per_shard=1024)
    if kind == "panes_preagg":
        return PaneWindower(asg, agg, capacity=1024, device=device)
    if kind == "sessions_paged":
        return SessionWindower(100, agg, capacity=1 << 12, spill={
            "device": device, "max_device_slots": 2048})
    return MeshSessionEngine(100, agg, make_mesh(8, device),
                             capacity_per_shard=1 << 14,
                             max_device_slots=1024)


def _feed(eng, steps):
    from flink_tpu_torch.core.records import KEY_ID_FIELD, RecordBatch

    out = []
    for keys, vals, ts, wm in steps:
        eng.process_batch(RecordBatch.from_pydict(
            {KEY_ID_FIELD: keys, "v": vals}, timestamps=ts))
        for b in eng.on_watermark(int(wm)):
            out.append(b.harvest() if hasattr(b, "harvest") else b)
    return out


def _snap_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _snap_equal(got[k], w)
        elif isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype and \
                got[k].tobytes() == w.tobytes(), k
        else:
            assert got[k] == w, k


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["slots_spill", "panes_preagg",
                                  "mesh_window", "sessions_paged",
                                  "mesh_sessions"])
def test_snapshots_and_restore_on_card_equal_cpu(kind):
    """Full and delta snapshots after the same batches equal on the card
    and the CPU, bit for bit; the card's snapshot restored on the CPU and
    the CPU's on the card continue with the same fires."""
    _need_card()
    rng = np.random.default_rng(8)
    steps = []
    for s in range(10):
        k = rng.integers(0, 6000 if "session" in kind else 400,
                         1500).astype(np.int64)
        v = rng.standard_normal(1500).astype(np.float32)
        ts = (rng.integers(s * 80, s * 80 + 60, 1500) if "session" in kind
              else rng.integers(s * 1000 - 500, s * 1000 + 1000, 1500))
        steps.append((k, v, np.maximum(ts, 0).astype(np.int64),
                      (s - 1) * 80 if "session" in kind else s * 1000 - 1))
    card, cpu = _engine(kind, "cuda"), _engine(kind, "cpu")
    for eng in (card, cpu):
        _feed(eng, steps[:4])
    _snap_equal(card.snapshot(), cpu.snapshot())
    for eng in (card, cpu):
        _feed(eng, steps[4:6])
    snaps = {"cuda": card.snapshot(mode="delta"),
             "cpu": cpu.snapshot(mode="delta")}
    _snap_equal(snaps["cuda"], snaps["cpu"])
    full = {"cuda": card.snapshot(), "cpu": cpu.snapshot()}
    outs = {}
    for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
        eng = _engine(kind, dst)
        eng.restore(full[src])
        outs[dst] = _feed(eng, steps[6:]) + list(eng.on_watermark(1 << 60))
    rows = []
    for batches in outs.values():
        cols = {}
        for b in batches:
            for name in b.names():
                cols.setdefault(name, []).append(np.asarray(b[name]))
        rows.append({n: np.concatenate(c) for n, c in cols.items()})
    assert len(rows[0]["__key_id__"]) > 0
    for name, col in rows[1].items():
        assert rows[0][name].tobytes() == col.tobytes(), name


# ------------------------------------------------------------------ joins

def _mixed_columns(rng, b):
    """int32 and bool columns beside the float32 one on the planes, and
    an int64 one on the host shadow."""
    n = len(b)
    return b.with_column("i", rng.integers(-9, 9, n).astype(np.int32)) \
        .with_column("f", rng.random(n) < 0.5) \
        .with_column("id", rng.integers(0, 1 << 62, n))


def _join_smoke_run(kind, device):
    """One join engine at tools/join_smoke.py's shape, as
    ``chip_smoke.py`` phase 15(c) runs it; "mixed" is the interval
    engine with :func:`_mixed_columns` under the same forced eviction."""
    import chip_smoke

    if kind == "mixed":
        return chip_smoke._js_run("interval", device, extra=_mixed_columns)
    return chip_smoke._js_run(kind, device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["interval", "temporal", "mixed"])
def test_join_engines_on_card_equal_cpu(kind):
    """Both join engines at join_smoke's shape (the interval engine also
    with int32, bool and int64 columns beside the float32 one): every
    emitted batch (in order, bit for bit), every snapshot, every value
    plane outside slot 0, the spill counters and the late-row count equal
    card vs CPU; the interval join's band reaches
    into the page tier, and its ingest launched the rank kernel."""
    _need_card()
    from flink_tpu_torch.stateplane.rank import rank

    before = rank.launches
    card, card_snaps, ce = _join_smoke_run(kind, "cuda")
    launched = rank.launches - before
    cpu, cpu_snaps, pe = _join_smoke_run(kind, "cpu")
    assert len(card) == len(cpu) and sum(len(b) for b in card) > 0
    for a, b in zip(card, cpu):
        assert sorted(a.names()) == sorted(b.names())
        for n in a.names():
            x, y = np.asarray(a[n]), np.asarray(b[n])
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), n
    for a, b in zip(card_snaps, cpu_snaps):
        _snap_equal(a, b)
    # every value plane equal outside the scratch slot 0
    for side in (0, 1):
        for a, b in zip(ce._planes[side] or (), pe._planes[side] or ()):
            assert a.shape == b.shape
            assert a[:, 1:].cpu().numpy().tobytes() == \
                b[:, 1:].numpy().tobytes()
    assert ce.spill_counters() == pe.spill_counters()
    assert launched > 0
    if kind != "temporal":
        sc = ce.spill_counters()
        assert sc["rows_evicted"] > 0 and sc["cold_rows_served"] > 0
    else:
        assert ce.late_left_dropped == pe.late_left_dropped


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["seq3_skip_past", "seq3_no_skip", "churn",
                                  "times_loop", "wide_q29_r7",
                                  "wide_q29_r29"])
def test_cep_engine_on_card_equals_cpu(case):
    """``chip_smoke.py`` 16(b)'s cases (P=8, 256 slots a shard; the
    churn case spills): every emitted batch, the snapshot,
    every plane outside slot 0, the spill counters and the match store's
    answers equal card vs CPU; the ingest launched the rank kernel."""
    _need_card()
    import chip_smoke
    from flink_tpu_torch.stateplane.rank import rank

    before = rank.launches
    card, card_snap, ce = chip_smoke._cep_smoke_run(case, "cuda")
    assert rank.launches - before == chip_smoke.CS_STEPS
    cpu, cpu_snap, pe = chip_smoke._cep_smoke_run(case, "cpu")
    assert len(card) == len(cpu) and sum(len(b) for b in card) > 0
    for a, b in zip(card, cpu):
        assert sorted(a.names()) == sorted(b.names())
        for n in a.names():
            x, y = np.asarray(a[n]), np.asarray(b[n])
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), n
    _snap_equal(card_snap, cpu_snap)
    for a_pl, b_pl in ((ce._planes, pe._planes), (ce._pend, pe._pend),
                       (ce._match_planes, pe._match_planes)):
        for a, b in zip(a_pl, b_pl):
            assert a.shape == b.shape
            assert a[:, 1:].cpu().numpy().tobytes() == \
                b[:, 1:].numpy().tobytes()
    assert ce.spill_counters() == pe.spill_counters()
    q = np.arange(40, dtype=np.int64)
    assert ce.query_match_batch(q) == pe.query_match_batch(q)
    if case == "churn":
        assert ce.spill_counters()["rows_evicted"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("times,within", [([(1, 1), (1, 1)], 2000),
                                          ([(1, 3), (1, 3), (1, 2)], 100),
                                          ([(1, 30)], None)])
def test_cep_advance_and_prune_on_card_equal_cpu(times, within):
    """One ``cep_advance`` and one ``cep_prune`` on random planes (unique
    non-zero slots plus padded lanes on slot 0): every plane, match mask
    and final alive mask equal card vs CPU, bit for bit."""
    _need_card()
    from flink_tpu_torch.cep import kernels
    from flink_tpu_torch.cep.pattern import AfterMatchSkipStrategy, Pattern

    p = None
    for i, (lo, hi) in enumerate(times):
        p = (Pattern.begin("s0", skip=AfterMatchSkipStrategy.NO_SKIP)
             if p is None else p.next(f"s{i}"))
        p = p.where(lambda b, i=i: np.asarray(b["v"]) % len(times) == i)
        if hi > 1:
            p = p.times(lo, hi).consecutive()
    lay = kernels.compile_device_pattern(p.within(within) if within else p)
    rng = np.random.default_rng(lay.n_states)
    P, C, PB, K, E = 8, 1 << 14, 1 << 12, 4096, 16
    planes = [rng.integers(0, 1 << lay.n_states, (P, C)).astype(np.int32)]
    planes += [rng.integers(0, 1 << 31, (P, C)).astype(np.int32)
               for _ in range(lay.ring)]
    pending = [rng.integers(0, 1 << lay.n_stages, (P, PB)).astype(np.int32),
               rng.integers(1, 1 << 31, (P, PB)).astype(np.int32)]
    slots = np.zeros((P, K), dtype=np.int32)
    nev = np.zeros((P, K), dtype=np.int32)
    for p_ in range(P):
        L = int(rng.integers(K // 2, K + 1))
        slots[p_, :L] = rng.permutation(np.arange(1, C))[:L]
        nev[p_, :L] = rng.integers(1, E + 1, L)
    idx = np.where(np.arange(E) < nev[..., None],
                   rng.integers(1, PB, (P, K, E)), 0).astype(np.int32)
    wok = rng.integers(0, 1 << max(lay.ring, 1), (P, K, E)).astype(np.int32)
    keep = np.where(slots != 0, rng.integers(-(1 << 31), 1 << 31, (P, K)),
                    -1).astype(np.int32)
    outs = []
    for dev in ("cuda", "cpu"):
        t = [torch.from_numpy(a.copy()).to(dev) for a in planes]
        m, a = kernels.cep_advance(
            t, [torch.from_numpy(x).to(dev) for x in pending],
            torch.from_numpy(slots).to(dev), torch.from_numpy(idx).to(dev),
            torch.from_numpy(wok).to(dev), torch.from_numpy(nev).to(dev),
            kernels.AdvanceTables.build(lay, torch.device(dev)))
        kernels.cep_prune(t[0], torch.from_numpy(slots).to(dev),
                          torch.from_numpy(keep).to(dev))
        outs.append([x.cpu().numpy() for x in (m, a, *t)])
    for x, y in zip(*outs):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert outs[1][0].any()


# ----------------------------------- slice 11: the budgeted mesh engines

def _budget_steps(seed, n_steps=6, per_step=5000, num_keys=4000,
                  span=6000):
    """``tests/test_torch_mesh_spill.py``'s stream: ~2.5k live rows a shard
    against 1024, float32 values with NaN payloads and infinities."""
    rng = np.random.default_rng(seed)
    specials = np.array([0x7fa00001, 0x7fc00002, 0xffc00003, 0x7f800000,
                         0xff800000, 0x80000000], np.uint32).view(np.float32)
    steps = []
    for s in range(n_steps):
        keys = rng.integers(0, num_keys, per_step).astype(np.int64)
        vals = rng.random(per_step).astype(np.float32)
        sp = rng.random(per_step) < 0.02
        vals[sp] = rng.choice(specials, int(sp.sum()))
        ts = rng.integers(s * 1000, s * 1000 + span,
                          per_step).astype(np.int64)
        steps.append((keys, vals, ts, s * 1000))
    steps.append((np.array([0], np.int64), np.array([0.0], np.float32),
                  np.array([n_steps * 1000 + span + 5000], np.int64),
                  10 ** 9))
    return steps


def _batches_bytes_equal(got, want):
    assert len(got) == len(want) and want
    for g, w in zip(got, want):
        assert sorted(g.names()) == sorted(w.names())
        for name in w.names():
            a, b = np.asarray(g[name]), np.asarray(w[name])
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


@pytest.mark.cuda
@pytest.mark.parametrize("agg", ["sum", "count"])
def test_budgeted_mesh_window_engine_on_card_equals_cpu(agg):
    """``MeshWindowEngine`` under 1024 rows a shard: every fired batch
    (hybrid fires included), the spill counters and the snapshot equal
    the CPU run's, byte for byte; the rank kernel (and, for the float
    Sum, the ordered fold) launched."""
    _need_card()
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_windower import MeshWindowEngine
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes
    from flink_tpu_torch.stateplane.rank import rank
    from flink_tpu_torch.windowing.aggregates import (
        CountAggregate,
        SumAggregate,
    )
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows

    def engine(device):
        return MeshWindowEngine(
            SlidingEventTimeWindows.of(2000, 1000),
            SumAggregate("v") if agg == "sum" else CountAggregate(),
            make_mesh(8, device), capacity_per_shard=1 << 14,
            max_device_slots=1024)

    steps = _budget_steps(4)
    r0, f0 = rank.launches, ordered_fold_planes.launches
    card = engine("cuda")
    got = _feed(card, steps[:4])
    snap_card = card.snapshot()
    got += _feed(card, steps[4:])
    assert rank.launches > r0
    assert (ordered_fold_planes.launches > f0) == (agg == "sum")
    cpu = engine("cpu")
    want = _feed(cpu, steps[:4])
    snap_cpu = cpu.snapshot()
    want += _feed(cpu, steps[4:])
    _batches_bytes_equal(got, want)
    _snap_equal(snap_card, snap_cpu)
    assert card.spill_counters() == cpu.spill_counters()
    assert card.spill_counters()["rows_reloaded"] > 0
    assert card.hybrid_fires == cpu.hybrid_fires > 0


@pytest.mark.cuda
def test_namespace_layout_mesh_sessions_on_card_equal_cpu():
    _need_card()
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.sharded_sessions import MeshSessionEngine
    from flink_tpu_torch.windowing.aggregates import MaxAggregate

    rng = np.random.default_rng(23)
    steps = []
    for s in range(6):
        keys = rng.integers(0, 8000, 5000).astype(np.int64)
        vals = rng.standard_normal(5000).astype(np.float32)
        ts = rng.integers(s * 150, s * 150 + 400, 5000).astype(np.int64)
        steps.append((keys, vals, ts, s * 150 - 300))
    steps.append((np.array([1], np.int64), np.array([0.0], np.float32),
                  np.array([50_000], np.int64), 10 ** 9))
    runs = {}
    for device in ("cuda", "cpu"):
        eng = MeshSessionEngine(100, MaxAggregate("v"), make_mesh(8, device),
                                capacity_per_shard=1 << 14,
                                max_device_slots=1024,
                                spill_layout="namespaces")
        runs[device] = (_feed(eng, steps), eng)
    _batches_bytes_equal(runs["cuda"][0], runs["cpu"][0])
    c, p = runs["cuda"][1], runs["cpu"][1]
    assert c.spill_counters() == p.spill_counters()
    assert c.spill_counters()["rows_evicted"] > 0 and c.merge_groups > 0


@pytest.mark.cuda
def test_batch_mode_and_row1_on_card():
    """Queue C item 11's job in batch mode on the card (44.0, as on the
    CPU), and BASELINE row 1 at 20,000 lines (the oracle holds)."""
    _need_card()
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks import wordcount
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows

    rows = ([{"key": i % 2, "value": 1.0, "ts": 100 * i} for i in range(8)]
            + [{"key": 0, "value": 1.0, "ts": 5000}]
            + [{"key": 0, "value": 10.0, "ts": 150}] * 4)
    out = {}
    for device in ("cuda", "cpu"):
        env = StreamExecutionEnvironment(Configuration({
            "execution.micro-batch.size": 9, "execution.device": device,
            "execution.runtime-mode": "batch", "parallelism.default": 8}))
        sink = CollectSink()
        env.from_collection(rows, timestamp_field="ts",
                            watermark_strategy=WatermarkStrategy
                            .for_bounded_out_of_orderness(0)) \
            .key_by("key").window(TumblingEventTimeWindows.of(1000)) \
            .sum("value").sink_to(sink)
        env.execute("batch")
        out[device] = sink.rows()
    assert out["cuda"] == out["cpu"]
    assert [r["sum_value"] for r in out["cuda"]
            if r["key"] == 0 and r["window_start"] == 0] == [44.0]
    assert wordcount.run(20_000, "cuda")["oracle_ok"]


@pytest.mark.cuda
def test_device_value_state_put_is_last_wins_on_card():
    """200,000 lanes into 1,000 slots on the card: ``put_last_wins`` and
    ``DeviceValueState.put`` equal NumPy's ``a[s] = x`` bit for bit (the
    lane last in array order wins), repeated to catch a varying winner."""
    _need_card()
    from flink_tpu_torch.state.async_state import (
        DeviceValueStateDescriptor,
        put_last_wins,
    )
    from flink_tpu_torch.state.keyed_state import KeyedStateStore

    rng = np.random.default_rng(11)
    s = rng.integers(0, 1000, 200_000)
    x = rng.normal(size=200_000).astype(np.float32)
    want = np.zeros(1000, dtype=np.float32)
    want[s] = x
    for _ in range(5):
        t = torch.zeros(1000, dtype=torch.float32, device="cuda")
        put_last_wins(t, torch.from_numpy(s).cuda(),
                      torch.from_numpy(x).cuda())
        assert np.array_equal(t.cpu().numpy().view(np.uint32),
                              want.view(np.uint32))
    st = KeyedStateStore(64, device="cuda").get_state(
        DeviceValueStateDescriptor("v", np.float32, 0.0))
    keys = np.arange(1000) * 7
    st.get(keys)
    st.put(keys[s], x)
    assert st._dvals.is_cuda
    assert np.array_equal(st.get(keys).view(np.uint32), want.view(np.uint32))


@pytest.mark.cuda
def test_device_value_state_gather_and_grow_on_card():
    """The clamped gather at negative and too-large slots, growth of the
    index past its capacity, and async waves: card == CPU."""
    _need_card()
    from flink_tpu_torch.benchmarks import async_state as bench
    from flink_tpu_torch.state.async_state import (
        DeviceValueStateDescriptor,
        gather_clip,
    )
    from flink_tpu_torch.state.keyed_state import KeyedStateStore

    v = np.arange(10, dtype=np.float32) * 1.5
    s = np.array([-3, -1, 0, 4, 9, 10, 12, 1 << 20])
    got = gather_clip(torch.from_numpy(v).cuda(), torch.from_numpy(s).cuda())
    assert got.is_cuda and got.cpu().numpy().tolist() == \
        gather_clip(torch.from_numpy(v), torch.from_numpy(s)).numpy().tolist()
    out = {}
    for device in ("cuda", "cpu"):
        store = KeyedStateStore(8, device=device)
        st = store.get_state(DeviceValueStateDescriptor("v", np.int64, -1))
        keys = np.arange(5000)
        st.put(keys, keys * 3)
        out[device] = (st.get(keys), store.capacity, st.snapshot()["values"])
        assert st._dvals.device.type == device
    assert out["cuda"][1] == out["cpu"][1] == 8192
    for a, b in zip(out["cuda"], out["cpu"]):
        assert np.array_equal(a, b)
    card = bench.run("cuda", "async", rounds=50)
    cpu = bench.run("cpu", "async", rounds=50)
    assert card["digest"] == cpu["digest"]
    assert card["kernel_calls"] == cpu["kernel_calls"] == 100


@pytest.mark.cuda
def test_count_with_timeout_card_equals_cpu():
    """Phase 19(a)'s job at a cut size, sync and async: the card's rows
    equal the CPU's in emission order and the NumPy oracle's."""
    _need_card()
    from flink_tpu_torch.benchmarks import process_timeout as pt

    want = pt.oracle(20_000, 5_000, 512, 200)
    for use_async in (False, True):
        rows = {d: pt.run(d, 20_000, 5_000, 512, use_async=use_async,
                          rate=200)["rows"] for d in ("cuda", "cpu")}
        assert pt.rows_equal(rows["cuda"], want)
        assert pt.rows_equal(rows["cpu"], want)


def _signed_lanes(rng, n, cap, dtype):
    slots = rng.integers(1, cap, n).astype(np.int32)
    signs = np.where(rng.random(n) < 0.4, -1, 1)
    special = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0], dtype)
    vals = np.where(rng.random(n) < 0.05, special[rng.integers(0, 6, n)],
                    rng.standard_normal(n)).astype(dtype)
    return slots, vals * signs.astype(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_flat_scatter_signed_card_equals_cpu(dtype):
    """The retraction fold's float leaf goes through the ordered fold on
    the card (one launch a call) and its int leaf through scatter_add_:
    both equal the CPU bit for bit, specials and signed lanes included."""
    _need_card()
    from flink_tpu_torch.stateplane.families import flat_scatter_signed
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes
    from flink_tpu_torch.windowing.aggregates import AccLeaf

    leaves = (AccLeaf("s", dtype, "sum"), AccLeaf("n", np.int32, "sum"))
    rng = np.random.default_rng(14)
    for n, cap in [(1, 8), (5000, 64), (1 << 16, 1 << 17), (130_000, 48)]:
        slots, vals = _signed_lanes(rng, n, cap, dtype)
        counts = np.where(vals < 0, -1, 1).astype(np.int32)
        out = {}
        for device in ("cuda", "cpu"):
            accs = (torch.zeros(cap, dtype=torch.from_numpy(vals).dtype,
                                device=device),
                    torch.zeros(cap, dtype=torch.int32, device=device))
            before = ordered_fold_planes.launches
            got = flat_scatter_signed(leaves)(
                accs, torch.from_numpy(slots).to(device),
                (torch.from_numpy(vals).to(device),
                 torch.from_numpy(counts).to(device)))
            if device == "cuda":
                assert ordered_fold_planes.launches == before + 1
            out[device] = [g.cpu().numpy() for g in got]
        u = np.uint32 if dtype == np.float32 else np.uint64
        assert np.array_equal(out["cuda"][0].view(u), out["cpu"][0].view(u))
        assert np.array_equal(out["cuda"][1], out["cpu"][1])


@pytest.mark.cuda
def test_group_agg_changelog_card_equals_cpu():
    """GroupAggOperator over a changelog with retractions on the card:
    every emitted batch equals the CPU's in order, bit for bit."""
    _need_card()
    from flink_tpu_torch.core.records import RecordBatch
    from flink_tpu_torch.runtime.group_agg import GroupAggOperator
    from flink_tpu_torch.windowing.aggregates import (
        AvgAggregate,
        CountAggregate,
        MultiAggregate,
        SumAggregate,
    )

    class Ctx:
        parallelism, max_parallelism = 1, 128

    rng = np.random.default_rng(7)
    batches = []
    for b in range(6):
        n = 5000
        keys = rng.integers(0, 700, n).astype(np.int64)
        kinds = np.where(rng.random(n) < 0.3 * (b > 0), 1, 0).astype(np.int8)
        kinds[(kinds == 1) & (rng.random(n) < 0.5)] = 3
        batches.append(RecordBatch({
            "__key_id__": keys, "k": keys,
            "__ts__": np.full(n, b, np.int64),
            "v": rng.standard_normal(n).astype(np.float64),
            "__rowkind__": kinds}))
    out = {}
    for device in ("cuda", "cpu"):
        Ctx.device = device
        op = GroupAggOperator(MultiAggregate([
            SumAggregate("v", dtype=np.float64, output="s"),
            CountAggregate(output="n"), AvgAggregate("v", output="a")]), "k")
        op.open(Ctx())
        out[device] = [o for b in batches for o in op.process_batch(b)]
    assert len(out["cuda"]) == len(out["cpu"]) == 6
    for g, w in zip(out["cuda"], out["cpu"]):
        assert list(g.columns) == list(w.columns)
        for c in w.columns:
            assert g[c].dtype == w[c].dtype
            assert g[c].tobytes() == w[c].tobytes(), c


@pytest.mark.cuda
def test_sql_row4_and_two_level_card_equal_cpu():
    """Phase 20's SQL jobs at a cut size: row 4 over Kafka and the
    two-level GROUP BY, card == CPU bit for bit (the row-4 sums also
    equal the stream-order oracle)."""
    _need_card()
    import chip_smoke

    chip_smoke.row4_produce(200_000)
    card = chip_smoke.row4_job(torch, "cuda")[0]
    cpu = chip_smoke.row4_job(torch, "cpu")[0]
    chip_smoke._batches_equal("row 4", [card], [cpu])
    chip_smoke.row4_check(card, 200_000)
    for changelog in (False, True):
        got = [chip_smoke.two_level_job(torch, d, 200_000, 50_000,
                                        changelog=changelog)[0]
               for d in ("cuda", "cpu")]
        chip_smoke._batches_equal("two-level", [got[0]], [got[1]])


@pytest.mark.cuda
def test_over_engines_on_card_at_a_cut_size():
    """``chip_smoke.py`` 21(a) at a cut size: the device OVER engine on
    the card against the host engine (SUM/AVG within rtol 2e-4, atol 1e-5,
    the rest exactly), no degrade; row 4's stream through SQL OVER RANGE
    10 s against the float64 oracle."""
    _need_card()
    import chip_smoke

    rows = chip_smoke.over_bench(torch, "cuda", timed=4, host_timed_at_50k=1,
                                 key_counts=(100, 2_000))
    for r in rows.values():
        assert r["device"]["counters"]["over_degrades"] == 0
        assert r["device"]["launches_per_fire"] > 0
    sql = chip_smoke.row4_over_sql(torch, "cuda", events=300_000)
    assert sql["counters"]["over_device_fires"] > 0


@pytest.mark.cuda
def test_lookup_join_into_filesystem_exactly_once_on_card(tmp_path,
                                                          monkeypatch):
    """21(b) at a cut size (400k bids, batches of 1<<14, P=8): the crash
    after checkpoint 2 and the resumed run commit every (auction, window)
    once, every sum equal to the float32 oracle bit for bit, with the
    rank kernel and the ordered fold launched."""
    _need_card()
    import chip_smoke

    monkeypatch.chdir(tmp_path)
    row = chip_smoke.lookup_fs_exactly_once(torch, "cuda", bids=400_000,
                                            batch=1 << 14)
    assert row["launches"]["exchange_rank"] > 0
    assert row["launches"]["ordered_fold"] > 0


@pytest.mark.cuda
def test_slice21_d_on_card_at_a_cut_size():
    """21(d) at a cut size: ML_PREDICT with a TorchModel on the card
    against the CPU module (rtol 1e-5, atol 1e-5), host-heap == the card
    bit for bit on Q5-revenue at P=1, and a V2 keyed process job card ==
    CPU."""
    _need_card()
    import chip_smoke

    ml = chip_smoke.ml_predict_card(torch, "cuda", records=100_000)
    assert ml["launches"]["ordered_fold"] > 0
    chip_smoke.host_heap_revenue(torch, records=300_000)
    chip_smoke.v2_keyed_card(torch, "cuda", records=100_000)


@pytest.mark.cuda
def test_fold_drops_the_lanes_of_slot_zero():
    """Slot 0 is each plane's identity slot: the kernel drops its lanes,
    the plain version folds them. With values other than the identity
    there, the two agree bit for bit on every other slot and differ at
    slot 0 only, which the kernel leaves as it was. (Inputs for a
    card-against-CPU comparison therefore put the identity at slot 0.)"""
    _need_card()
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes

    rng = np.random.default_rng(21)
    t = torch.from_numpy(
        rng.integers(0, 5_000, size=(2, 50_000)).astype(np.int32))
    v = torch.from_numpy((rng.standard_normal((2, 50_000))
                          * np.exp(rng.uniform(-8, 8, (2, 50_000))))
                         .astype(np.float32))
    assert bool((t == 0).any())
    want = ordered_fold_planes(torch.zeros(2, 5_000), t, v, "sum")
    got = ordered_fold_planes(torch.zeros(2, 5_000, device="cuda"),
                              t.cuda(), v.cuda(), "sum").cpu()
    assert torch.equal(_bits(got[:, 1:]), _bits(want[:, 1:]))
    assert torch.equal(got[:, 0], torch.zeros(2))
    assert bool((want[:, 0] != 0).all())


@pytest.mark.cuda
def test_subtask_threads_fold_and_rank_equal_the_cpu():
    """Eight threads launch the ordered fold and the rank on one card at
    once, as the stage executor's keyed subtasks do (one default stream,
    one status buffer with an epoch per launch): every result equals its
    plain version on the CPU bit for bit, and every launch is counted."""
    _need_card()
    import threading

    from flink_tpu_torch.stateplane.fold import ordered_fold_planes
    from flink_tpu_torch.stateplane.rank import (
        exchange_rank_flat,
        exchange_rank_flat_plain,
        rank,
    )

    n_threads, rounds = 8, 20
    rng = np.random.default_rng(21)
    inputs = []
    for _ in range(n_threads):
        d = rng.integers(-1, 9, size=(8, 20_000)).astype(np.int32)
        t = rng.integers(0, 5_000, size=(2, 50_000)).astype(np.int32)
        v = (rng.standard_normal((2, 50_000))
             * np.exp(rng.uniform(-8, 8, (2, 50_000)))).astype(np.float32)
        v[t == 0] = 0.0  # slot 0's lanes carry the identity
        inputs.append((d, t, v))
    wants = [(exchange_rank_flat_plain(torch.from_numpy(d), 8, 4096),
              ordered_fold_planes(torch.zeros(2, 5_000),
                                  torch.from_numpy(t), torch.from_numpy(v),
                                  "sum"))
             for d, t, v in inputs]
    bad, errors = [], []
    r0, f0 = rank.launches, ordered_fold_planes.launches

    def subtask(i):
        try:
            d, t, v = (torch.from_numpy(a).cuda() for a in inputs[i])
            for _ in range(rounds):
                got_r = exchange_rank_flat(d, 8, 4096)
                got_f = ordered_fold_planes(
                    torch.zeros(2, 5_000, device="cuda"), t, v, "sum")
                if not torch.equal(got_r.cpu(), wants[i][0]) or \
                        not torch.equal(_bits(got_f.cpu()),
                                        _bits(wants[i][1])):
                    bad.append(i)
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=subtask, args=(i,))
               for i in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert not bad, bad
    assert rank.launches - r0 == n_threads * rounds
    assert ordered_fold_planes.launches - f0 == n_threads * rounds


@pytest.mark.cuda
@pytest.mark.parametrize("job", ["revenue", "q5-mesh"])
def test_stage_parallel_on_card_equals_cpu_run(job):
    """The stage executor's subtasks on the card: Q5-revenue at 4
    subtasks (float32 sums bit for bit, through the ordered fold) and Q5
    at 2 subtasks x 4 shards each (through the rank), equal to the same
    stage-parallel run on the CPU."""
    _need_card()
    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.benchmarks.nexmark import BidSource, build_q5
    from flink_tpu_torch.connectors.sinks import CollectSink
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.stateplane.fold import ordered_fold_planes
    from flink_tpu_torch.stateplane.rank import rank
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows

    def run(device):
        conf = {"execution.micro-batch.size": 1 << 14,
                "execution.device": device, "execution.local-agg": False}
        if job == "revenue":
            conf["execution.stage-parallelism"] = 4
        else:
            conf.update({"execution.stage-parallelism": 2,
                         "execution.stage-mesh-devices": 4})
        env = StreamExecutionEnvironment(Configuration(conf))
        sink = CollectSink()
        src = BidSource(total_records=150_000, num_auctions=3_000,
                        events_per_second_of_eventtime=100_000)
        if job == "revenue":
            (env.from_source(src,
                             WatermarkStrategy.for_bounded_out_of_orderness(0))
             .key_by("auction")
             .window(SlidingEventTimeWindows.of(10_000, 2_000))
             .sum("price").sink_to(sink))
        else:
            build_q5(env, src).sink_to(sink)
        env.execute()
        return sorted(tuple(sorted((k, np.asarray(v).tobytes())
                                   for k, v in r.items()))
                      for r in sink.rows())

    counter = ordered_fold_planes if job == "revenue" else rank
    before = counter.launches
    on_card = run("cuda")
    assert counter.launches > before
    assert on_card and on_card == run("cpu")
