"""The port on a CUDA card: its kernels and the device paths against
their CPU runs. Every test is marked ``cuda`` and skips without a card
(decided inside the test). This file imports no JAX, so it also runs on a
GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the rank and Count are integers, bit-identical; Q5's rows are
counts, equal; the ordered fold, its grouping, the slice merge and the
float32 Sum job are compared on their raw bits against the CPU (NaN
payloads included).
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
