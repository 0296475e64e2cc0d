"""CPU tests of the benchmark harness: the references on hand-computed
streams, the replay's cycle, finding files by name, a tiny cell through the
port end to end, and the controls at a size a test run holds.

    python -m pytest streambench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

from streambench import spec
from streambench.events import EventLog, Pool

SEED = 2**31 + 977  # more than 32 signed bits hold


class ListLog:
    """A log of explicit events, in one chunk or several."""

    def __init__(self, cols, ts, cuts=()):
        self.cols, self.ts = cols, np.asarray(ts, dtype=np.int64)
        self.count = len(self.ts)
        self.cuts = [0, *cuts, self.count]

    def chunks(self):
        for a, b in zip(self.cuts[:-1], self.cuts[1:]):
            yield a, {k: np.asarray(v)[a:b] for k, v in self.cols.items()}, \
                self.ts[a:b]

    def ts_of(self, g):
        return self.ts[g]


def _q5_cfg(top_k=2):
    return {"job_params": {"size_ms": 4, "slide_ms": 2, "top_k": top_k},
            "generator_params": {"events_per_s_of_event_time": 1000}}


def test_q5_reference_ties_and_top_k():
    q5 = spec.load_module("reference", "q5")
    #          ts: 0  0  1  2  3  4  5  5  5
    auctions = [1, 2, 2, 1, 3, 4, 5, 0, 3]
    ts = [0, 0, 1, 2, 3, 4, 5, 5, 5]
    log = ListLog({"auction": auctions}, ts, cuts=(4,))
    exp = q5.expected(log, _q5_cfg())
    # windows [e-4, e): e=2 {1,2,2}; e=4 {1,2,2,1,3}; e=6 {1,3,4,5,0,3};
    # e=8 {4,5,0,3}
    got = {e: (c, a.tolist()) for e, (c, a) in exp.windows.items()}
    assert got == {2: (2, [2]), 4: (2, [1, 2]), 6: (2, [3]),
                   8: (1, [0, 3, 4, 5])}
    rows = q5.as_results(exp)
    assert q5.compare(rows, exp, _q5_cfg())["failed"] == 0
    # a four-way tie at k=2: any two of the four pass, a fifth auction fails
    sel = rows["window_end"] == 8
    assert sorted(rows["auction"][sel].tolist()) == [0, 3]
    rows["auction"][np.flatnonzero(sel)[0]] = 5
    assert q5.compare(rows, exp, _q5_cfg())["failed"] == 0
    rows["auction"][np.flatnonzero(sel)[0]] = 1
    verdict = q5.compare(rows, exp, _q5_cfg())
    assert verdict["checks"] == [("wrong_windows", 1, 0)]
    # a window fired twice is wrong, and a window missing is wrong
    twice = {k: np.r_[v, v[-1:]] for k, v in q5.as_results(exp).items()}
    assert q5.compare(twice, exp, _q5_cfg())["failed"] == 1
    missing = {k: v[1:] for k, v in q5.as_results(exp).items()}
    assert q5.compare(missing, exp, _q5_cfg())["failed"] == 1


def test_q5_reference_equals_a_dense_count(monkeypatch):
    """The sparse pane counts, across chunks and blocks, and the dense
    fallback's np.unique path, against a plain dense count."""
    q5 = spec.load_module("reference", "q5")
    rng = np.random.default_rng(7)
    n = 5000
    auctions = np.r_[rng.integers(0, 40, n - 50),
                     rng.integers(0, 1 << 23, 50)]
    ts = np.sort(rng.integers(0, 300, n))
    cfg = {"job_params": {"size_ms": 30, "slide_ms": 10, "top_k": 16},
           "generator_params": {"events_per_s_of_event_time": 1000}}
    counts = Counter()
    for a, t in zip(auctions.tolist(), ts.tolist()):
        for last in range(t // 10, t // 10 + 3):   # the window's last pane
            counts[(last + 1) * 10, a] += 1
    want = {}
    for (end, a), c in sorted(counts.items()):
        best = want.get(end, (0, []))
        want[end] = ((c, [a]) if c > best[0]
                     else (c, best[1] + [a]) if c == best[0] else best)
    cells = len({(t // 10, a) for a, t in zip(auctions.tolist(),
                                              ts.tolist())})
    for block, bins in ((1 << 22, 1 << 26), (333, 1 << 26), (333, 64)):
        monkeypatch.setattr(q5, "BLOCK", block)
        monkeypatch.setattr(q5, "DENSE_BINS", bins)
        exp = q5.expected(ListLog({"auction": auctions}, ts,
                                  cuts=(1000, 2600)), cfg)
        assert {e: (c, a.tolist()) for e, (c, a) in exp.windows.items()
                } == want
        assert exp.cells == cells


def test_replay_shifts_event_time_at_the_cycle():
    gen = spec.load_module("gen", "nexmark_bids")
    params = dict(spec.load_json("configs", "nexmark_q5_p8")[
        "generator_params"], events_per_s_of_event_time=1000)
    pool = Pool(gen, SEED, params, 50)
    assert pool.span_ms == 50
    cols, ts = pool.take(45, 60)
    assert ts.tolist() == list(range(45, 60))
    assert cols["auction"].tolist() == (
        pool.cols["auction"][45:].tolist() + pool.cols["auction"][:10].tolist())
    whole = np.concatenate([t for _, _, t in EventLog(pool, 130).chunks()])
    assert whole.tolist() == list(range(130))
    with pytest.raises(ValueError):
        Pool(gen, SEED, dict(params, events_per_s_of_event_time=3000), 50)


def test_nexmark_bids_follow_the_generator_laws():
    """Each bid's auction is the hot one or in flight, its bidder the hot
    one or active, as the Nexmark generator draws them, at its default
    shares; the same seed gives the same bids."""
    gen = spec.load_module("gen", "nexmark_bids")
    params = spec.load_json("configs", "nexmark_q5_p8")["generator_params"]
    idx = np.arange(0, 2_000_000, 7, dtype=np.int64)
    cols, ts = gen.generate(idx, SEED, **params)
    epoch = idx // 46
    last = 3 * epoch + 2
    a = cols["auction"] - 1000
    hot = a == last // 100 * 100
    assert ((a >= np.maximum(last - 100, 0)) & (a <= last + 10) | hot).all()
    assert abs(hot.mean() - 0.5) < 0.01
    people = epoch + 1
    b = cols["bidder"] - 1000
    hot = b == (people - 1) // 100 * 100 + 1
    assert ((b >= people - np.minimum(people, 1000)) & (b < people + 10)
            | hot).all()
    assert abs(hot.mean() - 0.75) < 0.01
    assert cols["price"].min() >= 100 and cols["price"].max() <= 10**8
    np.testing.assert_array_equal(ts, idx * 1000 // 100_000)
    again, _ = gen.generate(idx, SEED, **params)
    other, _ = gen.generate(idx, SEED + 1, **params)
    np.testing.assert_array_equal(again["auction"], cols["auction"])
    assert (other["auction"] != cols["auction"]).mean() > 0.2


def test_every_cell_resolves_by_name():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        for kind in ("generator", "job", "reference"):
            folder = {"generator": "gen", "job": "jobs",
                      "reference": "reference"}[kind]
            spec.load_module(folder, cell.config[kind])
        for m in cell.per_layer:
            spec.load_module("metrics", m["name"])
        for m in cell.end_to_end:
            spec.load_module("end_to_end", m["name"])
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(spec.ROOT, c["file"]))


def test_a_new_file_is_taken_up_without_an_edit(tmp_path):
    root = tmp_path / "streambench"
    shutil.copytree(spec.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (root / "traffic" / "open_7k.json").write_text(
        json.dumps({"rate_events_per_s": 7000, "warm_seconds": 1}))
    (root / "metrics" / "events_seen.py").write_text(
        "def read(run):\n    return run.events\n")
    bench["workloads"].append(
        {"name": "q5_p8_open7k", "config": "nexmark_q5_p8",
         "traffic": "open_7k", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append(
        {"name": "events_seen", "unit": "events", "better": "higher",
         "source": "host_clock", "layer": "source", "moves": "setup_s"})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    cell = spec.load_cell("q5_p8_open7k", str(path), str(root))
    assert cell.traffic["rate_events_per_s"] == 7000
    assert "events_seen" in {m["name"] for m in cell.per_layer}
    reader = spec.load_module("metrics", "events_seen", str(root))
    assert reader.read(type("R", (), {"events": 5})) == 5
    # a metric without workloads goes to every cell reporting what it moves
    assert "events_seen" in {m["name"] for m in
                             spec.load_cell("q5_p8_sat", str(path),
                                            str(root)).per_layer}
    with pytest.raises(ValueError):
        spec.load_module("metrics", "../run", str(root))


def tiny(name: str, **traffic) -> spec.Cell:
    """``name`` at a size the CPU runs in seconds (a smaller pool and
    batches); the same job, generator and reference."""
    cell = spec.load_cell(name)
    c = copy.deepcopy(cell.config)
    c["pool_events"], c["warm_events"] = 400_000, 1 << 15
    c["settings"]["execution.micro-batch.size"] = 1 << 15
    cell.config = c
    if cell.traffic.get("rate_events_per_s"):
        cell.traffic = dict(cell.traffic, rate_events_per_s=100_000,
                            warm_seconds=0.3)
    cell.traffic.update(traffic)
    return cell


KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("name,trace", [("q5_p8_sat", False),
                                        ("q5_p8_sat", True),
                                        ("q5_p8_rate", False),
                                        ("q5_p8_rate", True)])
def test_a_tiny_cell_runs_correct_on_the_cpu(name, trace):
    from streambench import run

    cell = tiny(name)
    out = run.run(cell, SEED, 1.0, trace, device="cpu")
    assert KEYS <= set(out) and list(out)[-1] == "checks"
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    wanted = cell.per_layer if trace else cell.end_to_end
    # device-trace metrics have no reading on the CPU
    expect = {m["name"] for m in wanted if m["source"] != "device_trace"}
    assert set(out["metrics"]) == expect
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import json, sys\n"
        "from streambench import run\n"
        "from streambench.tests.test_streambench_harness import tiny, SEED\n"
        "out = run.run(tiny('q5_p8_sat'), SEED, 0.5, False, device='cpu')\n"
        "print(json.dumps([out['correct'], run.forbidden_modules()]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == [True, []]


def test_the_command_refuses_without_a_card():
    """Here (no CUDA) the command exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = subprocess.run(
        [sys.executable, "-m", "streambench.run", "--workload", "q5_p8_sat",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.parametrize("name,events", [("q5_p8_sat", 2_000_000)])
def test_the_control_fails(name, events):
    """The reference in the precision below the configuration's (bfloat16)
    put in the program's place fails a number compared, on the cell's own
    configuration."""
    cell = spec.load_cell(name)
    cfg = cell.config
    ref = spec.load_module("reference", cfg["reference"])
    pool = Pool(spec.load_module("gen", cfg["generator"]), SEED,
                cfg["generator_params"], 2_000_000)
    log = EventLog(pool, events)
    exp = ref.expected(log, cfg)
    assert ref.compare(ref.as_results(exp), exp, cfg)["failed"] == 0
    verdict = ref.compare(ref.as_results(ref.expected(log, cfg, control=True)),
                          exp, cfg)
    assert any(v > lim for _, v, lim in verdict["checks"])


def test_device_busy_and_idle_by_host_span():
    from types import SimpleNamespace

    from streambench.stats import union_s
    from streambench.trace import DeviceTrace, idle_by_host_span

    assert union_s([(0, 1), (0.5, 2), (3, 4), (5, 4.5)]) == 3.0
    iv = np.array([[1.0, 2.0], [1.5, 3.0], [6.0, 7.0]])
    dev = DeviceTrace(window=(0.0, 10.0), intervals=iv,
                      names=["k", "k", "Memcpy HtoD"], busy_s=union_s(iv))
    span = SimpleNamespace
    spans = [span(kind="op.process", t0=0.0, t1=5.0, instant=False),
             span(kind="fire.harvest", t0=3.5, t1=4.2, instant=False),
             span(kind="emit", t0=8.0, t1=8.0, instant=True)]
    idle = idle_by_host_span(dev, spans)
    # gaps [0, 1] and [3, 6] in op.process (their middles), [7, 10] in none
    assert idle == {"op.process": 4.0,
                    "no span (task loop, source wait)": 3.0}
    assert dev.window_s - dev.busy_s == sum(idle.values())
