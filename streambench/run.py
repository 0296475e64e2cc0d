"""Run one cell of the benchmark of ``flink_tpu_torch`` on this machine.

    python3 -m streambench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. Set-up (``setup_s``) runs from process start
to the window's first poll: the port's imports and library builds, the event
pool made from the seed, one short warm job of the cell's own configuration
and traffic, and the measured job's own set-up. The window is one job
through ``StreamExecutionEnvironment.execute``, from the source's first poll
until ``execute`` returns, its final flush included. Once it has closed and
the program's state is freed, the cell's plain reference recomputes every
result from the events the source handed out, and the run is ``correct``
when every number compared lies within its limit.

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics;
with ``--trace 1`` the run is traced (``torch.profiler`` and the port's
flight recorder) and they are its per-layer metrics. The last line of
standard output is one JSON object; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Any, Dict, Optional, Tuple  # noqa: E402

from streambench import spec  # noqa: E402

#: modules the run may not hold once its window has closed (top-level
#: names, compared whole: the port's name begins with the last one's)
FORBIDDEN = ("jax", "jaxlib", "flax", "flink_tpu")

#: the port builds its libraries into ``flink_tpu_torch/csrc/build/`` and
#: ``flink_tpu_torch/native/build/``, inside the checkout and ignored by
#: git, so only a cell's first run in a checkout builds them

#: flight-recorder ring per thread in a traced run (records, log2), so
#: that a window's spans all stay in it
TRACE_RING_POW2 = "21"


@dataclass
class Run:
    """What a run leaves for the metric readers."""

    cell: spec.Cell
    events: int
    window: Tuple[float, float]
    setup_s: float
    source: Any
    rows: Dict[str, Any]
    log: Any
    reference: Any
    expected: Any
    span_totals: Dict[str, Dict[str, float]]
    spans: Optional[list]
    device: Any
    job_metrics: Dict[str, Any]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _host_usage() -> Dict[str, float]:
    """The process's CPU seconds, context switches and garbage
    collections so far: what the host gave the job and took from it."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": r.ru_utime + r.ru_stime,
            "voluntary": float(r.ru_nvcsw),
            "involuntary": float(r.ru_nivcsw),
            "gc": float(sum(g["collections"] for g in gc.get_stats()))}


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float = T_START,
        root: str = spec.HERE, views: Optional[list] = None) -> dict:
    """One run of ``cell``; returns the result's JSON object (and appends
    what the readers saw to ``views``, where given)."""
    import torch

    from flink_tpu_torch import Configuration, StreamExecutionEnvironment
    from flink_tpu_torch.observe import flight_recorder as flight

    from streambench.events import EventLog, Pool
    from streambench.source import RecordingSink, ReplaySource
    from streambench.trace import MARK, idle_by_host_span, read_profile, top

    t_imported = time.perf_counter()
    cfg, traffic = cell.config, cell.traffic
    gen = spec.load_module("gen", cfg["generator"], root)
    job = spec.load_module("jobs", cfg["job"], root)
    ref = spec.load_module("reference", cfg["reference"], root)
    pool = Pool(gen, seed, cfg["generator_params"], cfg["pool_events"])
    rate = traffic.get("rate_events_per_s")
    settings = {**cfg["settings"], "execution.device": device}

    def execute(source, sink, name):
        env = StreamExecutionEnvironment(Configuration(settings))
        job.build(env, source, cfg["job_params"]).sink_to(sink)
        return env.execute(name)

    t_pool = time.perf_counter()
    warm = (ReplaySource(pool, traffic["warm_seconds"], rate) if rate
            else ReplaySource(pool, float("inf"),
                              max_events=cfg["warm_events"]))
    execute(warm, RecordingSink(job.RESULT_COLUMNS), cell.name + "-warm")
    _sync(device)
    del warm
    gc.collect()
    flight.recorder().clear()
    t_warm = time.perf_counter()

    src = ReplaySource(pool, seconds, rate)
    sink = RecordingSink(job.RESULT_COLUMNS)
    host0 = _host_usage()
    with contextlib.ExitStack() as stack:
        prof = mark = None
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU]
            if device.startswith("cuda"):
                acts.append(ProfilerActivity.CUDA)
            prof = stack.enter_context(profile(activities=acts))
            mark = time.perf_counter()
            with record_function(MARK):
                pass
        result = execute(src, sink, cell.name)
        _sync(device)
        t_end = time.perf_counter()
    host = {k: v - host0[k] for k, v in _host_usage().items()}
    window = (src.first, t_end)
    peak = (torch.cuda.max_memory_allocated()
            if device.startswith("cuda") else 0)
    t_read = time.perf_counter()
    recorder = flight.recorder()
    span_totals = recorder.kind_totals()
    spans = dropped = None
    if trace:
        spans, dropped = recorder.snapshot(), recorder.dropped()
        if dropped:
            print(f"flight recorder dropped {dropped} records: spans "
                  "incomplete, span unions not read", file=sys.stderr)
            spans = None
    dev = (read_profile(prof, mark, window)
           if trace and device.startswith("cuda") else None)
    job_metrics = dict(result.metrics)
    del result, prof
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    log = EventLog(pool, src.handed)
    expected = ref.expected(log, cfg)
    rows = sink.rows()
    verdict = ref.compare(rows, expected, cfg)
    timing = (f"seconds: set-up {src.first - t_start:.1f} (imports "
              f"{t_imported - t_start:.1f}, pool {t_pool - t_imported:.1f}, "
              f"warm job {t_warm - t_pool:.1f}, the job's own "
              f"{src.first - t_warm:.1f}), window "
              f"{t_end - src.first:.1f}, trace read {t_ref - t_read:.1f}, "
              f"reference {time.perf_counter() - t_ref:.1f}")
    load = (os.getloadavg()[0] if hasattr(os, "getloadavg") else -1.0)
    host_note = (f"host in the job: cpu {host['cpu_s']:.1f} s, context "
                 f"switches {host['voluntary']:.0f} voluntary and "
                 f"{host['involuntary']:.0f} involuntary, gc collections "
                 f"{host['gc']:.0f}, {os.cpu_count()} cpus, load "
                 f"{load:.2f}")
    view = Run(cell=cell, events=src.handed, window=window,
               setup_s=src.first - t_start, source=src, rows=rows, log=log,
               reference=ref, expected=expected, span_totals=span_totals,
               spans=spans, device=dev, job_metrics=job_metrics)
    if views is not None:
        views.append(view)
    metrics = {}
    kind = "metrics" if trace else "end_to_end"
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.load_module(kind, m["name"], root).read(view)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = verdict["checks"]
    out = {
        "correct": all(v <= lim for _, v, lim in checks),
        "attempted": int(verdict["attempted"]),
        "failed": int(verdict["failed"]),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.startswith("cuda") else "cpu",
            "kind": (torch.cuda.get_device_name(0)
                     if device.startswith("cuda") else "cpu"),
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if dev is not None:
        out["device"].update(busy_s=dev.busy_s, window_s=dev.window_s)
        out["breakdown"] = {
            "device_ops": top(dev.by_name),
            "idle_gaps": top(idle_by_host_span(dev, spans or [])),
        }
    out["notes"] = [*verdict.get("notes", []), timing, host_note]
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if args.trace:
        # read when the port is imported
        os.environ["FLINK_TPU_FLIGHT_RECORDER_CAPACITY_POW2"] = \
            TRACE_RING_POW2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print("the run loaded " + ", ".join(loaded), file=sys.stderr)
        return 3
    for note in out.pop("notes"):
        print(note, file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
