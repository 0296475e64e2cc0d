"""Reading a traced run: the device's activity from the ``torch.profiler``
trace, and what the host was doing while the device idled, from the port's
flight-recorder spans.

The device arithmetic (activity of device type CUDA, user annotations left
out, busy time as the union of the intervals) follows ``device_summary`` in
``flink_tpu_torch/benchmarks/q5_profile.py``; the benchmark keeps its own.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from streambench.stats import union, union_s

MARK = "streambench.mark"

_COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


@dataclass
class DeviceTrace:
    """Device activity inside the window, on the host clock."""

    window: Tuple[float, float]
    intervals: np.ndarray               # [n, 2] start, end (s), clipped
    names: List[str]
    busy_s: float = 0.0                 # union of every interval
    kernel_s: float = 0.0               # sum over kernels (copies out)
    by_name: Dict[str, float] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def read_profile(prof, mark_time: float, window: Tuple[float, float]
                 ) -> DeviceTrace:
    """Device activity of ``prof`` inside ``window`` (host clock, s).
    ``mark_time`` is the host clock at the start of the ``MARK`` range,
    which puts the trace's clock onto the host's. Reads the profiler's raw
    events: building its event tree takes minutes on a long window."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    mark_ns = None
    rows, names = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            if mark_ns is None and ev.name() == MARK:
                mark_ns = ev.start_ns()
            continue
        if getattr(ev, "is_user_annotation", lambda: False)():
            continue
        rows.append((ev.start_ns(), ev.duration_ns()))
        names.append(ev.name())
    if mark_ns is None:
        raise RuntimeError(f"the trace holds no {MARK!r} range")
    ns = np.array(rows, dtype=np.int64).reshape(-1, 2)
    start = (ns[:, 0] - mark_ns) / 1e9 + mark_time
    iv = np.stack([start, start + ns[:, 1] / 1e9], axis=1)
    w0, w1 = window
    keep = (iv[:, 1] > w0) & (iv[:, 0] < w1)
    iv = np.clip(iv[keep], w0, w1)
    names = [n for n, k in zip(names, keep) if k]
    by_name: Dict[str, float] = defaultdict(float)
    kernel_s = 0.0
    for (a, b), n in zip(iv, names):
        by_name[n[:160]] += b - a
        if not n.startswith(_COPY_PREFIXES):
            kernel_s += b - a
    return DeviceTrace(window=window, intervals=iv, names=names,
                       busy_s=union_s(iv),
                       kernel_s=kernel_s, by_name=dict(by_name))


def idle_by_host_span(dev: DeviceTrace, spans) -> Dict[str, float]:
    """The device's idle time in the window, split by the innermost
    flight-recorder span the host was in at the middle of each gap."""
    u = union(dev.intervals)
    w0, w1 = dev.window
    edges = np.r_[w0, u.ravel(), w1].reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    out: Dict[str, float] = defaultdict(float)
    spans = sorted((s for s in spans if not s.instant), key=lambda s: s.t0)
    t0 = np.array([s.t0 for s in spans])
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label = "no span (task loop, source wait)"
        i = int(np.searchsorted(t0, mid, side="right")) - 1
        for j in range(i, max(i - 64, -1), -1):
            if spans[j].t1 >= mid:
                label = spans[j].kind
                break
        out[label] += float(b - a)
    return dict(out)


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
