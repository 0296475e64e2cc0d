"""On-demand flame graphs by periodic thread sampling.

reference: flink-runtime/.../webmonitor/threadinfo/VertexFlameGraph.java +
rest/handler/job/JobVertexFlameGraphHandler.java — the Web UI requests a
flame graph for a vertex; the runtime samples the task threads' stacks for a
short window and folds them into a frame tree (the d3-flame-graph JSON
shape: {name, value, children}).

Re-design: task threads are named by role (``task-*``, ``source-subtask-*``,
``keyed-subtask-*``, ``jobmaster-*``), so a sample filters by thread-name
prefix instead of vertex ids; stacks come from ``sys._current_frames()``
(the CPython equivalent of ThreadMXBean.getThreadInfo).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, Optional


class _Node:
    __slots__ = ("name", "value", "children")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self.children: Dict[str, "_Node"] = {}

    def child(self, name: str) -> "_Node":
        node = self.children.get(name)
        if node is None:
            node = self.children[name] = _Node(name)
        return node

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "value": self.value,
            "children": [c.to_dict()
                         for c in sorted(self.children.values(),
                                         key=lambda n: -n.value)],
        }


def sample_flame_graph(duration_ms: int = 200, interval_ms: int = 10,
                       thread_name_prefixes: Optional[List[str]] = None
                       ) -> dict:
    """Sample all (or prefix-matching) threads' stacks for ``duration_ms``
    and fold them into a frame tree. Returns the d3-flame-graph JSON shape
    with an ``endTimestamp``/``samples`` header like the reference's
    VertexFlameGraph."""
    root = _Node("root")
    samples = 0
    deadline = time.monotonic() + duration_ms / 1000.0
    me = threading.get_ident()
    while True:
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            name = names.get(ident, str(ident))
            if thread_name_prefixes is not None and not any(
                    name.startswith(p) for p in thread_name_prefixes):
                continue
            # unwind to root, then fold top-down
            stack = []
            f = frame
            while f is not None:
                code = f.f_code
                stack.append(f"{code.co_name} "
                             f"({code.co_filename.rsplit('/', 1)[-1]}:"
                             f"{f.f_lineno})")
                f = f.f_back
            node = root.child(name)
            node.value += 1
            for entry in reversed(stack):
                node = node.child(entry)
                node.value += 1
            samples += 1
            # one unit per thread-sample at every level, so a parent's
            # value always >= the sum of its children (d3 invariant)
            root.value += 1
        if time.monotonic() >= deadline:
            break
        time.sleep(interval_ms / 1000.0)
    return {
        "endTimestamp": int(time.time() * 1000),
        "samples": samples,
        "root": root.to_dict(),
    }


#: thread-name prefixes of the task/data-plane threads (the reference
#: samples the vertex's task threads, not the control plane)
TASK_THREAD_PREFIXES = [
    "task-", "source-subtask-", "keyed-subtask-", "source-pump-",
    "async-wait",
]
