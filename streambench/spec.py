"""Finding a cell's files by name.

A cell is one entry of ``workloads`` in the repository's ``BENCHMARK.json``.
Everything that belongs to one configuration, one traffic mix or one metric
sits in a file of its own under this folder and is found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the deployment (job, settings, generator, reference);
- ``traffic/<traffic>.json``: how the source offers the events;
- ``gen/<generator>.py``, ``jobs/<job>.py``, ``reference/<reference>.py``;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

Adding a cell, a traffic mix, a configuration or a per-layer metric adds
files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from dataclasses import dataclass
from types import ModuleType
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")


def check_name(name: str) -> str:
    """A name as the benchmark's contract allows it: it becomes a file name."""
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"not a valid benchmark name: {name!r}")
    return name


def load_json(kind: str, name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, kind, check_name(name) + ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: str = HERE) -> ModuleType:
    """``<root>/<kind>/<name>.py`` as a module, imported by its path."""
    path = os.path.join(root, kind, check_name(name) + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"streambench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str, reported=None) -> bool:
    """A metric with ``workloads`` is reported in those cells; a per-layer
    metric without it in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(name: str, benchmark: str = os.path.join(ROOT, "BENCHMARK.json"),
              root: str = HERE) -> Cell:
    """The cell ``name`` of ``benchmark``: its configuration and traffic
    files, and the end-to-end and per-layer metrics that it reports."""
    with open(benchmark) as f:
        bench = json.load(f)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no workload {name!r} in {benchmark}")
    w = entries[0]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json("configs", w["config"], root),
                traffic=load_json("traffic", w["traffic"], root),
                end_to_end=e2e, per_layer=per_layer)

