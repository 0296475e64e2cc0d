"""Async (coalesced) keyed state against per-op sync calls, on a
``DeviceValueState`` (the shape of ``tools/bench_async_state.py``).

Each of R rounds puts then gets G small disjoint key vectors. Sync mode
calls the state once per op (each get copies to the host); async mode
queues them into an ``AsyncExecutionController`` and drains once a round
(one scatter and one gather a round), then reads every future.

    python -m flink_tpu_torch.benchmarks.async_state [--device cpu]

prints one JSON line per mode: ops/s, kernel calls, and a digest of what
was read (equal across modes and devices).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from typing import Any, Dict

import numpy as np

from flink_tpu_torch.state.async_state import (
    AsyncExecutionController,
    DeviceValueStateDescriptor,
    make_async_view,
)
from flink_tpu_torch.state.keyed_state import KeyedStateStore


def run(device: str, mode: str = "sync", rounds: int = 2000,
        ops_per_round: int = 16, keys_per_op: int = 64,
        capacity: int = 1 << 16) -> Dict[str, Any]:
    store = KeyedStateStore(capacity, device=device)
    sync = store.get_state(DeviceValueStateDescriptor("v", np.float64, 0.0))
    aec = AsyncExecutionController()
    st = make_async_view(aec, sync)
    keysets = [np.arange(i * keys_per_op, (i + 1) * keys_per_op,
                         dtype=np.int64) for i in range(ops_per_round)]
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(rounds, keys_per_op))
    store.slots(np.concatenate(keysets))  # pre-insert: time access only
    digest = hashlib.sha256()
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(rounds):
        v = vals[r]
        if mode == "sync":
            for i, ks in enumerate(keysets):
                sync.put(ks, v + i)
            reads = [sync.get(ks) for ks in keysets]
        else:
            for i, ks in enumerate(keysets):
                st.put(ks, v + i)
            futs = [st.get(ks) for ks in keysets]
            aec.drain()
            reads = [f.value() for f in futs]
        digest.update(np.concatenate(reads).tobytes())
    dt = time.perf_counter() - t0
    n_ops = rounds * ops_per_round * 2
    return {"mode": mode, "device": device, "ops_per_s": n_ops / dt,
            "elapsed_s": dt,
            "kernel_calls": aec.stats["kernel_calls"] or n_ops,
            "digest": digest.hexdigest(),
            "final": sync.snapshot()["values"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=2000)
    a = ap.parse_args()
    for mode in ("sync", "async"):
        row = run(a.device, mode, a.rounds)
        row.pop("final")
        print(json.dumps(row))


if __name__ == "__main__":
    main()
