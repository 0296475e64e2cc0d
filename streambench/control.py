"""The control of a cell: its reference computed in the precision below the
configuration's (bfloat16), put in the program's place and judged by the
same comparison, over as many events as a run of the cell hands out.

    python3 -m streambench.control --workload <cell> --events <n>
        --seeds <s> [<s> ...]

Prints one JSON line a seed with each number compared and its limit. The
benchmark's runs never run it; it shows that the comparison fails a
lower precision, and gives the upper readings the limits lie under.
"""

from __future__ import annotations

import argparse
import json
import time

from streambench import spec
from streambench.events import EventLog, Pool


def control(cell: spec.Cell, seed: int, events: int) -> dict:
    cfg = cell.config
    ref = spec.load_module("reference", cfg["reference"])
    pool = Pool(spec.load_module("gen", cfg["generator"]), seed,
                cfg["generator_params"], cfg["pool_events"])
    log = EventLog(pool, events)
    t0 = time.perf_counter()
    exp = ref.expected(log, cfg)
    t1 = time.perf_counter()
    verdict = ref.compare(ref.as_results(ref.expected(log, cfg, True)),
                          exp, cfg)
    return {"workload": cell.name, "seed": seed, "events": events,
            "reference_s": t1 - t0,
            "checks": {n: {"value": v, "limit": lim}
                       for n, v, lim in verdict["checks"]},
            "attempted": verdict["attempted"], "failed": verdict["failed"]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--events", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(control(cell, seed, args.events)), flush=True)


if __name__ == "__main__":
    main()
