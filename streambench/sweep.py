"""Find the knee of an open-loop cell: its configuration at a list of
offered rates, one short window each, in one process on the card.

    python3 -m streambench.sweep --workload q5_p8_rate --seed <n>
        --seconds 20 --rates 1000000 2000000 3000000

Prints one JSON line a rate: events handed out against those offered, the
source lag (poll time minus the oldest returned event's due time) over the
first and the last quarter of the polls, and the end-to-end metrics. At a
sustained rate the lag stays flat and every offered event is handed out; past
the knee the lag grows through the window. A cell's rate is fixed once from
such a sweep; the benchmark's runs never search for one.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from streambench import run, spec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    for rate in args.rates:
        cell.traffic = dict(cell.traffic, rate_events_per_s=rate)
        views = []
        out = run.run(cell, args.seed, args.seconds, False, views=views)
        v = views[0]
        lags = np.asarray(v.source.lags) * 1e3
        q = max(len(lags) // 4, 1)
        print(json.dumps({
            "rate": rate, "correct": out["correct"],
            "handed": v.events, "offered": rate * args.seconds,
            "polls": len(lags),
            "lag_ms_first_quarter_p50": float(np.median(lags[:q])),
            "lag_ms_last_quarter_p50": float(np.median(lags[-q:])),
            "lag_ms_max": float(lags.max()),
            "metrics": {k: m["value"] for k, m in out["metrics"].items()},
        }), flush=True)


if __name__ == "__main__":
    main()
