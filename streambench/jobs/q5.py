"""NEXmark Q5, "hot items", through the port's public DataStream API:
HOP(size, slide) COUNT per auction, the device top-k over each fired
window, then the arg-max rows of each window."""

from __future__ import annotations

import numpy as np

RESULT_COLUMNS = ("window_end", "auction", "count")


def _argmax_per_window(batch):
    ends, counts = batch["window_end"], batch["count"]
    if len(ends) == 0 or ends.min() == ends.max():
        return batch.filter(counts == counts.max())
    # a fired batch that holds several windows: the arg-max of each
    order = np.lexsort((counts, ends))
    e, c = ends[order], counts[order]
    last = np.r_[e[1:] != e[:-1], True]
    best = np.repeat(c[last], np.diff(np.r_[0, np.flatnonzero(last) + 1]))
    keep = np.zeros(len(ends), dtype=bool)
    keep[order[c == best]] = True
    return batch.filter(keep)


def build(env, source, p: dict):
    from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
    from flink_tpu_torch.windowing.aggregates import CountAggregate
    from flink_tpu_torch.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.windowing.fire_projectors import TopKFireProjector

    return (
        env.from_source(source, WatermarkStrategy.for_bounded_out_of_orderness(
            p["out_of_orderness_ms"]))
        .key_by("auction")
        .window(SlidingEventTimeWindows.of(p["size_ms"], p["slide_ms"]))
        .aggregate(CountAggregate(),
                   fire_projector=TopKFireProjector("count", k=p["top_k"]))
        .map(_argmax_per_window, name="hot_items_argmax"))
