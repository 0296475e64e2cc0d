"""Fire: the median of the program's own fire latency, watermark advance to
the result on the host (``result.metrics["window_fire_latency_ms"]``, a
bounded record of the latest fires)."""


def read(run):
    lat = run.job_metrics.get("window_fire_latency_ms") or {}
    return lat.get("p50") if lat.get("count") else None
