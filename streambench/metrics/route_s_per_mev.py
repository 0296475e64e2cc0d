"""Operator ingest: host seconds inside the mesh window engine's
``prep.route`` spans (slice assignment, the live mask, the key-group route
and the records grouped by shard) per million events handed out."""


def read(run):
    t = run.span_totals.get("prep.route")
    if not t or not run.events:
        return None
    return t["total_s"] / (run.events / 1e6)
