"""Operator ingest: host seconds inside the mesh window engine's
``prep.slots`` spans (one a shard: the native slot lookup or insert and
the dirty and replica marks) per million events handed out."""


def read(run):
    t = run.span_totals.get("prep.slots")
    if not t or not run.events:
        return None
    return t["total_s"] / (run.events / 1e6)
