"""Operator ingest: host seconds inside the executor's ``op.process`` spans
(``cluster/local_executor.py``) per million events handed out."""


def read(run):
    t = run.span_totals.get("op.process")
    if not t or not run.events:
        return None
    return t["total_s"] / (run.events / 1e6)
