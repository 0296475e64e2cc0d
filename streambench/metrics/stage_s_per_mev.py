"""Operator ingest: host seconds inside the ``prep.stage`` spans (the
staging of the flat padded columns for the device exchange) per million
events handed out."""


def read(run):
    t = run.span_totals.get("prep.stage")
    if not t or not run.events:
        return None
    return t["total_s"] / (run.events / 1e6)
