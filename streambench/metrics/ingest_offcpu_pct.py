"""Operator ingest: the share of the wall inside the window's
``batch.ingest`` spans in which their thread was not running (waiting for
the GIL, a lock or the device, or descheduled), in %:
100 x (1 - their thread CPU seconds / their wall seconds), over the spans
whose thread CPU clock was read."""

_ABSENT = object()


def read(run):
    if run.spans is None:
        return None
    w0, w1 = run.window
    wall = cpu = 0.0
    for s in run.spans:
        if s.kind != "batch.ingest" or s.instant or s.t1 < w0 or s.t0 > w1:
            continue
        c = getattr(s, "cpu_s", _ABSENT)
        if c is _ABSENT:
            return None
        if c is None:
            continue
        wall += s.t1 - s.t0
        cpu += c
    if wall <= 0:
        return None
    return 100.0 * (1.0 - cpu / wall)
