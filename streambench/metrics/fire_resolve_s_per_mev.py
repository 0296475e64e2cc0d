"""Fire: host wall covered by the union of the ``fire.shard`` spans inside
the window, per million events. A span is one shard's host work on the fire
path: the slot lookup of a window's slices and its keys' slot matrix, or
the free of the slices that expired."""

from streambench.stats import union_s


def read(run):
    if run.spans is None or not run.events:
        return None
    w0, w1 = run.window
    iv = [(max(s.t0, w0), min(s.t1, w1)) for s in run.spans
          if s.kind == "fire.shard" and not s.instant]
    if not iv:
        return None
    return union_s(iv) / (run.events / 1e6)
