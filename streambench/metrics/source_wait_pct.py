"""Executor loop: the share of the window the task loop spent blocked on
the source pump's queue (the union of its ``source.wait`` spans), in %."""

from streambench.stats import union_s


def read(run):
    if run.spans is None or run.window_s <= 0:
        return None
    w0, w1 = run.window
    iv = [(max(s.t0, w0), min(s.t1, w1)) for s in run.spans
          if s.kind == "source.wait" and not s.instant]
    if not iv:
        return None
    return 100.0 * union_s(iv) / run.window_s
