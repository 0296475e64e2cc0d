"""Executor loop: 95th percentile of the time a source batch waited in the
pump's queue, from the pump's put to the task loop's take (the
``source.queue`` wait records that ended in the window), in ms."""

from streambench.stats import percentile


def read(run):
    if run.spans is None:
        return None
    w0, w1 = run.window
    d = [s.t1 - s.t0 for s in run.spans
         if s.kind == "source.queue" and w0 <= s.t1 <= w1]
    p = percentile(d, 95)
    return None if p is None else p * 1e3
