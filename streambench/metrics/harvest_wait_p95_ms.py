"""Fire: 95th percentile of the time a dispatched window fire waited for
its harvest, from its dispatch to the start of its harvest (the
``fire.pending`` wait records that ended in the window), in ms."""

from streambench.stats import percentile


def read(run):
    if run.spans is None:
        return None
    w0, w1 = run.window
    d = [s.t1 - s.t0 for s in run.spans
         if s.kind == "fire.pending" and w0 <= s.t1 <= w1]
    p = percentile(d, 95)
    return None if p is None else p * 1e3
