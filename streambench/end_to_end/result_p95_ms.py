"""95th percentile over every result that reached the sink: its arrival
minus the time at which the last event that counts in it was due at the
open-loop source. Queue wait and source lag count; window length does not.
Open-loop cells only."""

from streambench.stats import percentile


def read(run):
    if run.source.rate is None:
        return None
    arrival, g_last = run.reference.last_events(
        run.rows, run.expected, run.log, run.cell.config)
    lat = arrival - run.source.due(g_last)
    p = percentile(lat, 95)
    return None if p is None else p * 1e3
