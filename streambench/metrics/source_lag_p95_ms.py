"""Source: 95th percentile over the open-loop source's polls of the poll's
time minus the due time of the oldest event it returned."""

from streambench.stats import percentile


def read(run):
    if run.source.rate is None:
        return None
    p = percentile(run.source.lags, 95)
    return None if p is None else p * 1e3
