"""The 90th percentile of the requests' wall-clock, over every request of
the window (start to the host holding the answer)."""

import statistics


def read(run):
    times = [r["end"] - r["start"] for r in run.requests]
    if len(times) < 10:
        return None
    return statistics.quantiles(times, n=10)[8]
