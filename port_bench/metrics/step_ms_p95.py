"""95th percentile of the device time between the boundaries of
successive calls of the entry in the window (CUDA events on the stream);
on several cards each call takes the slowest rank's time."""

import statistics

UNIT = "ms"


def read(r):
    if len(r.call_ms) < 2:
        return None
    return statistics.quantiles(r.call_ms, n=100, method="inclusive")[94]
