"""90th percentile, in ms, of the time from ``submit`` to the first
token, over every request whose first token came in the window (a
token's time is when the ``step`` call that produced it returned)."""

import statistics


def read(run):
    ttft = [r.times[0] - r.submitted for r in run.requests.values()
            if r.client >= 0 and r.times and run.in_window(r.times[0])]
    if len(ttft) < 20:
        return None
    return statistics.quantiles(ttft, n=10, method="inclusive")[8] * 1e3
