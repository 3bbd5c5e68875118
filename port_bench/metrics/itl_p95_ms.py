"""95th percentile, in ms, of the gaps between consecutive tokens of a
request, over every gap whose later token came in the window."""

import statistics


def read(run):
    gaps = [b - a for r in run.requests.values() if r.client >= 0
            for a, b in zip(r.times, r.times[1:]) if run.in_window(b)]
    if len(gaps) < 200:
        return None
    return statistics.quantiles(gaps, n=100, method="inclusive")[94] * 1e3
