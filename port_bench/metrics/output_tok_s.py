"""Tokens generated in the window, first tokens included, over the
window's seconds."""


def read(run):
    n = sum(1 for r in run.requests.values() if r.client >= 0
            for t in r.times if run.in_window(t))
    return n / run.seconds
