"""Prompt tokens prefilled in the window (those taken from a slot's cache
left out: ``Server.stats()`` ``prefill_tokens``) over the window's
seconds."""


def read(run):
    key = "prefill_tokens"
    return (run.stats_close[key] - run.stats_open[key]) / run.seconds
