"""Share (%) of the Server's host seconds in prefill (admission, first
token included) against prefill and decode steps together, over the
window less the traced stretch (``Server.stats()``)."""


def read(run):
    p = run.untraced("prefill_seconds")
    d = run.untraced("decode_seconds")
    return 100.0 * p / (p + d) if p + d > 0 else None
