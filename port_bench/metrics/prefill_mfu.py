"""The whole prefill's share (%) of the card's peak: the least time of
the prefill chunks admitted in the window (the architecture's
``prefill_chunk``, the head over the one row whose logits are used) over
the Server's prefill seconds, both without the traced stretch."""


def read(run):
    t = run.untraced("prefill_seconds")
    b = sum(run.shapes.prefill_chunk(*c).bound_s()
            for s in run.steps if not s.traced
            for r in s.admitted for c in run.chunks(r))
    return 100.0 * b / t if t > 0 and b > 0 else None
