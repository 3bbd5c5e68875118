"""The whole prefill's share (%) of the card's peak: the least time of
the prefill chunks admitted in the window (``work.prefill_chunk``, the
head over the one row whose logits are used) over the Server's prefill
seconds, both without the traced stretch."""

from port_bench import work


def read(run):
    t = run.untraced("prefill_seconds")
    b = sum(work.prefill_chunk(run.shapes, *c).bound_s()
            for s in run.steps if not s.traced
            for r in s.admitted for c in run.chunks(r))
    return 100.0 * b / t if t > 0 and b > 0 else None
