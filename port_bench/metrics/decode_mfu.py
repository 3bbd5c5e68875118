"""The whole decode step's share (%) of the card's peak: the least time
of the window's decode steps (the architecture's ``decode_step``; llama's
counts weights at llama.cpp block bytes, each slot's cache, W4A8
operations at the int8 peak and attention at the bf16 peak, whichever of
bytes and operations binds) over the Server's decode seconds, both
without the traced stretch."""


def read(run):
    t = run.untraced("decode_seconds")
    b = sum(run.shapes.decode_step(s.contexts).bound_s()
            for s in run.steps if s.contexts and not s.traced)
    return 100.0 * b / t if t > 0 and b > 0 else None
