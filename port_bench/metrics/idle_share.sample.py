"""Share (%) of the traced stretch's wall time in which no device
activity ran while the innermost open span of the program was
``serve.sample`` (the sampler and its read-back, in decode steps and for
first tokens); each idle stretch split instant by instant among the spans
over it."""

from port_bench import spans


def read(run):
    return spans.idle_share(run, "serve.sample")
