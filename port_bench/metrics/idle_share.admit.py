"""Share (%) of the traced stretch's wall time in which no device
activity ran while the innermost open span of the program was
``serve.admit``: admission outside its chunks and its first sample (the
slot pick, the staging cache's copies, the slot's bookkeeping); each idle
stretch split instant by instant among the spans over it."""

from port_bench import spans


def read(run):
    return spans.idle_share(run, "serve.admit")
