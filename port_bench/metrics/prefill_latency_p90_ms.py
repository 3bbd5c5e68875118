"""90th percentile, in ms, of a request's admission: its slot picked to
its first token sampled (``serve.Request`` ``t_first`` less ``t_admit``:
the staging copies, the prefill chunks and the first sample), over the
clients' requests whose first token came in the window outside the
traced stretch; none under 20."""

from port_bench import spans


def read(run):
    return spans.p90_ms(run, "t_admit", "t_first")
