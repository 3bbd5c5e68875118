"""90th percentile, in ms, of a request's wait in the Server's queue:
``submit`` to its slot being picked (``serve.Request`` ``t_admit`` less
``t_submit``), over the clients' requests whose first token came in the
window outside the traced stretch; none under 20."""

from port_bench import spans


def read(run):
    return spans.p90_ms(run, "t_submit", "t_admit")
