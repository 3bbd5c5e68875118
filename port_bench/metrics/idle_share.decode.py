"""Share (%) of the traced stretch's wall time in which no device
activity ran: the union of every kernel, copy and set's interval over
the whole stretch, between replays as well as within them."""


def read(run):
    st = run.trace
    if st is None or st.window_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s() / st.window_s)
