"""What the per-layer metrics read of the program's own records: its spans
(``quant_gemm_tpu_torch/tracing.py``, recorded while the traced stretch's
profiler runs) and the Server's request times (``serve.Request``
``t_submit``, ``t_admit``, ``t_first``).

A program that lacks them, as one from before they existed, gives these
readers nothing to read: they return None, say why on standard error,
and raise nothing.
"""

from __future__ import annotations

import bisect
import statistics

from . import trace
from .harness import log

#: the part of the idle time under no span of the program
OUTSIDE = "outside the program's spans"


def idle_by_span(activities: list, spans: list, t0_ns: int,
                 t1_ns: int) -> dict:
    """The idle ns of [t0_ns, t1_ns] (no interval of ``activities``, as
    ``(start, end)`` pairs, running) by the innermost of ``spans``
    (``(start, end, name)``, nested) open at each instant; where none is
    open, under :data:`OUTSIDE`.  An idle stretch over several spans is
    split among them; the parts sum to the stretch's idle time."""
    line = trace.Timeline(spans)
    times, labels = line.times, line.labels
    out: dict = {}
    for lo, hi in trace.gaps_ns(activities, t0_ns, t1_ns):
        # times[i], the last edge at or before lo, opens the part of the
        # timeline that lo falls in (none before the first edge)
        i = bisect.bisect_right(times, lo) - 1
        at = lo
        while at < hi:
            label = labels[i] if i >= 0 else None
            end = min(times[i + 1], hi) if i + 1 < len(times) else hi
            if end > at:
                key = OUTSIDE if label is None else label
                out[key] = out.get(key, 0) + end - at
            at, i = end, i + 1
    return out


#: the last split read, by its stretch: the three idle readers share it
_last: list = [None, None]


def idle_split(run):
    """:func:`idle_by_span` of the run's traced stretch over the program's
    spans, as shares (%) of the stretch's wall time; None where the run
    has no stretch, the program records no spans, its buffer overflowed
    or holds none of the stretch."""
    st = run.trace
    if st is None or st.window_s <= 0:
        return None
    key = (id(st), st.t0_ns, st.t1_ns)
    if _last[0] == key:
        return _last[1]
    _last[:] = key, _read_split(st)
    return _last[1]


def _read_split(st):
    try:
        from quant_gemm_tpu_torch import tracing
    except ImportError:
        log("idle split: the program records no spans "
            "(no quant_gemm_tpu_torch.tracing)")
        return None
    if tracing.dropped():
        log(f"idle split: the span buffer overflowed ({tracing.dropped()} "
            "spans lost)")
        return None
    spans = [(s.start_ns, s.end_ns, s.name) for s in tracing.spans()
             if s.end_ns > st.t0_ns and s.start_ns < st.t1_ns]
    if not spans:
        log("idle split: no span of the program in the traced stretch")
        return None
    ns = idle_by_span([(a, b) for a, b, _, _ in st.activities], spans,
                      st.t0_ns, st.t1_ns)
    wall = st.t1_ns - st.t0_ns
    out = {k: 100.0 * v / wall for k, v in ns.items()}
    log(f"idle split (% of a {wall / 1e9:.3f} s stretch, {len(spans)} "
        f"spans): " + _shares(out) + f"; sum {sum(out.values()):.3f}")
    for label, part in _by_wrapper(st, spans).items():
        log(f"idle split under the benchmark's {label!r}: " + _shares(
            {k: 100.0 * v / wall for k, v in part.items()}))
    return out


def _shares(parts: dict) -> str:
    return ", ".join(f"{k} {v:.3f}" for k, v in
                     sorted(parts.items(), key=lambda kv: -kv[1]))


def _by_wrapper(st, spans: list) -> dict:
    """The stretch's idle ns by the benchmark's own span label
    (``trace.HOST_LABELS``) and, within each, by the program's innermost
    span: what each label of the breakdown's ``idle_gaps`` holds."""
    bench, prog = trace.Timeline(st.spans), trace.Timeline(spans)
    cuts = sorted(set(bench.times) | set(prog.times))
    out: dict = {}
    for lo, hi in trace.gaps_ns([(a, b) for a, b, _, _ in st.activities],
                                st.t0_ns, st.t1_ns):
        i = bisect.bisect_right(cuts, lo)
        at = lo
        while at < hi:
            end = min(cuts[i], hi) if i < len(cuts) else hi
            b = bench.at(at)
            part = out.setdefault(trace.HOST_LABELS.get(b, b), {})
            p = prog.at(at) or OUTSIDE
            part[p] = part.get(p, 0) + end - at
            at, i = end, i + 1
    return out


def idle_share(run, name: str):
    """The share (%) of the stretch idle under span ``name`` innermost."""
    split = idle_split(run)
    return None if split is None else split.get(name, 0.0)


def first_tokens(run):
    """The Server's records of the clients' requests whose first token
    came in the window outside the traced stretch; None where they carry
    no times (said on standard error)."""
    ends = run.steps_by_end
    out = []
    for r in run.requests.values():
        if r.client < 0 or not r.times or not run.in_window(r.times[0]):
            continue
        st = ends.get(r.times[0])
        if st is not None and not st.traced:
            out.append(r.req)
    if out and getattr(out[0], "t_admit", None) is None:
        log("request times: the program's requests carry none")
        return None
    return out


def p90_ms(run, since: str, until: str):
    """90th percentile, in ms, of ``until`` less ``since`` (request time
    fields, ns) over :func:`first_tokens`; None under 20 requests."""
    reqs = first_tokens(run)
    if reqs is None or len(reqs) < 20:
        return None
    ms = [(getattr(r, until) - getattr(r, since)) / 1e6 for r in reqs]
    return statistics.quantiles(ms, n=10, method="inclusive")[8]
