"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a
few seconds of the steady window, read without exporting a trace file.

Spans (``torch.profiler.record_function``) come from the benchmark's own
code: ``port_bench.step`` around each ``Server.step`` call,
``port_bench.client`` around the clients' work after it, and, while the
stretch runs, ``port_bench.<kind>`` around each ``serve.Graphs.run`` (the
kind is the first field of the step's graph key: ``decode`` or
``chunk``) and ``port_bench.sample`` around ``models.sampling.sample``.
Each device activity is attributed to the innermost span that was open
when the host launched it (through the profiler's link from the activity
to the host operation that launched it).

On the card the profiler drops the first kernels of CUDA-graph replays in
a window, more the older the process (``harness/profiling.py::trace`` of
the port, whose workaround this copies): the stretch opens with the replay
of a lead graph of :data:`LEAD_KERNELS` empty kernels that takes the loss,
and is then left out; ``lead_lost`` says how many were dropped.  Where
it dropped all of them, it may have dropped kernels of the stretch too:
the run then takes another stretch (``harness._read_stretch``).

:data:`KERNEL_GROUPS` names device kernels as the port's
``harness/profiling.py`` does (a copy, so that a change to the program
cannot move the names the breakdown reads).  An architecture's module may
add groups of its own (its ``KERNEL_GROUPS``): they are tried after
these, so that no label of these changes, and before the fallbacks
(library matmul, copies, other), so that a new kernel gets its own.
"""

from __future__ import annotations

import bisect
import time

#: kernels of the lead graph, and the name of its kernel
#: (``torch.cuda._sleep(0)`` returns at once)
LEAD_KERNELS = 512
LEAD_NAME = "spin_kernel"
#: stretches a run takes at most while the profiler drops the whole lead
LEAD_TRIES = 3

#: kernel group label, and the substring of the device kernel's name
KERNEL_GROUPS = [("Q8_1 quantize (act_quant)", "act_quant_kernel"),
                 ("K6 gemm_exact_fused", "gemm_exact_fused_kernel"),
                 ("K8 attn_tail", "attn_tail_kernel"),
                 ("K7 gemm_exact_k16", "gemm_exact_k16_kernel"),
                 ("K1 gemm_exact", "gemm_exact_kernel"),
                 ("K2 norm_qkv", "norm_qkv"),
                 ("K3 flash_decode", "flash_decode"),
                 ("K4 gemm_dequant", "gemm_dequant_kernel"),
                 ("K5 flash_prefill", "flash_prefill"),
                 ("K3/K5 split-S merge", "attn_merge_kernel")]
LIBRARY_MATMUL = "library matmul"
MEMCPY = "memcpy/memset"
OTHER = "other (eager element ops, reductions, copies)"

#: what the host was doing, by innermost span
HOST_LABELS = {"port_bench.client": "client loop",
               "port_bench.step": "Server.step host work (admission)",
               "port_bench.decode": "decode replay",
               "port_bench.chunk": "prefill chunk replay",
               "port_bench.sample": "sampling",
               None: "outside the benchmark's spans"}


def group(name: str, extra=()) -> str:
    """The label of a device activity's name: its :data:`KERNEL_GROUPS` or
    ``extra`` group's, else a fallback."""
    for label, key in (*KERNEL_GROUPS, *extra):
        if key in name:
            return label
    low = name.lower()
    if "gemm" in low or "xmma" in low or "cutlass" in low:
        return LIBRARY_MATMUL
    if low.startswith(("memcpy", "memset")):
        return MEMCPY
    return OTHER


def union_ns(intervals: list, lo: int, hi: int) -> int:
    """Length of the union of ``(start, end)`` intervals clipped to
    [lo, hi]."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps_ns(intervals: list, lo: int, hi: int) -> list:
    """The ``(start, end)`` stretches of [lo, hi] that no interval
    covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if e <= at:
            continue
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


class Timeline:
    """The innermost span open at each host time, from nested spans."""

    def __init__(self, spans: list):
        edges = []
        for s, e, name in spans:
            edges.append((s, 1, e, name))
            edges.append((e, 0, s, name))
        edges.sort(key=lambda x: (x[0], x[1]))
        self.times, self.labels = [], []
        stack: list = []
        for t, opening, _, name in edges:
            if opening:
                stack.append(name)
            elif name in stack:
                stack.reverse()
                stack.remove(name)
                stack.reverse()
            self.times.append(t)
            self.labels.append(stack[-1] if stack else None)

    def at(self, t: int):
        i = bisect.bisect_right(self.times, t) - 1
        return self.labels[i] if i >= 0 else None


class Stretch:
    """Start and stop the profiler around a stretch of whole steps; after
    :meth:`stop`, its reading: ``activities`` [(start_ns, end_ns, name,
    span)], ``t0_ns`` / ``t1_ns`` (the stretch on the profiler's clock),
    ``lead_lost``, ``unattributed``.  ``groups``: the architecture's
    kernel groups, besides :data:`KERNEL_GROUPS`."""

    def __init__(self, device, groups=()):
        import torch

        self.device = device
        self.groups = tuple(groups)
        self.cuda = device.type == "cuda"
        self.started = self.running = False
        self._lead = None
        if self.cuda:
            torch.cuda._sleep(0)
            torch.cuda.synchronize(device)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(LEAD_KERNELS):
                    torch.cuda._sleep(0)
            self._lead = g
        # the profiler's first start in a process takes seconds: take it
        # here, in set-up
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])
        with profile(activities=acts):
            if self.cuda:
                torch.cuda._sleep(0)
                torch.cuda.synchronize(device)
        self.activities: list = []
        self.spans: list = []
        self.t0_ns = self.t1_ns = 0
        self.lead_lost = None
        self.unattributed = 0
        self.read_s = 0.0

    def _wrap(self):
        from torch.profiler import record_function

        from quant_gemm_tpu_torch.models import sampling, serve

        run, sample = serve.Graphs.run, sampling.sample

        def graphs_run(graphs, key, fn):
            with record_function(f"port_bench.{key[0]}"):
                return run(graphs, key, fn)

        def sampled(*a, **k):
            with record_function("port_bench.sample"):
                return sample(*a, **k)

        serve.Graphs.run, sampling.sample = graphs_run, sampled
        self._undo = (serve.Graphs, run, sampling, sample)

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self._wrap()
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        if self._lead is not None:
            self._lead.replay()
            torch.cuda.synchronize(self.device)
        self._range = record_function("port_bench.stretch")
        self._range.__enter__()
        self.t_host0 = time.perf_counter()
        self.started = self.running = True

    def stop(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize(self.device)
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        graphs, run, sampling, sample = self._undo
        graphs.run, sampling.sample = run, sample
        self.running = False

    def read(self) -> None:
        """Take the stretch's reading from the profiler's events (after
        the window: it takes seconds)."""
        t = time.perf_counter()
        self._read(self._prof.profiler.kineto_results.events())
        self.read_s = time.perf_counter() - t
        self._prof = None

    def _read(self, events) -> None:
        from torch.autograd import DeviceType

        spans, ops, runtime, dev, marks = [], {}, {}, [], set()
        for e in events:
            name = e.name()
            if e.device_type() == DeviceType.CPU:
                s = e.start_ns()
                if name.startswith("port_bench."):
                    spans.append((s, e.end_ns(), name))
                if e.is_user_annotation():
                    marks.add(name)
                if name.startswith("cu"):
                    runtime[e.correlation_id()] = s
                else:
                    ops[e.correlation_id()] = s
            else:
                dev.append((e.start_ns(), e.end_ns(), name,
                            e.correlation_id(), e.linked_correlation_id()))
        outer = [s for s in spans if s[2] == "port_bench.stretch"]
        if not outer:
            raise RuntimeError("the traced stretch's span is missing from "
                               "the profiler's events")
        self.t0_ns, self.t1_ns = outer[0][0], outer[0][1]
        self.unattributed = 0
        spans = [s for s in spans if s[2] != "port_bench.stretch"]
        self.spans = spans
        line = Timeline(spans)
        kept = 0
        acts = []
        for s, e, name, corr, linked in dev:
            if name in marks or name.startswith("port_bench."):
                # the profiler's device-side copy of a host annotation's
                # range, not an activity
                continue
            if LEAD_NAME in name:
                kept += 1
                continue
            launch = ops.get(linked) if linked else None
            if launch is None:
                launch = runtime.get(corr)
            if launch is None:
                self.unattributed += 1
            acts.append((s, e, name,
                         None if launch is None else line.at(launch)))
        self.lead_lost = LEAD_KERNELS - kept if self._lead is not None \
            else None
        self.activities = acts

    # -- readings ----------------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy_s(self) -> float:
        return union_ns([(s, e) for s, e, _, _ in self.activities],
                        self.t0_ns, self.t1_ns) / 1e9

    def device_seconds(self, span: str, names=None) -> float:
        """Seconds of the activities launched in ``span`` whose name
        contains one of ``names`` (all, if None)."""
        tot = 0
        for s, e, name, sp in self.activities:
            if sp != span:
                continue
            if names is None or any(n in name.lower() for n in names):
                tot += e - s
        return tot / 1e9

    def device_ops(self, top: int = 10) -> list:
        by: dict = {}
        for s, e, name, _ in self.activities:
            if e > self.t0_ns and s < self.t1_ns:
                g = group(name, self.groups)
                by[g] = by.get(g, 0) + (e - s)
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device seconds by what the host was doing when each idle
        stretch began."""
        line = Timeline(self.spans)
        by: dict = {}
        for s, e in gaps_ns([(a, b) for a, b, _, _ in self.activities],
                            self.t0_ns, self.t1_ns):
            label = HOST_LABELS.get(line.at(s), line.at(s))
            by[label] = by.get(label, 0) + (e - s)
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]


__all__ = ["LEAD_KERNELS", "LEAD_NAME", "LEAD_TRIES", "KERNEL_GROUPS", "group",
           "union_ns", "gaps_ns", "Timeline", "Stretch"]
