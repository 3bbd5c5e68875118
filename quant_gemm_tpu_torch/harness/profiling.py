"""Profiling and roofline accounting on the card.

Counterpart of ``quant_gemm_tpu/harness/profiling.py``:

* :func:`trace` — a context manager around ``torch.profiler`` (CPU and
  CUDA activities) that writes a Chrome trace JSON into a directory (on
  the card behind a lead graph that takes the kernels the profiler
  drops from the head of a window's CUDA-graph replays);
* :func:`roofline` / :func:`bound` — the least time an H100 could take
  for a piece of work: the larger of its bytes over the HBM rate and its
  operations over the peak rate of their type, from NVIDIA's data sheet
  (SXM, dense, at the 700 W power limit).  Unlike JAX's, nothing is
  rounded up to a tile (JAX's ``m_eff = max(m, 8)`` is the MXU's
  sublane): the bound is of the work, whatever implements it;
* :func:`device_breakdown` — one call under ``torch.profiler``: the
  card's busy time by kernel group (:data:`KERNEL_GROUPS`) and its idle
  share between the first kernel's start and the last one's end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import torch

from .benchmark import HBM_GBPS, gemm_flops, weight_bytes

# H100 SXM peaks, NVIDIA's data sheet (dense, no sparsity)
INT8_TOPS = 1979.0
BF16_TFLOPS = 989.0
F32_TFLOPS = 67.0  # outside the tensor cores
#: peak operations a second by operand type; "bf16x3": a float32-accurate
#: product as three bf16 passes (K4's float32 forms), the least work that
#: gives one on this card
PEAK_OPS = {"int8": INT8_TOPS * 1e12, "bf16": BF16_TFLOPS * 1e12,
            "bf16x3": BF16_TFLOPS * 1e12 / 3, "f32": F32_TFLOPS * 1e12}
HBM_BYTES_PER_S = HBM_GBPS * 1e9


#: kernels of the lead graph :func:`trace` replays ahead of its block
LEAD_KERNELS = 512
#: the lead's kernel, part of its name (``torch.cuda._sleep(0)``: it
#: returns at once)
LEAD_NAME = "spin_kernel"
#: windows a reading takes at most while the profiler drops the whole lead
LEAD_TRIES = 3
_LEADS: dict = {}


def _lead(device: int):
    """A CUDA graph of :data:`LEAD_KERNELS` empty spin kernels, captured
    once per device."""
    g = _LEADS.get(device)
    if g is None:
        torch.cuda._sleep(0)
        torch.cuda.synchronize(device)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(LEAD_KERNELS):
                torch.cuda._sleep(0)
        _LEADS[device] = g
    return g


def strip_lead(doc: dict) -> int:
    """Remove the lead graph's kernels from a Chrome trace ``doc`` (in
    place) and return how many it held; raises :class:`ProfileError`
    when it held none, as then the block's first kernels may be lost
    too."""
    evs = doc["traceEvents"]
    keep = [e for e in evs if not (e.get("cat") == "kernel"
                                   and LEAD_NAME in e.get("name", ""))]
    kept = len(evs) - len(keep)
    if not kept:
        raise ProfileError(f"the profiler dropped all {LEAD_KERNELS} kernels "
                           "of the lead graph: the block's first graph "
                           "kernels may be missing from the trace")
    doc["traceEvents"] = keep
    return kept


@contextlib.contextmanager
def trace(logdir: str, name: str = "trace.json", info: dict | None = None):
    """``with profiling.trace(dir) as path: run()``: profiles the block
    (CPU activity, and CUDA where a card is there) and writes its Chrome
    trace to ``path`` (``logdir/name``) when the block ends.

    On an H100 with torch 2.11 and CUDA 12.8 the profiler drops the
    first kernels of the CUDA-graph replays in a window: its log counts
    them "Out-of-range".  How many grows with the process's age
    (``scripts/trace_loss.py``: none at 10 s, 7 at 100 s, 16 at 220 s),
    whatever waits or eager work precede or follow the replay; eager
    kernels are not dropped; the cause is not known.  So on the card the window opens with a
    replay of a lead graph of :data:`LEAD_KERNELS` empty kernels that
    takes the loss; they are removed from the trace, and
    :func:`strip_lead` raises when none of them is left (it happened once
    in about fifty windows; the caller may take the window again, as
    :func:`device_breakdown` does).  ``info``, when given, gets
    ``lead_dropped``: how many the profiler dropped."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        lead = _lead(torch.cuda.current_device())
    path = os.path.join(logdir, name)
    with profile(activities=acts) as prof:
        if cuda:
            lead.replay()
        yield path
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    if cuda:
        with open(path) as f:
            doc = json.load(f)
        kept = strip_lead(doc)
        with open(path, "w") as f:
            json.dump(doc, f)
        if info is not None:
            info["lead_dropped"] = LEAD_KERNELS - kept


def bound(nbytes: float, ops: float, kind: str):
    """``(ms, "bytes" or "operations")``: the larger of ``nbytes`` over
    the HBM rate and ``ops`` over the peak of ``kind`` (a
    :data:`PEAK_OPS` key), and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass
class Roofline:
    mem_time_us: float
    compute_time_us: float
    bytes: int
    flops: int

    @property
    def bound(self) -> str:
        return "memory" if self.mem_time_us >= self.compute_time_us else "compute"

    @property
    def time_us(self) -> float:
        return max(self.mem_time_us, self.compute_time_us)

    def efficiency(self, measured_time_s: float) -> float:
        """Fraction of the speed-of-light floor achieved."""
        return self.time_us / (measured_time_s * 1e6)


def roofline(qtype: str, m: int, n: int, k: int,
             act_bytes_per_elem: float = 2.0, peak="bf16") -> Roofline:
    """Floors for one quantized GEMM C[M, N] = A[M, K] W[N, K]^T: the
    weight's bytes in the port's layout (:func:`weight_bytes`), the
    activation's (``act_bytes_per_elem``: 2 for bf16, 1.125 for Q8_1's
    codes and f16 ``d``, ``s``, 4 for float32), the float32 output, and
    ``2 M N K`` operations at ``peak`` (a :data:`PEAK_OPS` key, or
    TFLOP/s as a number)."""
    byts = weight_bytes(qtype, n, k) + int(m * k * act_bytes_per_elem) \
        + m * n * 4
    flops = gemm_flops(m, n, k)
    rate = PEAK_OPS[peak] if isinstance(peak, str) else peak * 1e12
    return Roofline(mem_time_us=byts / HBM_BYTES_PER_S * 1e6,
                    compute_time_us=flops / rate * 1e6, bytes=byts,
                    flops=flops)


# ---------------------------------------------------------------------------
# the profiler's view of a window
# ---------------------------------------------------------------------------

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
OTHER = "other (eager element ops, reductions, copies)"


class ProfileError(RuntimeError):
    """The profiler's window cannot say what was asked of it."""


def group(name: str) -> str:
    """The :data:`KERNEL_GROUPS` label of a device kernel's name."""
    for label, key in KERNEL_GROUPS:
        if key in name:
            return label
    low = name.lower()
    if "gemm" in low or "xmma" in low or "cutlass" in low:
        return "library matmul (the plain K16 prefill route, LoRA deltas)"
    if low.startswith(("memcpy", "memset")):
        return "memcpy/memset"
    return OTHER


def device_breakdown(label, fn, graph=False):
    """One call of ``fn`` under ``torch.profiler`` (after one untraced
    call): the device's busy time by kernel group, and its idle share
    between the first kernel's start and the last one's end; the "other"
    group by kernel name, its 12 largest (printed).  Raises
    :class:`ProfileError` when the profiler traced no device activity, or
    none of a hand kernel.  ``graph``: ``fn`` replays a CUDA graph, and
    the lead graph of :func:`trace` runs ahead of it in the window (its
    kernels left out); a window that kept none of the lead is taken
    again, said so, up to :data:`LEAD_TRIES` windows, then
    :class:`ProfileError`.  Should the profiler see none of the kernels,
    the replay is timed with CUDA events instead, and said so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    lead = _lead(torch.cuda.current_device()) if graph else None
    for _ in range(LEAD_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if lead is not None:
                lead.replay()
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        n_lead = sum(LEAD_NAME in e.name for e in kern)
        kern = [e for e in kern if LEAD_NAME not in e.name]
        if not (kern and graph and not n_lead):
            break
        print(f"  {label}: the profiler dropped all {LEAD_KERNELS} kernels "
              "of the lead graph; the window is taken again", flush=True)
    else:
        raise ProfileError(f"{label}: the profiler dropped the whole lead "
                           f"graph in {LEAD_TRIES} windows")
    if not kern and graph:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b)
        print(f"  {label}: CUPTI showed none of the graph's kernels; the "
              f"replay timed with CUDA events: {ms:.3f} ms (no busy/idle "
              "split)", flush=True)
        return {"host_ms": host_ms, "device_span_ms": ms, "busy_ms": None,
                "idle_share": None, "groups": {}}
    if not kern:
        raise ProfileError(f"{label}: torch.profiler traced no device "
                           "activity")
    return summarize(label, kern, host_ms)


def summarize(label, kern, host_ms):
    """:func:`device_breakdown`'s reading of the device events ``kern``."""
    span = (max(e.time_range.end for e in kern)
            - min(e.time_range.start for e in kern)) / 1e3
    groups: dict = {}
    other: dict = {}
    for e in kern:
        ms = e.time_range.elapsed_us() / 1e3
        name = group(e.name)
        g = groups.setdefault(name, [0.0, 0])
        g[0] += ms
        g[1] += 1
        if name == OTHER:
            o = other.setdefault(e.name, [0.0, 0])
            o[0] += ms
            o[1] += 1
    if not any(k.startswith("K") for k in groups):
        raise ProfileError(f"{label}: torch.profiler traced none of the "
                           "hand kernels")
    busy = sum(g[0] for g in groups.values())
    out = {"host_ms": host_ms, "device_span_ms": span, "busy_ms": busy,
           "idle_share": 1.0 - busy / span if span > 0 else 0.0,
           "groups": {k: {"ms": v[0], "n": v[1]} for k, v in
                      sorted(groups.items(), key=lambda kv: -kv[1][0])}}
    print(f"  {label} (torch.profiler): host {host_ms:.3f} ms with the "
          f"profiler on, device span {span:.3f} ms, busy {busy:.3f} ms, "
          f"idle share {out['idle_share']:.3f}, {len(kern)} device "
          "activities", flush=True)
    for k, v in out["groups"].items():
        print(f"    {k}: {v['ms']:.3f} ms in {v['n']} launches "
              f"({v['ms'] / busy:.1%} of busy)", flush=True)
    for name, (ms, n) in sorted(other.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"      other by name: {ms:.3f} ms in {n}: {name[:110]}",
              flush=True)
    return out


__all__ = ["trace", "strip_lead", "LEAD_KERNELS", "LEAD_NAME", "LEAD_TRIES",
           "roofline",
           "Roofline", "bound", "HBM_GBPS", "HBM_BYTES_PER_S", "BF16_TFLOPS",
           "INT8_TOPS", "F32_TFLOPS", "PEAK_OPS", "KERNEL_GROUPS", "OTHER",
           "ProfileError", "group", "device_breakdown", "summarize"]
