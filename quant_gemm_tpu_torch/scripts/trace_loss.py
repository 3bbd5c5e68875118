"""How many kernels of a CUDA-graph replay ``torch.profiler`` keeps, by
the age of the process: the measurement behind the lead graph of
``harness.profiling.trace``.

A CUDA graph of ``--kernels`` small elementwise kernels is replayed once
under a plain ``torch.profiler`` window (CPU and CUDA activities) and
once under ``profiling.trace``, at the start and every ``--every``
seconds after it (the card idle in between) until ``--seconds``.  Each
probe prints one JSON line: the process's age in seconds, the graph's
kernels the plain window kept, those ``trace`` kept (null when the
window kept none of the lead and ``trace`` raised), and the lead
kernels the profiler dropped.  Needs a card.

Usage:
    python -m quant_gemm_tpu_torch.scripts.trace_loss [--kernels 1000] \\
        [--seconds 240] [--every 30]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def _kernels(path: str) -> int:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(e.get("cat") == "kernel" for e in events)


def probe(graph, t0: float) -> dict:
    """One replay of ``graph`` under each window; the counts kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..harness import profiling

    info: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "plain.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        plain = _kernels(path)
        try:
            with profiling.trace(tmp, "lead.json", info=info) as path:
                graph.replay()
            lead = _kernels(path)
        except profiling.ProfileError:  # the window kept none of the lead
            lead, info["lead_dropped"] = None, profiling.LEAD_KERNELS
    return {"age_s": round(time.perf_counter() - t0, 1), "plain": plain,
            "trace": lead, **info}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", type=int, default=1000)
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--every", type=float, default=30.0)
    args = ap.parse_args(argv)

    import torch

    from ..utils import resolve_device

    t0 = time.perf_counter()
    dev = resolve_device("cuda")
    x = torch.ones(1 << 14, device=dev)
    x.mul_(1.0001)  # the kernel's first launch, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(args.kernels):
            x.mul_(1.0001)
    out = []
    while True:
        row = {"kernels": args.kernels, **probe(graph, t0)}
        print(json.dumps(row), flush=True)
        out.append(row)
        if row["age_s"] + args.every > args.seconds:
            return out
        time.sleep(args.every)


if __name__ == "__main__":
    main()
