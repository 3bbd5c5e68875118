"""Run one cell of the port's benchmark on the card and print its result.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout that holds ``quant_gemm_tpu_torch``.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``compared`` (each number the correctness check
compared, with its limit; also the last lines of standard error).  An
earlier line (``# card``) gives the card, its power limit and clocks and a
1 GiB device-to-device copy probe.  Without a CUDA card, or with fewer
cards than the cell asks for, or if the process loaded JAX or the JAX
package, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))
# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(CHECKOUT / "build" / _sub)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result(args, device, t_start=T_START, cell=None) -> dict:
    """One run of the cell on ``device`` (``cell``: a ``harness.Cell``,
    by default the one ``args.workload`` names in ``BENCHMARK.json``): the
    result object, or None when the process loaded a forbidden module
    (said on standard error)."""
    import torch

    from port_bench import check, harness

    cell = cell or harness.cell(args.workload)
    traced = bool(args.trace)
    run, model, state = harness.serve(cell, args.seed, args.seconds, traced,
                                      device, t_start)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics = harness.metrics(run, traced)
    att, fail = harness.failed(run)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    extra = {}
    if traced and run.trace is not None:
        st = run.trace
        dev["busy_s"] = st.busy_s()
        dev["window_s"] = st.window_s
        dev["lead_lost"] = st.lead_lost
        dev["stretches"] = run.info.get("stretches", 1)
        extra["breakdown"] = {"device_ops": st.device_ops(),
                              "idle_gaps": st.idle_gaps()}
        plain = [s for s in run.steps if s.contexts and not s.admitted]
        inside = [s.t1 - s.t0 for s in plain if s.traced]
        outside = [s.t1 - s.t0 for s in plain if not s.traced]
        if inside and outside:
            harness.log(f"trace cost: decode-only step median "
                        f"{statistics.median(inside) * 1e3:.3f} ms in the "
                        f"stretch, {statistics.median(outside) * 1e3:.3f} "
                        "ms outside it")
        harness.log(f"trace: {len(run.trace_steps)} steps in "
                    f"a {st.window_s:.3f} s stretch, {len(st.activities)} "
                    f"device activities, lead lost {st.lead_lost}, "
                    f"unattributed {st.unattributed}, read in "
                    f"{st.read_s:.2f} s")
    served = sum(len([t for t in r.times if run.in_window(t)])
                 for r in run.requests.values())
    ttft = [(r.times[0] - r.submitted) * 1e3 for r in run.requests.values()
            if r.client >= 0 and r.times and run.in_window(r.times[0])]
    if len(ttft) >= 20:
        q = statistics.quantiles(ttft, n=20, method="inclusive")
        harness.log(f"ttft ms over {len(ttft)} requests: p50 {q[9]:.1f}, "
                    f"p90 {q[17]:.1f}, p95 {q[18]:.1f}")
    harness.log(f"window {run.seconds:.3f} s, {len(run.steps)} steps, "
                f"{served} tokens, {att} requests attempted, {fail} failed; "
                f"set-up {run.setup_s:.2f} s; {json.dumps(run.info)}")
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    reqs = check.sample(run, args.seed)
    gaps = check.gaps(harness.reference(cell, model), reqs) if reqs else []
    harness.log(f"reference over {len(reqs)} requests "
                f"({sum(g['served'] for g in gaps)} served tokens) in "
                f"{time.perf_counter() - t:.2f} s: {json.dumps(gaps)}")
    limit = float(cell.limits.get("logit_gap_max", {}).get("limit", 0.0))
    gap = max((g["gap_max"] for g in gaps), default=float("inf"))
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"forbidden modules loaded: {', '.join(bad)}")
        return None
    compared = {"logit_gap_max": {"value": gap, "limit": limit}}
    for k, v in compared.items():
        harness.log(f"compared {k} {v['value']!r} limit {v['limit']!r}")
    return {"correct": bool(gaps) and gap <= limit, "attempted": att,
            "failed": fail, "metrics": metrics, "device": dev, **extra,
            "compared": compared}


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from port_bench import harness

    chips = [w for w in harness.spec()["workloads"]
             if w["name"] == args.workload]
    need = chips[0]["chips"] if chips else 1
    if not torch.cuda.is_available():
        harness.log("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < need:
        harness.log(f"{args.workload} needs {need} cards, "
                    f"{torch.cuda.device_count()} visible")
        return 2
    device = torch.device("cuda", 0)
    # the system under test first: without it, fail before any output
    from quant_gemm_tpu_torch.models import serve  # noqa: F401

    info = harness.card_info()
    info["copy_probe_1GiB_GBps"] = harness.copy_probe(device)
    print(f"# card {json.dumps(info)}", flush=True)
    res = result(args, device)
    if res is None:
        return 3
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
