"""Readings that a cell's correctness limit is set from, on the card.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3
        --seconds 15 [--control]

For each seed, in one process: the cell's set-up and a window of
``--seconds`` through the same path as ``run.py`` (the sizes, the load and
the sample of the run), then the comparison's reading, ``gap_max``: the
widest gap of a served token's logit below the float32 reference's best.
With ``--control`` also ``control_gap_max``: the same reading of the
tokens that the reference at 4-bit activations (the precision below the
configuration's int8) puts first at the same positions.  One JSON line a
seed.  The benchmark's runs never run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    import torch

    from port_bench import check, harness

    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    device = torch.device("cuda", 0)
    cell = harness.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run, model, state = harness.serve(cell, seed, args.seconds, False,
                                          device, t0)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        reqs = check.sample(run, seed)
        t = time.perf_counter()
        gaps = check.gaps(harness.reference(cell, model), reqs,
                          bits=4 if args.control else None)
        line = {"seed": seed, "requests": len(gaps),
                "served": sum(g["served"] for g in gaps),
                "prompt_tokens": sum(g["prompt"] for g in gaps),
                "gap_max": max(g["gap_max"] for g in gaps),
                "reference_s": time.perf_counter() - t,
                "setup_s": run.setup_s, "window_s": run.seconds,
                "distinct": [g["distinct"] for g in gaps],
                "agree": [round(g["agree"], 4) for g in gaps],
                "margin_median": [round(g["margin_median"], 4)
                                  for g in gaps]}
        if args.control:
            line["control_gap_max"] = max(g["control_gap_max"]
                                          for g in gaps)
        print(json.dumps(line), flush=True)
        del run, model
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
