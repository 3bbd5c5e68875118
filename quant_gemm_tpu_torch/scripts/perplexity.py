"""Perplexity of a text file under a GGUF model (llama.cpp
``llama-perplexity``), the port's counterpart of ``scripts/perplexity.py``.

Tokenizes the file with the GGUF-embedded tokenizer and runs the sliding
window evaluation (``models/evaluate.py``: stride ctx/2 by default, the
second half of each window scored).  Prints one JSON line {"ppl", "nll",
"tokens", "ctx", "stride"}.  Runs on the card unless ``--cpu`` asks for
the CPU (the kernels' plain versions).

Usage:
    python -m quant_gemm_tpu_torch.scripts.perplexity -m model.gguf \\
        -f corpus.txt [--ctx 512] [--stride 256] [--act-mode q8_1|bf16] \\
        [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def report(qparams, cfg, ids, *, ctx=None, stride=None, act_mode="q8_1",
           ops=None) -> dict:
    """The CLI's result for token ids ``ids``: ``evaluate.perplexity`` and
    the window it used (``ops``: the kernels by default)."""
    from ..kernels import registry
    from ..models import evaluate

    res = evaluate.perplexity(qparams, cfg, ids, ctx=ctx, stride=stride,
                              act_mode=act_mode,
                              ops=ops or registry.KERNELS)
    return {**res, "ctx": ctx or cfg.max_seq, "stride": stride or "ctx/2"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-f", "--file", required=True, help="UTF-8 text file")
    ap.add_argument("--ctx", type=int, default=None)
    ap.add_argument("--stride", type=int, default=None)
    ap.add_argument("--act-mode", default="q8_1", choices=["q8_1", "bf16"])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from ..formats.gguf_file import GGUFFile
    from ..models.gguf_loader import load_llama
    from ..models.tokenizer import tokenizer_from_gguf

    t0 = time.time()
    with GGUFFile(args.model) as gf:
        qparams, cfg = load_llama(gf, device=device)
        tok = tokenizer_from_gguf(gf.metadata)
    with open(args.file, encoding="utf-8") as f:
        ids = tok.encode(f.read())
    print(f"loaded model + {len(ids)} tokens in {time.time() - t0:.1f}s",
          file=sys.stderr, flush=True)
    out = report(qparams, cfg, ids, ctx=args.ctx, stride=args.stride,
                 act_mode=args.act_mode)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
