"""Text generation from one GGUF file (llama.cpp ``main``), the port's
counterpart of ``scripts/generate.py``.

Loads the weights and the GGUF-embedded tokenizer, then generates through
the continuous-batching :class:`~quant_gemm_tpu_torch.models.serve.Server`
(greedy by default; temperature / top-k / top-p / min-p / repeat penalty
per request; a GBNF grammar or JSON mode).  Runs on the card unless
``--device cpu`` asks for the CPU (the kernels' plain versions).

Usage:
    python -m quant_gemm_tpu_torch.scripts.generate -m model.gguf \\
        -p "Once upon a time" -n 64
    python -m quant_gemm_tpu_torch.scripts.generate -m model.gguf \\
        --ids 1,123,456 -n 16                      # raw ids, no tokenizer
    python -m quant_gemm_tpu_torch.scripts.generate -m model.gguf \\
        -p "hi" --chat --json --device cpu
    python -m quant_gemm_tpu_torch.scripts.generate -m model.gguf \\
        -p "hi" --lora adapter.gguf                 # a LoRA adapter
    python -m quant_gemm_tpu_torch.scripts.generate -m model.gguf \\
        -p "hi" --draft small.gguf --draft-k 4      # speculative decoding

``--draft`` (llama.cpp ``llama-speculative``) decodes through
``models/speculative.py``: greedy at ``--temp 0``, distribution-exact
sampling otherwise; it takes no grammar.
"""

from __future__ import annotations

import argparse
import sys
import time


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model", required=True, help="GGUF path")
    ap.add_argument("-p", "--prompt", default=None)
    ap.add_argument("--chat", action="store_true",
                    help="wrap the prompt as a user turn via the GGUF's "
                         "tokenizer.chat_template")
    ap.add_argument("--ids", default=None,
                    help="comma-separated token ids (skips the tokenizer)")
    ap.add_argument("-n", "--n-predict", type=int, default=64)
    ap.add_argument("--temp", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--min-p", type=float, default=0.0)
    ap.add_argument("--repeat-penalty", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--kv", default="bf16", choices=["bf16", "q8"])
    ap.add_argument("--lora", default=None, metavar="ADAPTER_GGUF",
                    help="apply a llama.cpp LoRA adapter at run time")
    ap.add_argument("--grammar-file", default=None, metavar="GBNF",
                    help="constrain sampling to a GBNF grammar (llama.cpp "
                         "--grammar-file)")
    ap.add_argument("--json", action="store_true",
                    help="constrain output to JSON (llama.cpp json.gbnf)")
    ap.add_argument("--draft", default=None, metavar="DRAFT_GGUF",
                    help="speculative decoding with this draft model "
                         "(llama.cpp llama-speculative)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="proposal length per target call")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs "
                         "the kernels' plain versions)")
    return ap


def main(argv=None) -> None:
    ap = parser()
    args = ap.parse_args(argv)
    if args.draft and (args.json or args.grammar_file):
        ap.error("--draft and grammar constraints are exclusive")

    from ..formats.gguf_file import GGUFFile
    from ..models import serve
    from ..models.gguf_loader import load_llama
    from ..models.tokenizer import tokenizer_from_gguf

    t0 = time.time()
    with GGUFFile(args.model) as gf:  # weights and tokenizer metadata
        qparams, cfg = load_llama(gf, device=args.device)
        md = gf.metadata
    if args.lora:
        from ..models import lora

        qparams = lora.attach_lora(
            qparams, lora.load_lora(args.lora, device=args.device), cfg)
        print(f"applied LoRA adapter {args.lora}", file=sys.stderr)
    print(f"loaded {args.model} in {time.time() - t0:.1f}s: {cfg}",
          file=sys.stderr, flush=True)

    tok = None
    if args.ids is not None:
        prompt_ids = [int(x) for x in args.ids.split(",")]
    else:
        if args.prompt is None:
            ap.error("need -p/--prompt or --ids")
        tok = tokenizer_from_gguf(md)
        if args.chat:
            from ..models.tokenizer import encode_with_specials, render_chat

            text = render_chat(md, [{"role": "user", "content": args.prompt}])
            # the template writes bos and the chat markers as text: map
            # them to their ids instead of tokenizing them
            prompt_ids = encode_with_specials(tok, text)
        else:
            prompt_ids = tok.encode(args.prompt)
        print(f"prompt -> {len(prompt_ids)} tokens: {prompt_ids}",
              file=sys.stderr, flush=True)

    if args.draft:
        _speculative(args, qparams, cfg, prompt_ids, tok)
        return
    srv = serve.Server(qparams, cfg, n_slots=1, cache_qtype=args.kv,
                       eos_id=tok.eos_id if tok else None,
                       device=args.device)
    gsampler = None
    if args.json or args.grammar_file:
        from ..models.grammar import JSON_GBNF, GrammarSampler

        if tok is None:
            ap.error("--grammar needs a tokenizer (not usable with --ids)")
        if args.json:
            gbnf = JSON_GBNF
        else:
            with open(args.grammar_file, encoding="utf-8") as f:
                gbnf = f.read()
        gsampler = GrammarSampler(gbnf, tok)
    rid = srv.submit(prompt_ids, max_new=args.n_predict,
                     temperature=args.temp, top_k=args.top_k,
                     top_p=args.top_p, min_p=args.min_p,
                     repeat_penalty=args.repeat_penalty, seed=args.seed,
                     grammar=gsampler)
    t0 = time.time()
    out_ids = srv.run_until_done()[rid]
    dt = time.time() - t0
    print(f"{len(out_ids)} tokens in {dt:.1f}s "
          f"({len(out_ids) / max(dt, 1e-9):.1f} tok/s)",
          file=sys.stderr, flush=True)
    if tok is not None:
        # prompt and output decoded together: the continuation alone
        # would lose its leading space
        print(tok.decode(list(prompt_ids) + list(out_ids)))
    else:
        print(",".join(str(i) for i in out_ids))


def _speculative(args, qparams, cfg, prompt_ids, tok) -> None:
    """The ``--draft`` path: the draft proposes ``--draft-k`` tokens per
    target call (greedy output equal to plain decode, sampled output
    distribution-exact), both models' caches sized for the request."""
    from ..models import speculative
    from ..models.gguf_loader import load_llama

    qp_d, cfg_d = load_llama(args.draft, device=args.device)
    need = len(prompt_ids) + args.n_predict + args.draft_k + 1
    if need > min(cfg.max_seq, cfg_d.max_seq):
        raise SystemExit(f"prompt + -n + --draft-k + 1 = {need} positions "
                         f"exceed the models' context")
    t0 = time.time()
    out, tpc = speculative.speculative_sample_decode(
        qparams, cfg._replace(max_seq=need), qp_d,
        cfg_d._replace(max_seq=need), [list(prompt_ids)], args.n_predict,
        k=args.draft_k, temperature=args.temp, top_k=args.top_k,
        top_p=args.top_p, seed=args.seed or 0)
    dt = time.time() - t0
    out_ids = [int(t) for t in out[0]]
    print(f"{len(out_ids)} tokens in {dt:.1f}s ({tpc:.2f} tokens/target-"
          "call)", file=sys.stderr, flush=True)
    if tok is not None:
        print(tok.decode(list(prompt_ids) + out_ids))
    else:
        print(",".join(str(t) for t in out_ids))


if __name__ == "__main__":
    main()
