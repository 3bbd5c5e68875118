"""Perplexity of a token stream (llama.cpp ``perplexity``).

Counterpart of ``quant_gemm_tpu/models/evaluate.py``: perplexity = exp(mean
negative log-likelihood of the next-token predictions), the stream taken
in windows of ``ctx`` tokens advanced by ``stride``; in each window after
the first, the first ``ctx - stride`` tokens are context only (their NLL
is not counted), as llama.cpp's sliding evaluation does.  Each window is
one prefill on a fresh cache: its GEMMs take K4, its attention K5 (T >= 64).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import registry
from . import llama


def nll_of_chunk(qparams, cfg: llama.LlamaConfig, tokens: torch.Tensor,
                 act_mode: str = "q8_1",
                 ops: registry.Ops = registry.KERNELS) -> torch.Tensor:
    """Per-position next-token negative log-likelihood of one [B, T]
    chunk: float32 [B, T-1], entry t is -log p(tokens[t+1] |
    tokens[:t+1]).  The cache holds the chunk's T rows (the rows a causal
    prefill attends, so the result is that of a ``max_seq`` cache); the
    RoPE tables are the model's."""
    dev = qparams["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).to(torch.int64)
    b, t = tokens.shape
    cache = llama.KVCache.init(cfg if cfg.ring else cfg._replace(max_seq=t),
                               b, device=dev)
    logits, _ = llama.forward(qparams, cfg, tokens, cache, act_mode=act_mode,
                              rope_cache=llama.rope_for(cfg, qparams, dev),
                              ops=ops)
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None])[..., 0]


def perplexity(qparams, cfg: llama.LlamaConfig, tokens, *, ctx=None,
               stride=None, act_mode: str = "q8_1",
               ops: registry.Ops = registry.KERNELS) -> dict:
    """Sliding-window perplexity of a 1-D token stream.  ``ctx`` defaults
    to (and is capped at) ``cfg.max_seq``, ``stride`` to ``ctx // 2``.
    Returns {"ppl", "nll", "tokens"}; fewer than 2 tokens raise."""
    tokens = np.asarray(tokens, np.int64).ravel()
    if tokens.size < 2:
        raise ValueError("perplexity needs at least 2 tokens")
    ctx = min(int(ctx or cfg.max_seq), cfg.max_seq)
    stride = int(stride or max(ctx // 2, 1))
    if not 0 < stride <= ctx:
        raise ValueError(f"stride must be in 1..{ctx}, got {stride}")
    total, count, start, first = 0.0, 0, 0, True
    while start + 1 < tokens.size:
        chunk = tokens[start:start + ctx]
        if chunk.size < 2:
            break
        padded = np.pad(chunk, (0, ctx - chunk.size))
        nll = nll_of_chunk(qparams, cfg, torch.from_numpy(padded[None]),
                           act_mode, ops)[0].cpu().numpy()
        # the positions this window scores: the stride tail (the whole
        # window on the first pass), real (unpadded) predictions only
        lo = 0 if first else (ctx - stride) - 1
        hi = chunk.size - 1
        total += float(nll[lo:hi].sum())
        count += hi - lo
        first = False
        if start + ctx >= tokens.size:
            break
        start += stride
    mean = total / max(count, 1)
    return {"ppl": float(np.exp(mean)), "nll": mean, "tokens": count}


__all__ = ["perplexity", "nll_of_chunk"]
