"""Batched token sampling for the serving loop, in plain PyTorch.

Counterpart of ``quant_gemm_tpu/models/sampling.py``: per-row temperature,
top-k, top-p, min-p, repetition penalty and sparse logit bias, with the
same filters and thresholds.  ``temperature <= 0`` is greedy (exact
argmax, first index on ties, as ``jnp.argmax``).  Draws come from each
row's own ``torch.Generator`` (one per request, seeded from the request
seed), so a request's tokens do not depend on what shares its batch; they
do not reproduce JAX's random bits.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = float("-inf")


def filter_logits(scaled: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """Mask ``scaled`` [B, V] to the per-row top-k / nucleus set
    (``top_k <= 0`` and ``top_p >= 1`` disable; ties at the threshold
    are kept)."""
    v = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    idx = (top_k - 1).clamp(0, v - 1).to(torch.int64)
    thr_k = sorted_desc.gather(-1, idx[:, None])[:, 0]
    thr_k = torch.where(top_k > 0, thr_k, NEG_INF)
    probs = torch.softmax(sorted_desc, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    keep = cum_excl < top_p.clamp(0.0, 1.0)[:, None]
    jstar = (keep.sum(dim=-1) - 1).clamp(min=0)
    thr_p = sorted_desc.gather(-1, jstar[:, None])[:, 0]
    thr_p = torch.where(top_p < 1.0, thr_p, NEG_INF)
    thr = torch.maximum(thr_k, thr_p)
    return torch.where(scaled >= thr[:, None], scaled, NEG_INF)


def min_p_filter(scaled: torch.Tensor, min_p: torch.Tensor) -> torch.Tensor:
    """llama.cpp min-p: keep logits ``>= max + log(min_p)``; <= 0 off."""
    mp = min_p.to(torch.float32).clamp(0.0, 1.0)
    lmax = scaled.amax(dim=-1)
    thr = torch.where(mp > 0.0, lmax + torch.log(mp.clamp(min=1e-10)),
                      NEG_INF)
    return torch.where(scaled >= thr[:, None], scaled, NEG_INF)


def apply_repeat_penalty(logits: torch.Tensor, recent: torch.Tensor,
                         penalty: torch.Tensor) -> torch.Tensor:
    """Penalize tokens in ``recent`` [B, W] (< 0 empty): positive logits
    divide by the penalty, negative ones multiply; 1.0 disables."""
    b, v = logits.shape
    pen = penalty.to(torch.float32)
    safe = torch.where(recent >= 0, recent, v).to(torch.int64)
    mask = torch.zeros(b, v + 1, dtype=torch.bool, device=logits.device)
    mask.scatter_(1, safe, True)
    pb = pen[:, None]
    penalized = torch.where(logits > 0, logits / pb, logits * pb)
    out = torch.where(mask[:, :v], penalized, logits)
    return torch.where((pen != 1.0)[:, None], out, logits)


def apply_logit_bias(logits: torch.Tensor, bias_ids: torch.Tensor,
                     bias_vals: torch.Tensor) -> torch.Tensor:
    """Add ``bias_vals`` [B, K] at ``bias_ids`` [B, K] (< 0 empty)."""
    b, v = logits.shape
    safe = torch.where(bias_ids >= 0, bias_ids, v).to(torch.int64)
    padded = torch.nn.functional.pad(logits, (0, 1))
    padded.scatter_add_(1, safe, bias_vals.to(torch.float32))
    return padded[:, :v]


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype)


def sample(logits: torch.Tensor, generators, temperature, top_k=None,
           top_p=None, min_p=None, recent=None, repeat_penalty=None,
           bias_ids=None, bias_vals=None) -> torch.Tensor:
    """One token per row of ``logits`` [B, V]; int64 [B] on its device.

    ``generators``: one ``torch.Generator`` (on the logits' device) per
    row, used only by rows with ``temperature > 0``.  The per-row options
    are host arrays of length B."""
    b = logits.shape[0]
    dev = logits.device
    t_host = _host(temperature, np.float32)

    def dev_arr(x, dtype, fill):
        x = np.full(b, fill) if x is None else _host(x, None)
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    logits = logits.to(torch.float32)
    if bias_ids is not None and bias_vals is not None:
        logits = apply_logit_bias(
            logits, torch.as_tensor(_host(bias_ids, np.int64), device=dev),
            torch.as_tensor(_host(bias_vals, np.float32), device=dev))
    if recent is not None and repeat_penalty is not None:
        logits = apply_repeat_penalty(
            logits, torch.as_tensor(_host(recent, np.int64), device=dev),
            dev_arr(repeat_penalty, torch.float32, 1.0))
    greedy = torch.argmax(logits, dim=-1)
    rows = [i for i in range(b) if t_host[i] > 0]
    if not rows:
        return greedy
    t = torch.as_tensor(t_host, device=dev)
    scaled = logits / t.clamp(min=1e-6)[:, None]
    filtered = filter_logits(scaled, dev_arr(top_k, torch.int64, 0),
                             dev_arr(top_p, torch.float32, 1.0))
    if min_p is not None:
        # min-p keeps its set on the raw (pre-temperature) distribution
        keep = torch.isfinite(min_p_filter(logits,
                                           dev_arr(min_p, torch.float32, 0)))
        filtered = torch.where(keep, filtered, NEG_INF)
    probs = torch.softmax(filtered, dim=-1)
    out = greedy.clone()
    for i in rows:
        out[i] = torch.multinomial(probs[i], 1, generator=generators[i])[0]
    return out


__all__ = ["sample", "filter_logits", "min_p_filter", "apply_repeat_penalty",
           "apply_logit_bias"]
