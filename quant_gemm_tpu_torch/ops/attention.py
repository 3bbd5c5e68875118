"""K3: flash-decode attention over the stacked bf16 KV cache.

Replaces the Pallas kernel ``quant_gemm_tpu/ops/attention.py::
flash_decode`` for the serving slice: bf16 cache, no sliding window, no
ring, no int8 cache.  One query token per slot; the ``rep`` query rows of
a kv head share each K/V tile; slot ``b`` attends cache slots
``< pos[b]`` when the current token's ``k_current``/``v_current`` ride
along (folded in last), ``<= pos[b]`` otherwise; ``layer=`` indexes the
full ``[L, B, KV, S, hd]`` cache with no per-layer copy.  The valid range
is clamped to the cache, so any stale ``pos`` of an inactive slot stays in
bounds.

Bound on an H100: bytes (each slot's valid K and V rows read once).  The
design (``csrc/flash_decode.cu``): one block per (slot, kv head), one warp
per query row, K/V tiles of 32 rows staged in shared memory, the
online-softmax recurrence in registers, all in float32.

:func:`flash_decode` launches the kernel for CUDA tensors and runs
:func:`flash_decode_plain` for CPU tensors; ``flash_decode.launches``
counts kernel launches.  :func:`flash_decode_ref` is the counterpart of
the JAX ``flash_decode_ref``.
"""

from __future__ import annotations

import math

import torch

from ..kernels import _build

NEG_INF = float(torch.finfo(torch.float32).min)


def _layer_view(k: torch.Tensor, layer):
    if k.dim() == 5:
        if layer is None:
            raise ValueError("a stacked [L, B, KV, S, hd] cache needs layer=")
        return k[layer]
    if layer is not None:
        raise ValueError("layer= needs the stacked [L, B, KV, S, hd] cache")
    return k


def _check(q, k, v, pos, k_current, v_current, layer):
    if (k_current is None) != (v_current is None):
        raise ValueError("pass both k_current and v_current, or neither")
    kl = _layer_view(k, layer)
    b, kv, rep, hd = q.shape
    if kl.shape[:2] != (b, kv) or kl.shape[3] != hd or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} does not match cache "
                         f"{tuple(k.shape)}")
    if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise NotImplementedError("flash_decode: only the bf16 cache is "
                                  "ported")
    if pos.shape != (b,):
        raise ValueError(f"pos must be [B={b}], got {tuple(pos.shape)}")
    if k_current is not None and k_current.shape != (b, kv, 1, hd):
        raise ValueError(f"k_current must be [{b}, {kv}, 1, {hd}]")


def flash_decode_plain(q, k, v, pos, *, k_current=None, v_current=None,
                       layer=None) -> torch.Tensor:
    """Plain PyTorch version: dense masked softmax in float32 over the
    valid cache slots plus the current token, the query scaled first as
    the JAX kernel scales it."""
    _check(q, k, v, pos, k_current, v_current, layer)
    f32 = torch.float32
    kl = _layer_view(k, layer).to(f32)
    vl = _layer_view(v, layer).to(f32)
    hd = q.shape[-1]
    s = kl.shape[2]
    qs = q.to(f32) * (1.0 / math.sqrt(hd))
    scores = torch.einsum("bgrd,bgsd->bgrs", qs, kl)
    has_cur = k_current is not None
    valid = (pos.to(torch.int64) + (0 if has_cur else 1)).clamp(0, s)
    mask = torch.arange(s, device=q.device)[None, :] < valid[:, None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    if not has_cur:
        return torch.einsum("bgrs,bgsd->bgrd", torch.softmax(scores, -1), vl)
    cur = (qs * k_current.to(f32)).sum(-1, keepdim=True)
    probs = torch.softmax(torch.cat([scores, cur], dim=-1), dim=-1)
    return (torch.einsum("bgrs,bgsd->bgrd", probs[..., :s], vl)
            + probs[..., s:] * v_current.to(f32))


def flash_decode(q, k, v, pos, *, k_current=None, v_current=None,
                 layer=None) -> torch.Tensor:
    """Causal decode attention; ``q`` [B, KV, rep, hd] float32, cache
    bf16 ``[L, B, KV, S, hd]`` with ``layer=`` (or ``[B, KV, S, hd]``),
    ``pos`` int [B]; returns float32 [B, KV, rep, hd]."""
    _check(q, k, v, pos, k_current, v_current, layer)
    dev = q.device
    ops = [k, v, pos] + ([k_current, v_current] if k_current is not None
                         else [])
    if dev.type == "cpu" and all(t.device.type == "cpu" for t in ops):
        return flash_decode_plain(q, k, v, pos, k_current=k_current,
                                  v_current=v_current, layer=layer)
    if dev.type != "cuda" or any(t.device != dev for t in ops):
        raise ValueError("flash_decode: all operands must be on one CUDA "
                         "device (or all on the CPU)")
    b, kv, rep, hd = q.shape
    if not k.is_contiguous() or not v.is_contiguous():
        raise ValueError("flash_decode reads the cache in place: it must be "
                         "contiguous")
    s = k.shape[-2]
    qf = q.to(torch.float32).contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    has_cur = k_current is not None
    kcur = k_current.to(torch.bfloat16).contiguous() if has_cur else None
    vcur = v_current.to(torch.bfloat16).contiguous() if has_cur else None
    out = torch.empty(b, kv, rep, hd, dtype=torch.float32, device=dev)
    fn = _build.function(
        "flash_decode", "qgt_flash_decode_bf16",
        [_build.P] * 7 + [_build.I] * 7 + [_build.F, _build.P])
    null = _build.P(None)
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(qf), _build.ptr(k), _build.ptr(v),
                _build.ptr(pos32), _build.ptr(kcur) if has_cur else null,
                _build.ptr(vcur) if has_cur else null, _build.ptr(out),
                b, kv, rep, hd, s, 0 if layer is None else int(layer),
                int(has_cur), 1.0 / math.sqrt(hd), _build.stream(dev))
    _build.check("flash_decode", "qgt_flash_decode_bf16", rc)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_ref(q, k, v, pos) -> torch.Tensor:
    """Reference (the same math as the dense model attention at T=1):
    ``k``/``v`` [B, KV, S, hd], slots ``<= pos`` attended."""
    return flash_decode_plain(q, k, v, pos)


__all__ = ["flash_decode", "flash_decode_plain", "flash_decode_ref",
           "NEG_INF"]
