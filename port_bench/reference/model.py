"""The plain float32 reference of the Llama-family decoder served here.

The published forward of Mistral-7B-v0.1 and Qwen2.5 (Hugging Face
``MistralForCausalLM`` / ``Qwen2ForCausalLM``): token embedding; per
layer RMSNorm, q/k/v projections (Qwen2: with biases), rotary embedding
on the half-split pairs (``rotate_half``, inverse frequencies
``theta ** (-2i / head_dim)``, phases in float64), causal attention with
grouped key/value heads (query head h reads key/value head h // rep) and,
where the model has one, a sliding window of ``window`` tokens, itself
included; output projection and residual; RMSNorm, SiLU(gate) * up, down
projection and residual; final RMSNorm and the head.  Every product is a
float32 ``torch.matmul`` with TF32 off; no kernel, cache or batching: each
sequence is run whole, layer by layer, attention in blocks of query rows
so that long sequences fit.

``act_bits=4`` quantizes the input of every linear map to 4-bit integers
with one scale per 32 values (``scale = amax / 7``, codes in -8..7): the
precision below the W4A8 configuration's int8 activations, the control of
the comparison.

It imports neither JAX nor the program under test.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

#: query rows of one attention block
Q_BLOCK = 1024


@dataclasses.dataclass(frozen=True)
class Arch:
    dim: int
    n_layers: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    eps: float
    rope_theta: float
    window: int
    qkv_bias: bool


@contextlib.contextmanager
def float32_exact():
    """float32 products with TF32 off, restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def quant_act(x: torch.Tensor, bits) -> torch.Tensor:
    """``x`` [..., K], or its ``bits``-bit per-32 quantization (the
    control's lower precision)."""
    if not bits:
        return x
    qmax = 2 ** (bits - 1) - 1
    b = x.reshape(*x.shape[:-1], -1, 32)
    d = b.abs().amax(dim=-1, keepdim=True) / qmax
    q = torch.where(d > 0, torch.round(b / torch.where(d > 0, d, 1.0)), 0.0)
    q = q.clamp(-qmax - 1, qmax)
    return (q * d).reshape(x.shape)


def linear(x, w, bits=None, b=None):
    y = quant_act(x, bits) @ w.T
    return y if b is None else y + b


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope_tables(arch: Arch, n: int, device):
    inv = 1.0 / (arch.rope_theta ** (
        np.arange(0, arch.head_dim, 2, dtype=np.float64) / arch.head_dim))
    t = np.arange(n, dtype=np.float64)[:, None] * inv[None, :]
    return (torch.tensor(np.cos(t), dtype=torch.float32, device=device),
            torch.tensor(np.sin(t), dtype=torch.float32, device=device))


def rope(x, cos, sin):
    """``x`` [S, H, hd] rotated by its positions' phases [S, hd / 2]."""
    h = x.shape[-1] // 2
    x0, x1 = x[..., :h], x[..., h:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)


def attention(arch: Arch, q, k, v):
    """Causal (windowed) attention of one sequence: q [S, H, hd], k and v
    [S, KV, hd] -> [S, H * hd]."""
    s, h, hd = q.shape
    rep = arch.n_heads // arch.n_kv
    out = torch.empty(s, h, hd, dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(hd)
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(s, q0 + Q_BLOCK)
        k0 = max(0, q0 - arch.window + 1) if arch.window else 0
        kk = k[k0:q1].repeat_interleave(rep, dim=1)
        vv = v[k0:q1].repeat_interleave(rep, dim=1)
        scores = torch.einsum("qhd,khd->hqk", q[q0:q1], kk) * scale
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(k0, q1, device=q.device)[None, :]
        mask = kpos <= qpos
        if arch.window:
            mask = mask & (kpos > qpos - arch.window)
        scores = scores.masked_fill(~mask, float("-inf"))
        p = torch.softmax(scores, dim=-1)
        out[q0:q1] = torch.einsum("hqk,khd->qhd", p, vv)
    return out.reshape(s, h * hd)


def layer(arch: Arch, w: dict, x, cos, sin, bits=None):
    """One decoder layer on one sequence's hidden states x [S, D]; ``w``:
    float32 ``attn_norm``, ``wq``, ``wk``, ``wv`` (``bq``, ``bk``, ``bv``),
    ``wo``, ``mlp_norm``, ``w_gate``, ``w_up``, ``w_down``."""
    s = x.shape[0]
    hd = arch.head_dim
    h = rms_norm(x, w["attn_norm"], arch.eps)
    q = linear(h, w["wq"], bits, w.get("bq")).reshape(s, arch.n_heads, hd)
    k = linear(h, w["wk"], bits, w.get("bk")).reshape(s, arch.n_kv, hd)
    v = linear(h, w["wv"], bits, w.get("bv")).reshape(s, arch.n_kv, hd)
    a = attention(arch, rope(q, cos, sin), rope(k, cos, sin), v)
    x = x + linear(a, w["wo"], bits)
    h = rms_norm(x, w["mlp_norm"], arch.eps)
    g = linear(h, w["w_gate"], bits)
    u = linear(h, w["w_up"], bits)
    return x + linear(torch.nn.functional.silu(g) * u, w["w_down"], bits)


def logits(arch: Arch, weights, seqs: list, rows: list, bits=None) -> list:
    """Teacher-forced logits of each sequence in ``seqs`` (lists of token
    ids) at its positions ``rows`` (lists of indices): float32 [len(rows),
    vocab] each.  ``weights`` gives float32 tensors on the device it
    computes on: ``embed(ids)`` the rows of the embedding, ``layer(i)``
    the dict :func:`layer` takes, ``final_norm()`` and ``head()``.  Runs
    layer by layer over every sequence, so one layer's weights are held at
    a time."""
    with float32_exact():
        xs = [weights.embed(torch.as_tensor(s)) for s in seqs]
        dev = xs[0].device
        cos, sin = rope_tables(arch, max(len(s) for s in seqs), dev)
        for i in range(arch.n_layers):
            w = weights.layer(i)
            xs = [layer(arch, w, x, cos[:len(x)], sin[:len(x)], bits)
                  for x in xs]
            del w
        norm, head = weights.final_norm(), weights.head()
        out = []
        for x, r in zip(xs, rows):
            h = rms_norm(x[torch.as_tensor(r, device=dev)], norm, arch.eps)
            out.append(linear(h, head, bits))
        return out


__all__ = ["Arch", "float32_exact", "quant_act", "linear", "rms_norm",
           "rope_tables", "rope", "attention", "layer", "logits", "Q_BLOCK"]
