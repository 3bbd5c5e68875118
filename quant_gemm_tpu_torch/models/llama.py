"""Quantized Llama forward for the serving slice (W4A8).

Counterpart of ``quant_gemm_tpu/models/llama.py`` for what the serving
slice runs, with the bf16 or the int8 (``q8``) KV cache and an optional
sliding window.  Weights are q4_0 (:func:`quantize_params`,
:func:`init_qparams`) or the mix of a llama.cpp GGUF file
(``models/gguf_loader.py``): q4_0 or q4_K (effective q4_1) per-32 weights
and q6_K / q3_K / q2_K per-16 weights, with a :class:`SplitLinear` where
the parts of ``wqkv`` or ``wgu`` differ in format:

* decode (T = 1): RMSNorm + Q8_1 + ``wqkv`` through K2 (``norm_qkv``) when
  the batch is <= 8 and ``dim % 512 == 0``, otherwise RMSNorm then the
  dispatched GEMM; RoPE; K3 (``flash_decode``) over the stacked cache with
  the current token's k/v (bf16, with either cache) as operands; K1 GEMMs
  for ``wo``, ``wgu``, ``w_down`` and ``lm_head``; the cache write (with
  the q8 cache: codes and scales) deferred to one all-layer insert after
  the layer loop; per-16 weights take K7 (``gemm_exact_k16``) instead of
  K1, and K2 only runs when every layer's ``wqkv`` is one q4_0 weight;
  with ``registry.FUSED_DECODE`` the per-32 decode GEMMs take K6
  (``gemm_exact_fused``, bit-identical to quantize + K1), and with
  ``gemm_megalayer.ENABLE_TAIL`` everything after attention (``wo`` to
  the second residual) is one K8 (``attn_tail``) launch when every layer
  is ``tail_supported`` (q4_0, batch <= 8) — both switches off by
  default, as in the JAX package;
* prefill (T > 1): the cache written per layer, then attention: K5
  (``flash_prefill``) at T >= 64, as the JAX package routes it, and below
  that dense masked attention in float32 (plain torch, as the JAX package
  leaves it to XLA); K4 for GEMMs of more than ``DECODE_M_MAX`` rows, and
  the plain float32 matmul for per-16 weights there.

Not ported yet (each raises ``NotImplementedError``): the ring cache,
``w_down_a16`` and activation modes other than ``q8_1``.

:func:`forward` is :func:`begin`, :func:`layer` for each layer, :func:`end`
and :func:`head`; a check can call the pieces to run the kernels and the
plain versions from the same hidden state at every layer.

Layouts follow the JAX package: weights ``[N, K]``, cache ``[L, B, KV, S,
hd]`` (q8 scales ``[L, B, KV, S]``), grouped decode queries ``[B, KV, rep,
hd]``, prefill queries ``[B, KV, T*rep, hd]`` in T-major rows.  Unlike
JAX, the cache is updated in place (saving a full copy of the cache per
step); :func:`forward` returns the same :class:`KVCache` object.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..formats.quant import quantize_q4_0
from ..kernels import gemm_megalayer, layout, registry
from ..ops.activations import silu_mul
from ..ops.rms_norm import rms_norm
from ..ops.rope import apply_rope, rope_cache as make_rope_cache
from ..utils import resolve_device

FLASH_PREFILL_T_MIN = 64  # prefill chunks from this length take K5


class LlamaConfig(NamedTuple):
    """The JAX ``LlamaConfig``'s fields; ``ring`` and ``w_down_a16`` are
    not ported and must keep their defaults."""

    vocab: int = 256
    dim: int = 512
    n_layers: int = 2
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 1024
    max_seq: int = 256
    rope_base: float = 10000.0
    eps: float = 1e-5
    window: int = 0
    rope_scale: float = 1.0
    ring: bool = False
    ring_chunk: int = 256
    head_dim_override: int = 0
    w_down_a16: bool = False

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.dim // self.n_heads


def check_config(cfg: LlamaConfig) -> None:
    if cfg.ring:
        raise NotImplementedError("the ring cache is not ported")
    if cfg.window < 0:
        raise ValueError(f"window must be >= 0, got {cfg.window}")
    if cfg.w_down_a16:
        raise NotImplementedError("w_down_a16 (W4A16 down projection) is "
                                  "not ported")


def init_params(cfg: LlamaConfig, seed: int = 0) -> dict:
    """Random float32 parameters (numpy, host-side) in [N, K] row-major —
    the JAX package's ``init_params``: the same seed gives the same
    floats."""
    rng = np.random.default_rng(seed)

    def lin(n, k):
        return (rng.standard_normal((n, k)) * (1.0 / np.sqrt(k))).astype(np.float32)

    layers = []
    for _ in range(cfg.n_layers):
        layers.append(
            {
                "attn_norm": np.ones(cfg.dim, np.float32),
                "wq": lin(cfg.n_heads * cfg.head_dim, cfg.dim),
                "wk": lin(cfg.n_kv_heads * cfg.head_dim, cfg.dim),
                "wv": lin(cfg.n_kv_heads * cfg.head_dim, cfg.dim),
                "wo": lin(cfg.dim, cfg.n_heads * cfg.head_dim),
                "mlp_norm": np.ones(cfg.dim, np.float32),
                "w_gate": lin(cfg.d_ff, cfg.dim),
                "w_up": lin(cfg.d_ff, cfg.dim),
                "w_down": lin(cfg.dim, cfg.d_ff),
            }
        )
    return {
        "embed": (rng.standard_normal((cfg.vocab, cfg.dim)) * 0.02).astype(np.float32),
        "layers": layers,
        "final_norm": np.ones(cfg.dim, np.float32),
        "lm_head": lin(cfg.vocab, cfg.dim),
    }


def _prep_q4_0(w: torch.Tensor) -> layout.PreparedWeight:
    return layout.prepare(quantize_q4_0(w))


def quantize_params(params: dict, qtype: str = "q4_0",
                    device="cuda") -> dict:
    """Quantize every linear to q4_0 on ``device``, fusing ``wqkv`` and
    ``wgu`` as the JAX package does (block quantization is row-local, so
    the concatenation quantizes bit-identically to its parts).  The
    embedding stays bf16, the norms float32."""
    if qtype != "q4_0":
        raise NotImplementedError(f"only q4_0 weights are ported, not {qtype}")
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    out = {"embed": f32(params["embed"]).to(torch.bfloat16),
           "final_norm": f32(params["final_norm"]), "layers": []}
    for lyr in params["layers"]:
        q = {k: f32(v) for k, v in lyr.items() if k.endswith("norm")}
        q["wqkv"] = _prep_q4_0(f32(np.concatenate(
            [lyr["wq"], lyr["wk"], lyr["wv"]], axis=0)))
        q["wo"] = _prep_q4_0(f32(lyr["wo"]))
        q["wgu"] = _prep_q4_0(f32(np.concatenate(
            [lyr["w_gate"], lyr["w_up"]], axis=0)))
        q["w_down"] = _prep_q4_0(f32(lyr["w_down"]))
        out["layers"].append(q)
    out["lm_head"] = _prep_q4_0(f32(params["lm_head"]))
    return out


def init_qparams(cfg: LlamaConfig, seed: int = 0, device="cuda") -> dict:
    """Random q4_0 model drawn and quantized entirely on ``device`` from a
    ``torch.Generator`` seed (the JAX ``init_qparams_device``): the same
    shapes as :func:`quantize_params` output, other weight values."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)

    def lin(n, k):
        return _prep_q4_0(torch.randn(n, k, generator=g, device=dev)
                          * (1.0 / k ** 0.5))

    kq, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    out = {
        "embed": (torch.randn(cfg.vocab, cfg.dim, generator=g, device=dev)
                  * 0.02).to(torch.bfloat16),
        "final_norm": torch.ones(cfg.dim, device=dev),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        out["layers"].append({
            "attn_norm": torch.ones(cfg.dim, device=dev),
            "mlp_norm": torch.ones(cfg.dim, device=dev),
            "wqkv": lin(kq + 2 * kv, cfg.dim),
            "wo": lin(cfg.dim, kq),
            "wgu": lin(2 * cfg.d_ff, cfg.dim),
            "w_down": lin(cfg.dim, cfg.d_ff),
        })
    out["lm_head"] = lin(cfg.vocab, cfg.dim)
    return out


def rope_for(cfg: LlamaConfig, params: Optional[dict] = None,
             device="cuda"):
    """The model's RoPE tables on ``device``: cfg's base/linear-scale
    spectrum, or the per-dimension inverse frequencies a loader attached to
    the parameters (``params["rope_inv_freq"]``, GGUF
    ``rope_freqs.weight``)."""
    inv = params.get("rope_inv_freq") if isinstance(params, dict) else None
    return make_rope_cache(cfg.max_seq, cfg.head_dim, cfg.rope_base,
                           freq_scale=cfg.rope_scale,
                           device=resolve_device(device), inv_freq=inv)


class SplitLinear(NamedTuple):
    """A fused slot (``wqkv`` / ``wgu``) whose parts carry different block
    formats and so stay unfused, e.g. a Q4_K_M file's q6_K ``attn_v``
    beside q4_K ``attn_q``/``attn_k``: one GEMM per part, the outputs
    concatenated on N (llama.cpp never fuses them either)."""

    parts: tuple


@dataclasses.dataclass
class KVCache:
    """KV cache ``[L, B, KV, S, hd]`` and the per-slot count of cached
    tokens ``pos`` (int32 [B]), updated in place by :func:`forward`.

    ``qtype="q8"`` stores k/v as int8 codes with one float32 scale per
    (layer, slot, head, token) vector (``ks``/``vs`` [L, B, KV, S]), half
    the bf16 cache's bytes; the attention kernels apply the scales to the
    scores and to the softmax weights, never to the codes."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    ks: Optional[torch.Tensor] = None
    vs: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.ks is not None

    @staticmethod
    def init(cfg: LlamaConfig, batch: int, qtype: str = "bf16",
             device="cuda") -> "KVCache":
        if qtype not in ("bf16", "q8"):
            raise ValueError(f"cache qtype must be 'bf16' or 'q8', not "
                             f"{qtype!r}")
        check_config(cfg)
        dev = resolve_device(device)
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.max_seq,
                 cfg.head_dim)
        pos = torch.zeros(batch, dtype=torch.int32, device=dev)
        if qtype == "q8":
            return KVCache(
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape, dtype=torch.int8, device=dev), pos,
                torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                torch.zeros(shape[:-1], dtype=torch.float32, device=dev))
        return KVCache(torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                       torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                       pos)

    def clone(self) -> "KVCache":
        return KVCache(*(None if t is None else t.clone()
                         for t in (self.k, self.v, self.pos, self.ks,
                                   self.vs)))


def _quant_kv(x: torch.Tensor):
    """[..., hd] float32 -> (int8 codes, float32 scale [...]): per-vector
    ``amax / 127``, codes rounded half to even (the JAX ``_quant_kv``)."""
    scale = x.abs().amax(dim=-1) / 127.0
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
    return torch.round(x * inv[..., None]).to(torch.int8), scale


def _linear(w, x: torch.Tensor, ops) -> torch.Tensor:
    """y[M, N] = x[M, K] @ W^T, W4A8: x quantized to Q8_1 in dispatch; a
    :class:`SplitLinear` runs one GEMM per part, concatenated on N."""
    if isinstance(w, SplitLinear):
        return torch.cat([_linear(p, x, ops) for p in w.parts], dim=-1)
    return registry.dispatch(w, x.to(torch.float32), quantize_act=True,
                             ops=ops)


def _attention(cfg: LlamaConfig, q, k_all, v_all, positions, ks=None,
               vs=None):
    """Dense causal attention in float32 (the JAX CPU numerics), the
    prefill path below ``FLASH_PREFILL_T_MIN``.

    q: [B, T, H, hd]; k_all/v_all: [B, KV, S, hd] (the layer's full
    cache, current chunk already written); ks/vs: [B, KV, S] int8-cache
    scales or None; positions: [B, T] — the query at position p attends
    cache slots <= p (and > p - window)."""
    b, tq, h, hd = q.shape
    kv, s = k_all.shape[1], k_all.shape[2]
    qg = q.reshape(b, tq, kv, h // kv, hd).to(torch.float32)
    scores = torch.einsum("btgrd,bgsd->bgrts", qg, k_all.to(torch.float32)) \
        / float(np.float32(np.sqrt(hd)))
    if ks is not None:  # int8 cache: the k scale factors out of the hd dot
        scores = scores * ks[:, :, None, None, :]
    span = torch.arange(s, device=q.device)[None, None, :]
    mask = span <= positions[:, :, None]  # [B, T, S]
    if cfg.window:
        mask = mask & (span > positions[:, :, None] - cfg.window)
    scores = torch.where(mask[:, None, None], scores,
                         torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    if vs is not None:  # the v scale folds into the softmax weights
        probs = probs * vs[:, :, None, None, :]
    out = torch.einsum("bgrts,bgsd->btgrd", probs, v_all.to(torch.float32))
    return out.reshape(b, tq, h * hd)


class Step(NamedTuple):
    """What every layer of one forward call shares: each slot's token
    positions [B, T], the clamped cache-write start [B], the rope tables
    and whether decode takes K2 (``norm_qkv``) and K8 (``attn_tail``)."""

    positions: torch.Tensor
    wstart: torch.Tensor
    rope_cache: tuple
    use_mega: bool
    use_mega_tail: bool


def begin(qparams: dict, cfg: LlamaConfig, tokens: torch.Tensor,
          cache: KVCache, *, act_mode: str = "q8_1", rope_cache=None):
    """Check a call of T tokens per slot and embed them: returns the
    float32 hidden state [B, T, D] and the call's :class:`Step`."""
    check_config(cfg)
    if act_mode != "q8_1":
        raise NotImplementedError(f"act_mode {act_mode!r} is not ported "
                                  "(W4A8 q8_1 only)")
    b, t = tokens.shape
    dev = cache.k.device
    if rope_cache is None:
        rope_cache = rope_for(cfg, qparams, dev)
    pos0 = cache.pos.to(torch.int64)
    positions = pos0[:, None] + torch.arange(t, device=dev)[None, :]
    # a cache write starts at pos, clamped so the T-row update fits (the
    # start clamp of JAX's dynamic_update_slice, which overflowing and
    # inactive slots rely on)
    wstart = pos0.clamp(0, cache.k.shape[3] - t)
    # the port's K2 serves q4_0 only, so any q4_k or SplitLinear wqkv
    # turns it off for the whole model; JAX's K2 also takes q4_k, and
    # only a SplitLinear turns it off there (ROADMAP Queue 1)
    use_mega = t == 1 and all(
        gemm_megalayer.supported(ly["wqkv"], cfg.dim, b)
        for ly in qparams["layers"])
    use_mega_tail = t == 1 and all(
        gemm_megalayer.tail_supported(ly, cfg, b) for ly in qparams["layers"])
    x = qparams["embed"][tokens.to(dev)].to(torch.float32)
    return x, Step(positions, wstart, rope_cache, use_mega, use_mega_tail)


def layer(lyr: dict, li: int, cfg: LlamaConfig, x: torch.Tensor,
          cache: KVCache, step: Step, ops: registry.Ops = registry.KERNELS):
    """Decoder layer ``li`` on the hidden state x [B, T, D].  Returns the
    new hidden state and, at decode, what :func:`end` inserts for the
    current token: its (k, v) [B, KV, hd] bf16, or with the q8 cache its
    (k codes, v codes, k scales, v scales); prefill writes the cache
    here."""
    b, t, _ = x.shape
    heads, kv_heads, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    nq, nkv, rep = heads * hd, kv_heads * hd, heads // kv_heads
    if step.use_mega:
        qkv = ops.norm_qkv(lyr["wqkv"], x.reshape(b * t, cfg.dim),
                           lyr["attn_norm"], cfg.eps)
    else:
        h = rms_norm(x, lyr["attn_norm"], cfg.eps)
        qkv = _linear(lyr["wqkv"], h.reshape(b * t, cfg.dim), ops)
    q = qkv[:, :nq].reshape(b, t, heads, hd)
    k = qkv[:, nq:nq + nkv].reshape(b, t, kv_heads, hd)
    v = qkv[:, nq + nkv:].reshape(b, t, kv_heads, hd)
    q = apply_rope(q, step.positions, step.rope_cache)
    k = apply_rope(k, step.positions, step.rope_cache)
    scales = (dict(k_scale=cache.ks, v_scale=cache.vs) if cache.quantized
              else {})
    current = None
    if t == 1:
        # decode: the current token rides as kernel operands in bf16 (with
        # either cache); the cache write waits for one all-layer insert
        # after the loop
        k_t = k.transpose(1, 2).to(torch.bfloat16)  # [B, KV, 1, hd]
        v_t = v.transpose(1, 2).to(torch.bfloat16)
        if cache.quantized:
            (kq, kscale), (vq, vscale) = _quant_kv(k[:, 0]), _quant_kv(v[:, 0])
            current = (kq, vq, kscale, vscale)
        else:
            current = (k_t[:, :, 0], v_t[:, :, 0])
        attn = ops.flash_decode(
            q.reshape(b, kv_heads, rep, hd), cache.k, cache.v, cache.pos,
            k_current=k_t, v_current=v_t, layer=li, window=cfg.window,
            **scales).reshape(b, t, nq)
    else:
        bidx = torch.arange(b, device=x.device)[:, None]
        idx = step.wstart[:, None] + torch.arange(t, device=x.device)[None, :]
        # advanced indices around a slice: the indexed view is [B, T, KV,
        # hd], the layout k/v have before the transpose
        if cache.quantized:
            (kq, kscale), (vq, vscale) = _quant_kv(k), _quant_kv(v)
            cache.k[li][bidx, :, idx] = kq
            cache.v[li][bidx, :, idx] = vq
            cache.ks[li][bidx, :, idx] = kscale
            cache.vs[li][bidx, :, idx] = vscale
        else:
            cache.k[li][bidx, :, idx] = k.to(torch.bfloat16)
            cache.v[li][bidx, :, idx] = v.to(torch.bfloat16)
        if t >= FLASH_PREFILL_T_MIN:
            # T-major grouped rows (row = t*rep + r) for K5
            qg = (q.reshape(b, t, kv_heads, rep, hd).transpose(1, 2)
                  .reshape(b, kv_heads, t * rep, hd))
            attn = ops.flash_prefill(
                qg, cache.k, cache.v, step.positions[:, 0], rep=rep,
                window=cfg.window, layer=li, **scales)
            attn = (attn.reshape(b, kv_heads, t, rep, hd).transpose(1, 2)
                    .reshape(b, t, nq))
        else:
            attn = _attention(
                cfg, q, cache.k[li], cache.v[li], step.positions,
                *((cache.ks[li], cache.vs[li]) if cache.quantized else ()))
    if step.use_mega_tail:
        x = ops.attn_tail(attn.reshape(b * t, nq), x.reshape(b * t, cfg.dim),
                          lyr["mlp_norm"], lyr["wo"], lyr["wgu"],
                          lyr["w_down"], cfg.eps, cfg.d_ff)
        return x.reshape(b, t, cfg.dim), current
    o = _linear(lyr["wo"], attn.reshape(b * t, nq), ops)
    x = x + o.reshape(b, t, cfg.dim)
    h = rms_norm(x, lyr["mlp_norm"], cfg.eps)
    gu = _linear(lyr["wgu"], h.reshape(b * t, cfg.dim), ops)
    ff = silu_mul(gu[:, :cfg.d_ff], gu[:, cfg.d_ff:])
    dn = _linear(lyr["w_down"], ff, ops)
    return x + dn.reshape(b, t, cfg.dim), current


def end(cache: KVCache, step: Step, current: list) -> None:
    """Insert decode's current tokens of every layer (``current``: what
    :func:`layer` returned for each layer) and advance ``cache.pos``."""
    if current:
        # one insert per buffer covers every layer: k[:, bidx, :, wstart]
        # is the [B, L, KV, hd] view of each slot's write row (ks: [B, L,
        # KV])
        bidx = torch.arange(cache.k.shape[1], device=cache.k.device)
        bufs = (cache.k, cache.v, cache.ks, cache.vs)
        for buf, vals in zip(bufs, zip(*current)):
            buf[:, bidx, :, step.wstart] = torch.stack(vals).transpose(0, 1)
    cache.pos = (step.positions[:, -1] + 1).to(torch.int32)


def head(qparams: dict, cfg: LlamaConfig, x: torch.Tensor,
         ops: registry.Ops = registry.KERNELS) -> torch.Tensor:
    """Final norm and ``lm_head``: logits [B, T, vocab] float32."""
    b, t, _ = x.shape
    x = rms_norm(x, qparams["final_norm"], cfg.eps)
    logits = _linear(qparams["lm_head"], x.reshape(b * t, cfg.dim), ops)
    return logits.reshape(b, t, -1)


def forward(qparams: dict, cfg: LlamaConfig, tokens: torch.Tensor,
            cache: KVCache, *, act_mode: str = "q8_1", rope_cache=None,
            ops: registry.Ops = registry.KERNELS):
    """Run T tokens per slot (prefill when T > 1, decode when T = 1).

    Slots advance independently by their own ``cache.pos``.  Returns
    (logits [B, T, vocab] float32, cache), the cache updated in place.
    ``ops`` selects the kernels (default) or, on purpose, their plain
    versions (``registry.PLAIN``)."""
    x, step = begin(qparams, cfg, tokens, cache, act_mode=act_mode,
                    rope_cache=rope_cache)
    current = []
    for li, lyr in enumerate(qparams["layers"]):
        x, kv = layer(lyr, li, cfg, x, cache, step, ops)
        if kv is not None:
            current.append(kv)
    end(cache, step, current)
    return head(qparams, cfg, x, ops), cache


__all__ = ["LlamaConfig", "init_params", "quantize_params", "init_qparams",
           "rope_for", "SplitLinear", "KVCache", "Step", "begin", "layer",
           "end", "head", "forward", "FLASH_PREFILL_T_MIN"]
