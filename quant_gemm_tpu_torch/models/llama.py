"""Quantized Llama forward for the serving slice (W4A8).

Counterpart of ``quant_gemm_tpu/models/llama.py`` for what the serving
slice runs, with the bf16 or the int8 (``q8``) KV cache, an optional
sliding window, and with a window the ring cache (``cfg.ring``: O(window)
slots, token g at slot ``g % R``) or the linear cache's context shift
(:func:`shift_context`).  Weights are any format of the JAX package's
``quantize_params`` (:func:`quantize_params`: q4_0, q4_1, q5_0, q5_1,
q8_0, q4_k / q5_k in their effective q4_1 / q5_1 form, and the per-16
q6_k, q3_k, q2_k), q4_0 or q8_0 drawn on the device
(:func:`init_qparams`), or the mix of a llama.cpp GGUF file
(``models/gguf_loader.py``: Q8_0, Q5_0, Q4_1, Q5_1, Q4_K_M, Q5_K_M, ...),
with a :class:`SplitLinear` where the parts of ``wqkv`` or ``wgu`` differ
in format, and the qwen2 family's QKV bias (a layer's float32 ``bqkv``,
added to the ``wqkv`` product before RoPE on every route, as JAX adds it,
``llama.py:648-653``):

* decode (T = 1): RMSNorm + Q8_1 + ``wqkv`` through K2 (``norm_qkv``) when
  the batch is <= 8, ``dim % 512 == 0`` and every layer's ``wqkv`` is one
  weight in a K2 form (``gemm_megalayer.QKV_QTYPES``: q4_0, q4_1, q4_k,
  q5_0, q5_1, q5_k; not q8_0, a per-16 weight or a :class:`SplitLinear`,
  as in JAX), otherwise RMSNorm then the dispatched GEMM; RoPE; K3
  (``flash_decode``) over the stacked cache with the current token's k/v
  (bf16, with either cache) as operands; K1 GEMMs for ``wo``, ``wgu``,
  ``w_down`` and ``lm_head``; the cache write (with the q8 cache: codes
  and scales) deferred to one all-layer insert after the layer loop;
  per-16 weights take K7 (``gemm_exact_k16``) instead of K1; with
  ``registry.FUSED_DECODE`` the per-32 decode GEMMs without a qh plane
  (q4_0, q4_1, q4_k, q8_0) take K6 (``gemm_exact_fused``, bit-identical
  to quantize + K1), and with
  ``gemm_megalayer.ENABLE_TAIL`` everything after attention (``wo`` to
  the second residual) is one K8 (``attn_tail``) launch when every layer
  is ``tail_supported`` (q4_0, batch <= 8) — both switches off by
  default, as in the JAX package;
* prefill (T > 1): the cache written per layer, then attention: K5
  (``flash_prefill``) at T >= 64, as the JAX package routes it, and below
  that dense masked attention in float32 (plain torch, as the JAX package
  leaves it to XLA); K4 for GEMMs of more than ``DECODE_M_MAX`` rows, and
  the plain float32 matmul for per-16 weights there.

Activation modes (``act_mode``, JAX ``_linear``): ``"q8_1"`` (W4A8, the
routes above), ``"bf16"`` (W4A16: every GEMM takes its activation in
bf16 through ``registry.dispatch``, K4 at every M for per-32 weights and
the plain float32 matmul ``k16_dequant_gemm`` for per-16 ones; K2 and K8
off) and ``"float"`` (:func:`forward_float`'s float32 weights, each
product a :class:`_FloatLinear` ``torch.matmul`` with TF32 off, as JAX's
``Precision.HIGHEST`` ``dot`` outside any kernel).  ``cfg.w_down_a16``
runs the down projection as ``"bf16"`` in the ``"q8_1"`` mode, unless K8
serves it.  A :class:`~.lora.LoraLinear` adds its low-rank deltas to its
base weight's product (float32 ``torch.matmul``, JAX ``lora.py:66-73``).
:func:`greedy_decode` and :func:`sample_decode` prefill a prompt and
decode through the same forward.  :func:`embed` pools the final-norm
hidden states into sequence embeddings (JAX ``embed``).

:func:`forward` is :func:`begin`, :func:`layer` for each layer, :func:`end`
and :func:`head`; a check can call the pieces to run the kernels and the
plain versions from the same hidden state at every layer.  The head runs
on every row by default; a caller that reads fewer rows names them
(``out_rows``), and the final norm and ``lm_head`` run on those alone, as
llama.cpp's ``inp_out_ids`` selects the output rows before its
``result_norm`` and ``result_output``: the Server reads one row of a
prompt's last chunk and none of the others, and the head (Qwen's tied
[151936, 1536] q6_K, dequantized in float32 at prefill) is the widest
GEMM of a chunk.  With
``tp_ctx`` (a reduce over the ranks, ``llama_tp.tp_context``) and the
rank's local config the same loop runs one rank of Megatron tensor
parallelism: the rank's heads, KV heads and FFN features on its weight
shards, the row-parallel outputs summed over the ranks, K8 off (JAX
``llama.py:508-533``, ``:637``).

Layouts follow the JAX package: weights ``[N, K]``, cache ``[L, B, KV, S,
hd]`` (q8 scales ``[L, B, KV, S]``), grouped decode queries ``[B, KV, rep,
hd]``, prefill queries ``[B, KV, T*rep, hd]`` in T-major rows.  Unlike
JAX, the cache is updated in place (saving a full copy of the cache per
step); :func:`forward` returns the same :class:`KVCache` object.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..formats import kquants
from ..formats.quant import QUANTIZE
from ..kernels import gemm_megalayer, layout, registry
from ..ops.activations import silu_mul
from ..ops.rms_norm import rms_norm
from ..ops.rope import apply_rope, rope_cache as make_rope_cache
from ..utils import matmul_f32, resolve_device
from .lora import LoraLinear, apply_lora

FLASH_PREFILL_T_MIN = 64  # prefill chunks from this length take K5


class LlamaConfig(NamedTuple):
    """The JAX ``LlamaConfig``'s fields.  ``ring`` (needs ``window > 0``)
    makes the KV cache a ring of :attr:`ring_capacity` slots, and bounds
    every forward call at ``ring_chunk`` tokens; ``w_down_a16`` runs the
    down projection on bf16 activations in the ``"q8_1"`` mode."""

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

    @property
    def ring_capacity(self) -> int:
        """Ring slots R (the JAX ``ring_capacity``): token g lives at slot
        g % R.  R >= window + ring_chunk, so a full chunk never overwrites
        a slot its own rows still attend, rounded up to 512 (128 for rings
        of at most 512)."""
        if not (self.ring and self.window > 0):
            raise ValueError("ring_capacity needs ring=True and window > 0")
        r = self.window + self.ring_chunk
        align = 512 if r > 512 else 128
        return (r + align - 1) // align * align


def check_config(cfg: LlamaConfig) -> None:
    if cfg.window < 0:
        raise ValueError(f"window must be >= 0, got {cfg.window}")
    if cfg.ring and cfg.window <= 0:
        raise ValueError("the ring cache needs a sliding window (window > "
                         "0)")


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


#: the per-16 K-quants :func:`quantize_params` takes, and their encoders
_K16_ENCODERS = {"q6_k": kquants.quantize_q6_k, "q3_k": kquants.quantize_q3_k,
                 "q2_k": kquants.quantize_q2_k}
#: the K-quants served in their effective per-32 form
_EFFECTIVE = {"q4_k": (kquants.quantize_q4_k, kquants.to_effective),
              "q5_k": (kquants.quantize_q5_k, kquants.to_effective_q5_k)}
#: every weight format :func:`quantize_params` takes (the JAX package's)
QPARAM_QTYPES = ("q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "q4_k", "q5_k",
                 "q6_k", "q3_k", "q2_k")


def _on(container, dev):
    return type(container)(*(t.to(dev) for t in container))


def _preparer(qtype: str, dev: torch.device):
    """float32 numpy [N, K] -> the kernel weight of ``qtype`` on ``dev``:
    the per-32 formats through the torch quantizers on ``dev``, the
    K-quants through their numpy encoders (as in the JAX package; q4_k and
    q5_k then in their effective per-32 form, the per-16 ones through
    ``layout.prepare_k16``)."""
    if qtype in _K16_ENCODERS:
        enc = _K16_ENCODERS[qtype]
        return lambda w: layout.prepare_k16(_on(enc(w), dev))
    if qtype in _EFFECTIVE:
        enc, eff = _EFFECTIVE[qtype]
        return lambda w: layout.prepare(eff(_on(enc(w), dev)))
    if qtype in layout.QTYPES:
        quantize = QUANTIZE[qtype]
        return lambda w: layout.prepare(quantize(torch.as_tensor(w,
                                                                 device=dev)))
    raise NotImplementedError(f"quantize_params takes "
                              f"{', '.join(QPARAM_QTYPES)}, not {qtype}")


def quantize_params(params: dict, qtype: str = "q4_0",
                    device="cuda") -> dict:
    """Quantize every linear to ``qtype`` (:data:`QPARAM_QTYPES`, the JAX
    ``quantize_params``'s) on ``device``, fusing ``wqkv`` and ``wgu`` as
    the JAX package does (block quantization is row-local, so the
    concatenation quantizes bit-identically to its parts).  The embedding
    stays bf16, the norms float32; a layer with the qwen2 family's
    ``bq``/``bk``/``bv`` gets their float32 concatenation ``bqkv``."""
    dev = resolve_device(device)
    prep = _preparer(qtype, dev)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def lin(*parts):
        return prep(np.concatenate([np.asarray(p, np.float32)
                                    for p in parts], axis=0))

    out = {"embed": f32(params["embed"]).to(torch.bfloat16),
           "final_norm": f32(params["final_norm"]), "layers": []}
    for lyr in params["layers"]:
        q = {k: f32(v) for k, v in lyr.items() if k.endswith("norm")}
        if "bq" in lyr:  # the qwen2 family's QKV bias (stays float)
            q["bqkv"] = torch.cat([f32(lyr[b]).reshape(-1)
                                   for b in ("bq", "bk", "bv")])
        q["wqkv"] = lin(lyr["wq"], lyr["wk"], lyr["wv"])
        q["wo"] = lin(lyr["wo"])
        q["wgu"] = lin(lyr["w_gate"], lyr["w_up"])
        q["w_down"] = lin(lyr["w_down"])
        out["layers"].append(q)
    out["lm_head"] = lin(params["lm_head"])
    return out


def init_qparams(cfg: LlamaConfig, seed: int = 0, device="cuda",
                 qtype: str = "q4_0") -> dict:
    """Random q4_0 or q8_0 model drawn and quantized entirely on
    ``device`` from a ``torch.Generator`` seed (the JAX
    ``init_qparams_device``, which takes the same two formats): the same
    shapes as :func:`quantize_params` output, other weight values."""
    if qtype not in ("q4_0", "q8_0"):
        raise NotImplementedError(f"init_qparams draws q4_0 or q8_0 "
                                  f"weights, as in JAX, not {qtype}")
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    quantize = QUANTIZE[qtype]

    def lin(n, k):
        return layout.prepare(quantize(
            torch.randn(n, k, generator=g, device=dev) * (1.0 / k ** 0.5)))

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
    scores and to the softmax weights, never to the codes.

    With ``cfg.ring`` the cache holds S = ``cfg.ring_capacity`` slots,
    token g at slot ``g % S``, whatever ``max_seq`` is.  The JAX cache
    has ``ring_chunk`` more slots, a write margin that its static-size
    ``dynamic_update_slice`` spills into and folds back from; the port
    writes in place through index tensors, ``(pos0 + arange(T)) % S``,
    and needs none."""

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
        slots = cfg.ring_capacity if cfg.ring else cfg.max_seq
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, slots, cfg.head_dim)
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

    def buffers(self) -> list:
        """The k, v (and q8 scale) tensors."""
        return [t for t in (self.k, self.v, self.ks, self.vs)
                if t is not None]

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


def shift_context(cache: KVCache, cfg: LlamaConfig, keep: int,
                  rope_cache=None, trigger: Optional[int] = None) -> KVCache:
    """llama.cpp's context shift (the JAX ``shift_context``), in place:
    each slot at ``pos >= trigger`` (default ``max_seq - 1``) keeps its
    newest ``keep`` tokens, moved to slots 0..keep-1, and ``pos`` falls by
    the ``delta = max(pos - keep, 0)`` tokens dropped.  RoPE rotates a
    key pair by theta(pos), so rotating every kept key back by
    theta(delta) re-positions them all at once; values only move.  The q8
    cache dequantizes, rotates and requantizes the kept keys
    (:func:`_quant_kv`; a rotation mixes lanes, so the scales change).

    Step for step as JAX: every slot is rewritten, a slot below the
    trigger with delta 0 (its rows rotated by theta(0), q8 keys
    requantized); the slab start clamps to ``[0, S - keep]`` as
    ``dynamic_slice`` clamps it.  With a window and ``keep >= window``
    the attention set of the next step is unchanged.  Pass the model's
    ``rope_cache`` (``rope_for(cfg, qparams)``) when a loader attached
    its own spectrum.  Returns the same cache.  Ring caches do not shift
    (the slot of token g is ``g % R``): raises."""
    if cfg.ring:
        raise ValueError("context shift is for linear caches, not the ring")
    _, b, _, smax, hd = cache.k.shape
    if not 0 < keep <= smax:
        raise ValueError(f"keep must be in 1..{smax}, got {keep}")
    dev = cache.k.device
    if rope_cache is None:
        rope_cache = rope_for(cfg, device=dev)
    if trigger is None:
        trigger = cfg.max_seq - 1
    cos_t, sin_t = rope_cache
    pos = cache.pos.to(torch.int64)
    delta = torch.where(pos >= trigger, (pos - keep).clamp(min=0),
                        torch.zeros_like(pos))
    start = delta.clamp(max=smax - keep).tolist()
    # theta(delta): a position past the table clamps, as a JAX gather
    rows = delta.clamp(max=cos_t.shape[0] - 1)
    for bb in range(b):
        kept = slice(start[bb], start[bb] + keep)
        x = cache.k[:, bb, :, kept].to(torch.float32)
        if cache.quantized:
            x = x * cache.ks[:, bb, :, kept][..., None]
        cos, sin = cos_t[rows[bb]], sin_t[rows[bb]]
        x0, x1 = x[..., : hd // 2], x[..., hd // 2:]
        x = torch.cat([x0 * cos + x1 * sin, -x0 * sin + x1 * cos], dim=-1)
        # clone: the kept rows and their destination overlap
        v = cache.v[:, bb, :, kept].clone()
        if cache.quantized:
            codes, scale = _quant_kv(x)
            vscale = cache.vs[:, bb, :, kept].clone()
            cache.k[:, bb, :, :keep] = codes
            cache.ks[:, bb, :, :keep] = scale
            cache.vs[:, bb, :, :keep] = vscale
        else:
            cache.k[:, bb, :, :keep] = x.to(cache.k.dtype)
        cache.v[:, bb, :, :keep] = v
    # in place: a captured decode step reads this storage
    cache.pos.copy_(pos - delta)
    return cache


ACT_MODES = ("q8_1", "bf16", "float")


class _FloatLinear(NamedTuple):
    """A float32 weight [N, K] of :func:`forward_float` (JAX
    ``_FloatLinear``)."""

    w: torch.Tensor


def _linear(w, x: torch.Tensor, ops, act_mode: str = "q8_1",
            route_m: Optional[int] = None) -> torch.Tensor:
    """y[M, N] = x[M, K] @ W^T in ``act_mode`` (JAX ``_linear``):
    ``"q8_1"`` quantizes x to Q8_1 in dispatch (W4A8), ``"bf16"`` hands
    dispatch x in bf16 (W4A16), a :class:`_FloatLinear` is a float32
    matmul; a :class:`SplitLinear` runs one GEMM per part, concatenated on
    N; a :class:`~.lora.LoraLinear` adds its deltas to its base's
    product.  ``route_m``: the row count that picks dispatch's route
    (default: M)."""
    if isinstance(w, _FloatLinear):
        return matmul_f32(x, w.w)
    if isinstance(w, LoraLinear):
        return apply_lora(w, _linear(w.inner, x, ops, act_mode, route_m), x)
    if isinstance(w, SplitLinear):
        return torch.cat([_linear(p, x, ops, act_mode, route_m)
                          for p in w.parts], dim=-1)
    if act_mode == "q8_1":
        return registry.dispatch(w, x.to(torch.float32), quantize_act=True,
                                 ops=ops, route_m=route_m)
    return registry.dispatch(w, x.to(torch.bfloat16), ops=ops,
                             route_m=route_m)


def _attention(cfg: LlamaConfig, q, k_all, v_all, positions, ks=None,
               vs=None):
    """Dense causal attention in float32 (the JAX CPU numerics), the
    prefill path below ``FLASH_PREFILL_T_MIN``.

    q: [B, T, H, hd]; k_all/v_all: [B, KV, S, hd] (the layer's full
    cache, current chunk already written); ks/vs: [B, KV, S] int8-cache
    scales or None; positions: [B, T] — the query at position p attends
    the cached tokens at positions <= p (and > p - window): slot = position
    in a linear cache; in a ring, slot r holds the position ``g = p_cache
    - (p_cache - r) mod R`` with ``p_cache`` the call's newest token
    (``llama.py:477-484``)."""
    b, tq, h, hd = q.shape
    kv, s = k_all.shape[1], k_all.shape[2]
    qg = q.reshape(b, tq, kv, h // kv, hd).to(torch.float32)
    scores = torch.einsum("btgrd,bgsd->bgrts", qg, k_all.to(torch.float32)) \
        / float(np.float32(np.sqrt(hd)))
    if ks is not None:  # int8 cache: the k scale factors out of the hd dot
        scores = scores * ks[:, :, None, None, :]
    span = torch.arange(s, device=q.device)[None, None, :]
    qpos = positions[:, :, None]
    if cfg.ring:
        ring = cfg.ring_capacity
        p_cache = positions[:, -1][:, None, None]
        g = p_cache - torch.remainder(p_cache - span, ring)
        mask = ((g <= qpos) & (g >= 0) & (g > qpos - cfg.window)
                & (span < ring))
    else:
        mask = span <= qpos  # [B, T, S]
        if cfg.window:
            mask = mask & (span > qpos - cfg.window)
    scores = torch.where(mask[:, None, None], scores,
                         torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    if vs is not None:  # the v scale folds into the softmax weights
        probs = probs * vs[:, :, None, None, :]
    out = torch.einsum("bgrts,bgsd->btgrd", probs, v_all.to(torch.float32))
    return out.reshape(b, tq, h * hd)


class Step(NamedTuple):
    """What every layer of one forward call shares: each slot's token
    positions [B, T], the cache rows its tokens are written to [B, T], the
    rope tables, whether decode takes K2 (``norm_qkv``) and K8
    (``attn_tail``), the ring's slot count R (0: a linear cache), the
    caller's static bound ``s_hi`` on every active slot's position (None:
    no bound; it only shapes K3's grid, ``attention.decode_s_hi``), the
    activation mode, and under tensor parallelism the reduce of the
    row-parallel outputs over the ranks (None on one device)."""

    positions: torch.Tensor
    widx: torch.Tensor
    rope_cache: tuple
    use_mega: bool
    use_mega_tail: bool
    ring: int
    s_hi: Optional[int] = None
    act_mode: str = "q8_1"
    tp: Optional[Callable] = None


def routes(qparams: dict, cfg: LlamaConfig, b: int, t: int,
           act_mode: str = "q8_1", tp_ctx=None):
    """``(use_mega, use_mega_tail)`` of a call of ``t`` tokens for ``b``
    slots: K2 (``norm_qkv``) on every layer or on none, as in JAX
    (``gemm_megalayer.qkv_supported``: its ``ENABLE_QKV`` switch, and a
    q8_0, per-16, SplitLinear or LoRA'd wqkv anywhere turns it off for
    the whole model), and K8 (``attn_tail``) when every layer is
    ``tail_supported`` (which reads ``gemm_megalayer.ENABLE_TAIL``; a
    LoRA'd ``wo``, ``wgu`` or ``w_down`` is not); both only at decode (t
    = 1) in the ``"q8_1"`` mode (JAX ``can_mega``).  Under tensor
    parallelism (``tp_ctx``) K2 serves the rank's column-parallel
    ``wqkv`` shard and K8 is off: its chain crosses the row-parallel sums
    (JAX ``llama.py:637``)."""
    can_mega = act_mode == "q8_1" and t == 1
    use_mega = can_mega and all(
        gemm_megalayer.qkv_supported(ly, cfg, b) for ly in qparams["layers"])
    use_mega_tail = can_mega and tp_ctx is None and all(
        gemm_megalayer.tail_supported(ly, cfg, b) for ly in qparams["layers"])
    return use_mega, use_mega_tail


def begin(qparams: dict, cfg: LlamaConfig, tokens: torch.Tensor,
          cache: KVCache, *, act_mode: str = "q8_1", rope_cache=None,
          s_hi: Optional[int] = None, route=None, tp_ctx=None):
    """Check a call of T tokens per slot and embed them: returns the
    float32 hidden state [B, T, D] and the call's :class:`Step`.
    ``route``: :func:`routes` of the call, when the caller decided it
    once (the Server, per graph); None walks the layers here.
    ``tp_ctx``: under tensor parallelism, the reduce of the row-parallel
    outputs over the ranks (``cfg`` is then the rank's, with its local
    head, KV head and FFN widths: ``llama_tp.tp_context``)."""
    check_config(cfg)
    if act_mode not in ACT_MODES:
        raise ValueError(f"act_mode must be one of {ACT_MODES}, not "
                         f"{act_mode!r}")
    b, t = tokens.shape
    if cfg.ring and t > cfg.ring_chunk:
        raise ValueError(f"a ring cache takes at most ring_chunk = "
                         f"{cfg.ring_chunk} tokens per call, got {t}")
    dev = cache.k.device
    if rope_cache is None:
        rope_cache = rope_for(cfg, qparams, dev)
    pos0 = cache.pos.to(torch.int64)
    rows = torch.arange(t, device=dev)[None, :]
    positions = pos0[:, None] + rows
    ring = cfg.ring_capacity if cfg.ring else 0
    if ring:
        widx = torch.remainder(positions, ring)  # token g at slot g % R
    else:
        # a cache write starts at pos, clamped so the T-row update fits
        # (the start clamp of JAX's dynamic_update_slice, which overflowing
        # and inactive slots rely on)
        widx = pos0.clamp(0, cache.k.shape[3] - t)[:, None] + rows
    use_mega, use_mega_tail = route or routes(qparams, cfg, b, t, act_mode,
                                              tp_ctx)
    x = qparams["embed"][tokens.to(dev)].to(torch.float32)
    return x, Step(positions, widx, rope_cache, use_mega, use_mega_tail,
                   ring, s_hi, act_mode, tp_ctx)


def layer(lyr: dict, li: int, cfg: LlamaConfig, x: torch.Tensor,
          cache: KVCache, step: Step, ops: registry.Ops = registry.KERNELS):
    """Decoder layer ``li`` on the hidden state x [B, T, D].  Returns the
    new hidden state and, at decode, what :func:`end` inserts for the
    current token: its (k, v) [B, KV, hd] bf16, or with the q8 cache its
    (k codes, v codes, k scales, v scales); prefill writes the cache
    here.  Under tensor parallelism (``step.tp``) ``cfg`` is the rank's:
    the layer runs its heads, KV heads and FFN features on its weight
    shards, and sums the row-parallel ``wo`` and ``w_down`` outputs over
    the ranks (JAX ``llama.py:525-533``)."""
    b, t, _ = x.shape
    heads, kv_heads, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    nq, nkv, rep = heads * hd, kv_heads * hd, heads // kv_heads
    mode = step.act_mode
    if step.use_mega:
        qkv = ops.norm_qkv(lyr["wqkv"], x.reshape(b * t, cfg.dim),
                           lyr["attn_norm"], cfg.eps)
    else:
        h = rms_norm(x, lyr["attn_norm"], cfg.eps)
        qkv = _linear(lyr["wqkv"], h.reshape(b * t, cfg.dim), ops, mode)
    if "bqkv" in lyr:  # the qwen2 family's QKV bias, on every route
        qkv = qkv + lyr["bqkv"]
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
            ring=step.ring, s_hi=step.s_hi, **scales).reshape(b, t, nq)
    else:
        bidx = torch.arange(b, device=x.device)[:, None]
        idx = step.widx
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
                window=cfg.window, ring=step.ring, layer=li, **scales)
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
    o = _linear(lyr["wo"], attn.reshape(b * t, nq), ops, mode)
    if step.tp is not None:
        o = step.tp(o)
    x = x + o.reshape(b, t, cfg.dim)
    h = rms_norm(x, lyr["mlp_norm"], cfg.eps)
    gu = _linear(lyr["wgu"], h.reshape(b * t, cfg.dim), ops, mode)
    ff = silu_mul(gu[:, :cfg.d_ff], gu[:, cfg.d_ff:])
    # the opt-in W4A16 down projection (JAX llama.py:713-714)
    dn_mode = "bf16" if cfg.w_down_a16 and mode == "q8_1" else mode
    dn = _linear(lyr["w_down"], ff, ops, dn_mode)
    if step.tp is not None:
        dn = step.tp(dn)
    return x + dn.reshape(b, t, cfg.dim), current


def end(cache: KVCache, step: Step, current: list) -> None:
    """Insert decode's current tokens of every layer (``current``: what
    :func:`layer` returned for each layer) and advance ``cache.pos``."""
    if current:
        # one insert per buffer covers every layer: k[:, bidx, :, row] is
        # the [B, L, KV, hd] view of each slot's write row (ks: [B, L, KV])
        bidx = torch.arange(cache.k.shape[1], device=cache.k.device)
        row = step.widx[:, 0]
        bufs = (cache.k, cache.v, cache.ks, cache.vs)
        for buf, vals in zip(bufs, zip(*current)):
            buf[:, bidx, :, row] = torch.stack(vals).transpose(0, 1)
    # in place, so that a CUDA graph of the step reads and writes the same
    # storage on every replay
    cache.pos.copy_(step.positions[:, -1] + 1)


def head(qparams: dict, cfg: LlamaConfig, x: torch.Tensor,
         ops: registry.Ops = registry.KERNELS, act_mode: str = "q8_1",
         rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Final norm and ``lm_head`` over the rows whose logits the caller
    reads: every row of x [B, T, D] (``rows`` None; logits [B, T, vocab]
    float32), or the rows ``rows`` (int64 [B, R]) names in each slot,
    gathered before the norm as llama.cpp's ``inp_out_ids`` selects them
    (logits [B, R, vocab]); R = 0 runs neither the norm nor the head.
    Gathered rows keep the route of the call's B * T rows (a prefill
    chunk's: the per-16 weights' float32 matmul, K4 on the per-32 ones),
    so each row's numerics are those of the full call."""
    b, t, d = x.shape
    if rows is not None:
        if rows.shape[1] == 0:
            return x.new_empty((b, 0, cfg.vocab))
        x = torch.gather(x, 1, rows[:, :, None].expand(-1, -1, d))
    r = x.shape[1]
    x = rms_norm(x, qparams["final_norm"], cfg.eps)
    logits = _linear(qparams["lm_head"], x.reshape(b * r, d), ops, act_mode,
                     route_m=b * t)
    return logits.reshape(b, r, -1)


def forward(qparams: dict, cfg: LlamaConfig, tokens: torch.Tensor,
            cache: KVCache, *, act_mode: str = "q8_1", rope_cache=None,
            ops: registry.Ops = registry.KERNELS,
            s_hi: Optional[int] = None, route=None, tp_ctx=None,
            out_rows: Optional[torch.Tensor] = None):
    """Run T tokens per slot (prefill when T > 1, decode when T = 1).

    Slots advance independently by their own ``cache.pos``.  Returns
    (logits [B, T, vocab] float32, cache), the cache updated in place.
    ``out_rows`` (int64 [B, R]): the rows whose logits the caller reads;
    the final norm and the head run on those alone (:func:`head`) and the
    logits are [B, R, vocab], none at R = 0.  The layers and the cache
    writes do not depend on it.
    ``ops`` selects the kernels (default) or, on purpose, their plain
    versions (``registry.PLAIN``).  ``s_hi``: every active slot's
    position is below it (JAX's ``attn_s_hi``; decode only).  ``route``:
    :func:`routes`, decided once by the caller (default: here).
    ``tp_ctx``: the reduce over the ranks with which, given the rank's
    config, the same loop runs one rank of Megatron tensor parallelism on
    its shards and its share of the cache (``llama_tp.forward_tp``)."""
    x, step = begin(qparams, cfg, tokens, cache, act_mode=act_mode,
                    rope_cache=rope_cache, s_hi=s_hi, route=route,
                    tp_ctx=tp_ctx)
    current = []
    for li, lyr in enumerate(qparams["layers"]):
        x, kv = layer(lyr, li, cfg, x, cache, step, ops)
        if kv is not None:
            current.append(kv)
    end(cache, step, current)
    return head(qparams, cfg, x, ops, act_mode, out_rows), cache


def float_params(params: dict, device="cuda") -> dict:
    """:func:`init_params`-style float32 parameters (numpy or tensors) on
    ``device`` in the quantized layout, each linear a
    :class:`_FloatLinear` (``wqkv`` and ``wgu`` fused, the qwen2 family's
    ``bqkv`` concatenated), the embedding float32: what JAX's
    ``forward_float`` builds."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32) if not isinstance(
            x, torch.Tensor) else x, dtype=torch.float32, device=dev)

    def lin(*parts):
        return _FloatLinear(torch.cat([f32(p) for p in parts], dim=0))

    layers = []
    for lyr in params["layers"]:
        q = {k: f32(v) for k, v in lyr.items() if k.endswith("norm")}
        if "bq" in lyr:
            q["bqkv"] = torch.cat([f32(lyr[b]).reshape(-1)
                                   for b in ("bq", "bk", "bv")])
        q["wqkv"] = lin(lyr["wq"], lyr["wk"], lyr["wv"])
        q["wo"] = lin(lyr["wo"])
        q["wgu"] = lin(lyr["w_gate"], lyr["w_up"])
        q["w_down"] = lin(lyr["w_down"])
        layers.append(q)
    out = {"embed": f32(params["embed"]),
           "final_norm": f32(params["final_norm"]), "layers": layers,
           "lm_head": lin(params["lm_head"])}
    if params.get("rope_inv_freq") is not None:
        out["rope_inv_freq"] = f32(params["rope_inv_freq"])
    return out


def forward_float(params: dict, cfg: LlamaConfig, tokens: torch.Tensor,
                  cache: KVCache):
    """The float32 reference forward (JAX ``forward_float``): the same
    model on unquantized weights, every linear a float32 matmul
    (:func:`float_params`; pass its output to skip the conversion), the
    attention as in :func:`forward`.  Returns (logits, cache)."""
    if not isinstance(params["lm_head"], _FloatLinear):
        params = float_params(params, cache.k.device)
    return forward(params, cfg, tokens, cache, act_mode="float")


def greedy_decode(qparams: dict, cfg: LlamaConfig, prompt, steps: int, *,
                  act_mode: str = "q8_1"):
    """Prefill ``prompt`` [B, T0] then decode ``steps`` tokens greedily
    (JAX ``greedy_decode``), on the device of the parameters, through the
    kernels the Server runs.  Returns (tokens int64 [B, steps], cache)."""
    return _decode(qparams, cfg, prompt, steps, act_mode, None)


def sample_decode(qparams: dict, cfg: LlamaConfig, prompt, steps: int, *,
                  seed=0, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0, act_mode: str = "q8_1"):
    """Prefill then decode ``steps`` sampled tokens (JAX
    ``sample_decode``); the batch shares one temperature / top-k / top-p.
    Row i draws from its own ``torch.Generator`` seeded with ``seed[i]``
    (an int ``seed``: ``seed + i``), as the Server seeds a request with
    its ``seed``, and draws as the Server does, one token a step: a
    request served alone with that seed and the same prompt gets the same
    tokens.  ``temperature <= 0`` is :func:`greedy_decode`.  Returns
    (tokens int64 [B, steps], cache)."""
    b = len(prompt)
    seeds = ([seed + i for i in range(b)] if isinstance(seed, int)
             else [int(x) for x in seed])
    if len(seeds) != b:
        raise ValueError(f"{len(seeds)} seeds for {b} rows")
    sampler = (temperature, top_k, top_p, seeds)
    return _decode(qparams, cfg, prompt, steps, act_mode, sampler)


def _decode(qparams, cfg, prompt, steps, act_mode, sampler):
    from . import sampling

    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    dev = qparams["embed"].device
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int64)
    b = prompt.shape[0]
    cache = KVCache.init(cfg, b, device=dev)
    rc = rope_for(cfg, qparams, dev)
    if sampler is None or sampler[0] <= 0:
        def pick(logits):
            return torch.argmax(logits, dim=-1)
    else:
        temp, top_k, top_p, seeds = sampler
        gens = [torch.Generator(device=dev).manual_seed(s) for s in seeds]
        opts = (np.full(b, temp, np.float32), np.full(b, top_k, np.int64),
                np.full(b, top_p, np.float32))

        def pick(logits):
            return sampling.sample(logits, gens, *opts)
    logits, cache = forward(qparams, cfg, prompt, cache, act_mode=act_mode,
                            rope_cache=rc)
    out = [pick(logits[:, -1])]
    for _ in range(steps - 1):
        logits, cache = forward(qparams, cfg, out[-1][:, None], cache,
                                act_mode=act_mode, rope_cache=rc)
        out.append(pick(logits[:, -1]))
    return torch.stack(out, dim=1), cache


def embed(qparams: dict, cfg: LlamaConfig, tokens: torch.Tensor, *,
          lengths=None, pooling: str = "mean",
          act_mode: str = "q8_1") -> torch.Tensor:
    """Sequence embeddings from the final-norm hidden states (JAX
    ``embed``, the llama.cpp ``--embedding`` surface).

    ``tokens`` [B, T] are prefilled on a fresh cache of T rows per slot
    (the rows a causal prefill of T tokens attends, so the result is the
    JAX one's, which allocates ``max_seq`` of them; a ring cache keeps its
    capacity).  ``lengths`` [B]:
    real token counts when rows are right-padded; pooling masks the pad
    positions: "mean" over the real tokens, "last" the last real token,
    "none" the per-token states [B, T, dim].  Returns float32, "mean" and
    "last" L2-normalised (0 stays 0)."""
    dev = qparams["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    b, t = tokens.shape
    lengths = (torch.full((b,), t, dtype=torch.int64, device=dev)
               if lengths is None
               else torch.as_tensor(lengths, device=dev).to(torch.int64))
    # a linear cache of T rows (a ring keeps its own capacity); the RoPE
    # tables of the model's max_seq
    cache = KVCache.init(cfg if cfg.ring else cfg._replace(max_seq=t), b,
                         device=dev)
    x, step = begin(qparams, cfg, tokens, cache, act_mode=act_mode,
                    rope_cache=rope_for(cfg, qparams, dev))
    for li, lyr in enumerate(qparams["layers"]):
        x, _ = layer(lyr, li, cfg, x, cache, step)
    hidden = rms_norm(x, qparams["final_norm"], cfg.eps)
    if pooling == "none":
        return hidden
    if pooling == "last":
        vec = hidden[torch.arange(b, device=dev), lengths - 1]
    elif pooling == "mean":
        mask = (torch.arange(t, device=dev)[None, :]
                < lengths[:, None]).to(torch.float32)
        vec = (hidden * mask[:, :, None]).sum(dim=1) / torch.clamp(
            lengths[:, None].to(torch.float32), min=1.0)
    else:
        raise ValueError(f"unknown pooling {pooling!r}")
    norm = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    return vec / torch.where(norm > 0, norm, torch.ones_like(norm))


__all__ = ["LlamaConfig", "init_params", "quantize_params", "init_qparams",
           "rope_for", "SplitLinear", "KVCache", "shift_context", "Step",
           "routes", "begin", "layer", "end", "head", "forward", "embed",
           "float_params", "forward_float", "greedy_decode", "sample_decode",
           "ACT_MODES", "FLASH_PREFILL_T_MIN"]
