"""Carry quantized weights and KV caches across from the JAX package.

:func:`cache_from_jax` turns a JAX ``KVCache`` given as numpy arrays into
the port's :class:`~quant_gemm_tpu_torch.models.llama.KVCache`, so that a
test can start both forwards from the same cache.

:func:`qparams_from_jax` takes the parameters of the JAX package's
``llama.quantize_params`` (q4_0, q4_k, q6_k, ...; with a qwen2-family
``bqkv``) or ``gguf_loader.load_llama`` (an IQ4_XS file's ``iq4_xs``
weights too) with every array as numpy (for example
``jax.tree_util.tree_map(np.asarray, qparams)``, which keeps each
``PreparedWeight``, ``PreparedK16``, ``SplitLinear`` and, from JAX's
``lora.attach_lora``, ``LoraLinear`` with numpy planes) and returns the
port's parameters.  It reads only attributes and
arrays, so it needs neither JAX nor the JAX package.

The TPU layout of a per-32 ``PreparedWeight`` (q4_0, q4_1, q5_0, q5_1,
q8_0, q4_k, q5_k) is undone step by step:

* ``packed_t`` int8 ``[K/2 (padded), N (padded)]`` -> transpose, drop
  the N padding, undo the XOR 0x80 ("x8") byte encoding, drop the K
  padding: the planar row-major bytes of the SoA container;
* ``d_t`` (and ``m_t``) ``[K/32 (padded per half), N (padded)]`` float32,
  or int16 holding float16 bits -> transpose, drop the per-half K
  padding: f16 (the effective f32 scale and min for q4_k and q5_k);
* q5's ``qh_t`` uint8 ``[K/8 (padded per half), N (padded)]`` planar
  bits -> transpose, drop the per-half padding (the nibble-packed
  ``qh2_t`` copy is not read);
* q8_0's (and iq4_xs's) ``qs_t`` int8 ``[K (padded), N (padded)]`` and
  its ``d_t`` are padded at the end of K only;
* then the port's own ``layout.prepare``.

A ``PreparedK16``'s ``qs_t`` / ``scp_t`` / ``mp_t`` ``[K (padded) or K/16,
N (padded)]`` are transposed and cropped; the port's layout keeps the
container's planes (f16 ``d`` per 256 and integer ``sc`` per 16, q2_K's
``dmin`` and ``mn``), which JAX keeps only as the products ``scp = d *
sc`` and ``mp = -(dmin * mn)``, so each super-block's products are
factored back (:func:`_factor`): every exact factoring gives K7 the same
products, and the one chosen (the largest integer at the largest
product, ``d`` positive where it can be) is the encoders' own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.blocks import (QK, Q4_0Tensor, Q4_1Tensor, Q5_0Tensor,
                              Q5_1Tensor, Q8_0Tensor)
from ..formats.kquants import EffectiveQ41, EffectiveQ51, EffectiveQ80
from ..kernels import layout
from ..utils import resolve_device
from .llama import KVCache, SplitLinear
from .lora import LoraDelta, LoraLinear


def planar_from_jax(pw):
    """The planar container (numpy) behind a JAX per-32 ``PreparedWeight``
    whose planes are numpy arrays: a ``Q4_0Tensor``, ``Q4_1Tensor``,
    ``Q5_0Tensor``, ``Q5_1Tensor`` or ``Q8_0Tensor`` (f16 scales), or an
    ``EffectiveQ41`` for q4_k or ``EffectiveQ51`` for q5_k (f32 ``d`` and
    ``m``)."""
    if pw.qtype not in layout.QTYPES:
        raise NotImplementedError(f"{pw.qtype} weights are not ported "
                                  f"(per-32: {', '.join(layout.QTYPES)})")
    n, k = int(pw.n), int(pw.k)
    dtype = np.float32 if pw.qtype in layout.F32_PLANES else np.float16

    def scales(x_t, halves=True):
        x_t = np.asarray(x_t)
        x = (x_t.view(np.float16) if x_t.dtype == np.int16 else x_t)
        x = x.astype(dtype).T[:n]
        return np.ascontiguousarray(unpad(x, k // QK) if halves
                                    else x[:, :k // QK])

    def unpad(x, cols):
        """Drop the padding after each K half of a [N, padded] plane."""
        half_p = x.shape[1] // 2
        out = np.concatenate([x[:, :cols // 2], x[:, half_p:half_p
                                                  + cols // 2]], axis=1)
        assert out.shape == (n, cols)
        return out

    if pw.qtype in layout.INT8_CODES:
        qs = np.ascontiguousarray(np.asarray(pw.qs_t).T[:n, :k])
        cls = Q8_0Tensor if pw.qtype == "q8_0" else EffectiveQ80
        return cls(qs.astype(np.int8), scales(pw.d_t, halves=False))
    packed_t = np.asarray(pw.packed_t)
    packed = (packed_t.view(np.uint8).T[:n, :k // 2] ^ 0x80).astype(np.uint8)
    packed = np.ascontiguousarray(packed)
    d = scales(pw.d_t)
    if pw.qtype == "q4_0":
        return Q4_0Tensor(packed, d)
    if pw.qtype == "q4_k":
        return EffectiveQ41(packed, d, scales(pw.m_t))
    if pw.qtype == "q4_1":
        return Q4_1Tensor(packed, d, scales(pw.m_t))
    qh = np.ascontiguousarray(unpad(np.asarray(pw.qh_t).T[:n], k // 8))
    if pw.qtype == "q5_0":
        return Q5_0Tensor(packed, qh, d)
    if pw.qtype == "q5_k":
        return EffectiveQ51(packed, qh, d, scales(pw.m_t))
    return Q5_1Tensor(packed, qh, d, scales(pw.m_t))


#: the integer range of each per-16 format's sub-scales (q2_K's mins too)
K16_SCALES = {"q6_k": (-128, 127), "q3_k": (-32, 31), "q2_k": (0, 15)}


def _factor(p: torch.Tensor, lo: int, hi: int):
    """float32 products ``p`` [N, nsb, 16] (16 per super-block) -> f16
    ``d`` [N, nsb] and int8 ``s`` [N, nsb, 16] in [lo, hi] with ``d * s ==
    p`` in float32, bit for bit: of the candidates ``d = +-max|p| / j``
    (``j`` from the largest integer down, the positive ``d`` first) the
    first that is an f16 value and gives every ``p / d`` an integer in
    range.  Raises where no candidate does."""
    big = p.abs().amax(-1)
    d = torch.zeros_like(big)
    s = torch.zeros_like(p)
    done = big == 0
    for j in range(max(hi, -lo), 0, -1):
        for sign in (1.0, -1.0):
            cand = big / j * sign
            q = torch.round(p / cand[..., None])
            ok = ((cand.to(torch.float16).to(torch.float32) == cand)
                  & (q * cand[..., None] == p).all(-1)
                  & (q >= lo).all(-1) & (q <= hi).all(-1) & ~done)
            d = torch.where(ok, cand, d)
            s = torch.where(ok[..., None], q, s)
            done = done | ok
    if not bool(done.all()):
        raise ValueError("a per-16 scale plane has no f16 x integer "
                         f"factoring in [{lo}, {hi}]")
    return d.to(torch.float16), s.to(torch.int8)


def _k16_from_jax(pw, dev) -> layout.PreparedK16:
    n, k = int(pw.n), int(pw.k)

    def t(x_t, cols):
        return torch.tensor(np.ascontiguousarray(np.asarray(x_t).T[:n, :cols]),
                            device=dev)

    lo, hi = K16_SCALES[pw.qtype]
    planes = _factor(t(pw.scp_t, k // 16).reshape(n, -1, 16), lo, hi)
    if pw.mp_t is not None:
        planes += _factor(-t(pw.mp_t, k // 16).reshape(n, -1, 16),
                          *K16_SCALES["q2_k"])
    return layout.PreparedK16(pw.qtype, n, k, t(pw.qs_t, k),
                              *(x.reshape(n, -1) for x in planes))


def _prepared(pw, dev):
    """The port's weight for one JAX weight slot: a ``PreparedWeight``,
    ``PreparedK16``, ``SplitLinear`` of them, or a ``LoraLinear`` (JAX's
    ``inner`` and its ``(offset, scale)`` ``meta`` beside the ``(a, b)``
    ``parts``) of one."""
    if hasattr(pw, "meta") and hasattr(pw, "inner"):  # the JAX LoraLinear
        return LoraLinear(_prepared(pw.inner, dev), tuple(
            (int(off), float(scale),
             LoraDelta(*(torch.tensor(np.asarray(x, np.float32), device=dev)
                         for x in (d.a, d.b))))
            for (off, scale), d in zip(pw.meta, pw.parts)))
    if hasattr(pw, "parts"):  # the JAX SplitLinear
        return SplitLinear(tuple(_prepared(p, dev) for p in pw.parts))
    if hasattr(pw, "scp_t"):  # the JAX PreparedK16
        return _k16_from_jax(pw, dev)
    p = planar_from_jax(pw)
    return layout.prepare(type(p)(*(torch.tensor(x, device=dev) for x in p)))


def qparams_from_jax(np_qparams: dict, device="cuda") -> dict:
    """Port parameters from the JAX ``quantize_params`` or ``load_llama``
    output (numpy)."""
    dev = resolve_device(device)

    def f32(x):  # a copy: arrays from JAX are read-only
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    embed = np.asarray(np_qparams["embed"])  # bf16 (ml_dtypes) in JAX
    out = {"embed": f32(embed.astype(np.float32)).to(torch.bfloat16),
           "final_norm": f32(np_qparams["final_norm"]), "layers": []}
    for lyr in np_qparams["layers"]:
        q = {k: f32(v) for k, v in lyr.items() if k.endswith("norm")}
        if "bqkv" in lyr:  # the qwen2 family's QKV bias, float32 [N]
            q["bqkv"] = f32(lyr["bqkv"])
        for name in ("wqkv", "wo", "wgu", "w_down"):
            q[name] = _prepared(lyr[name], dev)
        out["layers"].append(q)
    out["lm_head"] = _prepared(np_qparams["lm_head"], dev)
    if np_qparams.get("rope_inv_freq") is not None:
        out["rope_inv_freq"] = f32(np_qparams["rope_inv_freq"])
    return out


def cache_from_jax(cache, device="cuda", ring: int = 0) -> KVCache:
    """The port's cache from a JAX ``KVCache`` whose arrays are numpy
    (for example ``jax.tree_util.tree_map(np.asarray, cache)``): ``k``/``v``
    bf16 (ml_dtypes) or int8, ``pos`` int32 and, for the q8 cache,
    ``ks``/``vs`` float32; values are carried over exactly.

    ``ring=R`` (``cfg.ring_capacity``) takes a JAX ring cache: its first R
    slots, the ring itself after JAX folded its write margin back onto the
    ring's head; the margin is dropped (the port's ring has none)."""
    dev = resolve_device(device)
    r = slice(0, ring or None)

    def t(x, dtype):  # a copy: arrays from JAX are read-only
        x = np.asarray(x)
        if dtype == torch.bfloat16:  # numpy has no bf16: widen exactly
            return torch.tensor(x.astype(np.float32), device=dev).to(dtype)
        return torch.tensor(x, dtype=dtype, device=dev)

    k = np.asarray(cache.k)
    kv = torch.int8 if k.dtype == np.int8 else torch.bfloat16
    scales = ()
    if getattr(cache, "ks", None) is not None:
        scales = (t(np.asarray(cache.ks)[..., r], torch.float32),
                  t(np.asarray(cache.vs)[..., r], torch.float32))
    return KVCache(t(k[..., r, :], kv), t(np.asarray(cache.v)[..., r, :], kv),
                   t(cache.pos, torch.int32), *scales)


__all__ = ["planar_from_jax", "qparams_from_jax", "cache_from_jax"]
