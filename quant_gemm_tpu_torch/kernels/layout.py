"""The port's device weight layouts (counterparts of the JAX package's
``gemm_pallas.PreparedWeight`` / ``prepare`` and ``gemm_exact.PreparedK16``
/ ``prepare_k16``).

The TPU layouts (K-major planar nibbles, bytes stored XOR 0x80, K and N
padded to 256/512) work around Mosaic's lowering and do not carry over.
Hopper's GEMV-shaped kernels want each output row's bytes contiguous, so
the port stores everything N-major, unpadded (the kernels mask ragged N
themselves).

:class:`PreparedWeight` (per-32 formats, K % 32 == 0), per weight row n:

* ``qs: uint8[N, K/2]`` — block ``b``'s 16 code bytes at ``[16b, 16b +
  16)``, byte ``j`` holding code ``32b + j`` in its low nibble and code
  ``32b + j + 16`` in its high nibble: exactly the ``qs`` field of
  llama.cpp's ``block_q4_0``, so one 16-byte load per lane brings a block;
* q4_0: ``d: float16[N, K/32]``, the block scales as stored in GGUF;
  ``x = (q - 8) * d``;
* q4_k (a q4_K tensor in its effective q4_1 form, ``kquants.
  to_effective``): ``d, m: float32[N, K/32]``, ``x = q * d + m``.  The
  effective ``d' = d * ls`` and ``m' = -dmin * lm`` are f32 products that
  f16 cannot hold.  Storing them as f32 planes costs 6 bits per weight
  against 4.5 in the file (keeping f16 d/dmin per 256 plus the 6-bit
  ls/lm and forming the products in the kernel would read 4.625); the
  port takes the planes for now because K1 and K4 then share one block
  loop and one epilogue with q4_0, as the JAX kernels share theirs.

:class:`PreparedK16` (per-16 formats q6_K, q3_K, q2_K, K % 256 == 0):

* ``qs: int8[N, K]`` — the shifted codes (q6_K ``q - 32``, q3_K ``q'``,
  q2_K ``q``), so a 16-element sub-block is 16 contiguous bytes;
* ``scp: float32[N, K/16]`` — ``d * sc`` per 16-element sub-block;
* ``mp: float32[N, K/16]`` — q2_K's additive ``-dmin * mn``, else None.

That reads 10 bits per weight (q2_K 12) against q6_K's 6.5625 in the
file: the price of byte-aligned codes for ``__dp4a``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..formats import kquants
from ..formats.blocks import QK, Q4_0Tensor
from ..formats.quant import unpack_planar_4bit


class PreparedWeight(NamedTuple):
    qtype: str  # format name ("q4_0" or "q4_k")
    n: int  # out-features
    k: int  # reduction dim
    qs: torch.Tensor  # uint8 [N, K/2], GGUF block order (see module doc)
    d: torch.Tensor  # q4_0: float16 [N, K/32]; q4_k: float32 [N, K/32]
    m: Optional[torch.Tensor] = None  # q4_k: float32 [N, K/32]


class PreparedK16(NamedTuple):
    qtype: str  # "q6_k", "q3_k" or "q2_k"
    n: int
    k: int
    qs: torch.Tensor  # int8 [N, K] shifted codes
    scp: torch.Tensor  # float32 [N, K/16]
    mp: Optional[torch.Tensor] = None  # float32 [N, K/16] (q2_k)


def prepare(w_q) -> PreparedWeight:
    """Re-lay a planar row-major Q4_0 container or q4_K effective container
    (``kquants.EffectiveQ41``, torch tensors) into the kernel layout, on
    the container's device."""
    if isinstance(w_q, Q4_0Tensor):
        qtype = "q4_0"
    elif isinstance(w_q, kquants.EffectiveQ41):
        qtype = "q4_k"
    else:
        raise NotImplementedError(
            f"prepare: {type(w_q).__name__} weights are not ported (q4_0 "
            "and q4_K are)")
    packed = torch.as_tensor(w_q.packed)
    n, khalf = packed.shape
    k = 2 * khalf
    if k % QK:
        raise ValueError(f"K={k} must be a multiple of {QK}")
    c = unpack_planar_4bit(packed).reshape(n, k // QK, 2, QK // 2)
    qs = (c[:, :, 0] | (c[:, :, 1] << 4)).reshape(n, khalf).contiguous()

    def plane(x, dtype):
        return torch.as_tensor(x).to(device=packed.device,
                                     dtype=dtype).contiguous()

    if qtype == "q4_0":
        return PreparedWeight(qtype, n, k, qs, plane(w_q.d, torch.float16))
    return PreparedWeight(qtype, n, k, qs, plane(w_q.d, torch.float32),
                          plane(w_q.m, torch.float32))


def prepare_k16(t) -> PreparedK16:
    """A q6_K / q3_K / q2_K container (torch tensors) -> :class:`PreparedK16`
    on its device."""
    qtype = kquants.k16_qtype(t)
    if qtype is None:
        raise NotImplementedError(
            f"prepare_k16 takes q6_K/q3_K/q2_K, not {type(t).__name__}")
    n, k = t.qs.shape
    mp = None if t.mp is None else t.mp.contiguous()
    return PreparedK16(qtype, n, k, t.qs.to(torch.int8).contiguous(),
                       t.scp.contiguous(), mp)


def codes(w: PreparedWeight) -> torch.Tensor:
    """Raw 0..15 codes ``uint8[N, K]`` in natural K order."""
    b = w.qs.reshape(w.n, w.k // QK, QK // 2)
    return torch.cat([b & 0x0F, b >> 4], dim=-1).reshape(w.n, w.k)


def dequantize(w: PreparedWeight, dtype=torch.float32) -> torch.Tensor:
    """``(q - 8) * d`` (q4_0) or ``q * d + m`` (q4_k) as ``dtype [N, K]``,
    computed in float32 as the JAX kernels dequantize."""
    q = codes(w).to(torch.float32).reshape(w.n, w.k // QK, QK)
    if w.qtype == "q4_0":
        x = (q - 8.0) * w.d.to(torch.float32)[..., None]
    else:
        x = q * w.d[..., None] + w.m[..., None]
    return x.reshape(w.n, w.k).to(dtype)


def dequantize_k16(w: PreparedK16) -> torch.Tensor:
    """``qs * scp (+ mp)`` per 16-element sub-block, float32 [N, K] (the
    JAX ``_k16_dequant_gemm``'s weight)."""
    x = w.qs.to(torch.float32) * w.scp.repeat_interleave(16, dim=-1)
    if w.mp is not None:
        x = x + w.mp.repeat_interleave(16, dim=-1)
    return x


__all__ = ["PreparedWeight", "PreparedK16", "prepare", "prepare_k16",
           "codes", "dequantize", "dequantize_k16"]
