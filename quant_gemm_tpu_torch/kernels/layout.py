"""The port's device weight layouts (counterparts of the JAX package's
``gemm_pallas.PreparedWeight`` / ``prepare`` and ``gemm_exact.PreparedK16``
/ ``prepare_k16``).

The TPU layouts (K-major planar nibbles, bytes stored XOR 0x80, K and N
padded to 256/512) work around Mosaic's lowering and do not carry over.
Hopper's GEMV-shaped kernels want each output row's bytes contiguous, so
the port stores everything N-major, unpadded (the kernels mask ragged N
themselves).

:class:`PreparedWeight` (per-32 formats, K % 32 == 0), per weight row n:

* 4/5-bit ``qs: uint8[N, K/2]`` — block ``b``'s 16 code bytes at ``[16b,
  16b + 16)``, byte ``j`` holding (the low four bits of) code ``32b + j``
  in its low nibble and code ``32b + j + 16`` in its high nibble: exactly
  the ``qs`` field of llama.cpp's ``block_q4_0``, so one 16-byte load per
  lane brings a block;
* q8_0 ``qs: int8[N, K]`` — block ``b``'s 32 signed codes at ``[32b, 32b
  + 32)``, llama.cpp's ``block_q8_0`` ``qs`` (two 16-byte loads);
* q5_0/q5_1/q5_k ``qh: int32[N, K/32]`` — block ``b``'s 32 fifth bits, bit
  ``j`` the high bit of code ``32b + j``: llama.cpp's 4-byte ``qh``, and
  the little-endian word of the planar container's bytes ``4b .. 4b+3``;
* ``d: float16[N, K/32]`` — the block scales as stored in GGUF, and for
  q4_1/q5_1 ``m: float16[N, K/32]``, the block mins: ``x = (q - 8) * d``
  (q4_0), ``(q - 16) * d`` (q5_0), ``q * d`` (q8_0), ``q * d + m``
  (q4_1, q5_1);
* q4_k (a q4_K tensor in its effective q4_1 form, ``kquants.
  to_effective``): ``d, m: float32[N, K/32]``, ``x = q * d + m``.  The
  effective ``d' = d * ls`` and ``m' = -dmin * lm`` are f32 products that
  f16 cannot hold.  Storing them as f32 planes costs 6 bits per weight
  against 4.5 in the file (keeping f16 d/dmin per 256 plus the 6-bit
  ls/lm and forming the products in the kernel would read 4.625); the
  port takes the planes for now because K1 and K4 then share one block
  loop and one epilogue with q4_1, as the JAX kernels share theirs.
* q5_k (a q5_K tensor in its effective q5_1 form, ``kquants.
  to_effective_q5_k``): the q5_1 layout with ``d, m: float32[N, K/32]``,
  as q4_k is the q4_1 layout with f32 planes: 4 code bits + 1 fifth bit +
  64/32 scale bits = 7 bits per weight against 5.5 in the file.
* iq4_xs (an IQ4_XS tensor in its effective form, ``kquants.
  EffectiveQ80``): the q8_0 layout with ``d: float32[N, K/32]``, the
  per-32 ``d * (sc - 32)`` (an f16 times a 6-bit integer, not an f16
  value), ``x = q * d`` over the int8 codebook values: 9 bits per weight
  against 4.25 in the file, the price of serving it on the q8_0 path as
  JAX does.  An IQ4_NL tensor needs no form of its own: it decodes to
  q8_0 with its f16 ``d`` verbatim.

:class:`PreparedK16` (per-16 formats q6_K, q3_K, q2_K, K % 256 == 0):

* ``qs: int8[N, K]`` — the shifted codes (q6_K ``q - 32``, q3_K ``q'``,
  q2_K ``q``), so a 16-element sub-block is 16 contiguous bytes;
* ``d: float16[N, K/256]`` and ``sc: int8[N, K/16]`` — the container's
  super-block scale and per-16 sub-scales;
* q2_K also ``dmin: float16[N, K/256]`` and ``mn: int8[N, K/16]`` (its
  4-bit mins), else None.

The per-16 scale ``scp = d * sc`` and q2_K's additive ``mp = -(dmin *
mn)`` are properties computed as the containers compute them
(``kquants.Q6_KTensor.scp``, ``Q2_KTensor.mp``): an f16 times an integer
below 256 is exact in float32, and K7 forms the same products in
registers, so no output bit depends on the layout.  That reads 8.5625
bits per weight (q2_K 9.125) against q6_K's 6.5625 in the file (3.4375
q3_K, 2.625 q2_K): the price of byte-aligned codes for the int8 MMA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..formats import kquants
from ..formats.blocks import (QK, Q4_0Tensor, Q4_1Tensor, Q5_0Tensor,
                              Q5_1Tensor, Q8_0Tensor)
from ..formats.quant import unpack_planar_4bit

#: the per-32 formats :func:`prepare` lays out, and the value subtracted
#: from a code before its scale (the min forms add ``m`` instead)
QTYPES = ("q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "q4_k", "q5_k", "iq4_xs")
OFFSET = {"q4_0": 8, "q5_0": 16}
HAS_MIN = ("q4_1", "q5_1", "q4_k", "q5_k")
#: the formats whose codes take a fifth bit from ``qh``
HAS_QH = ("q5_0", "q5_1", "q5_k")
#: the forms whose codes are int8 bytes, one a weight
INT8_CODES = ("q8_0", "iq4_xs")
#: the effective forms (K-quants, IQ4_XS), whose ``d``/``m`` planes are
#: float32
F32_PLANES = ("q4_k", "q5_k", "iq4_xs")


class PreparedWeight(NamedTuple):
    qtype: str  # format name, one of QTYPES
    n: int  # out-features
    k: int  # reduction dim
    qs: torch.Tensor  # uint8 [N, K/2] or (q8_0, iq4_xs) int8 [N, K]
    d: torch.Tensor  # float16 [N, K/32]; q4_k, q5_k, iq4_xs: float32
    m: Optional[torch.Tensor] = None  # q4_1/q5_1 float16, q4_k/q5_k float32
    qh: Optional[torch.Tensor] = None  # q5_0/q5_1/q5_k: int32 [N, K/32]


def planes(w: PreparedWeight) -> tuple:
    """The weight's scale and bit planes in the kernels' argument order:
    d, then m (min formats), then qh (q5)."""
    return tuple(t for t in (w.d, w.m, w.qh) if t is not None)


class PreparedK16(NamedTuple):
    qtype: str  # "q6_k", "q3_k" or "q2_k"
    n: int
    k: int
    qs: torch.Tensor  # int8 [N, K] shifted codes
    d: torch.Tensor  # float16 [N, K/256]
    sc: torch.Tensor  # int8 [N, K/16]
    dmin: Optional[torch.Tensor] = None  # float16 [N, K/256] (q2_k)
    mn: Optional[torch.Tensor] = None  # int8 [N, K/16] (q2_k)

    @property
    def scp(self) -> torch.Tensor:
        """float32 [N, K/16]: ``d * sc`` per 16-element sub-block."""
        return (self.d.to(torch.float32).repeat_interleave(16, dim=-1)
                * self.sc.to(torch.float32))

    @property
    def mp(self) -> Optional[torch.Tensor]:
        """float32 [N, K/16]: q2_K's additive ``-(dmin * mn)``, else None."""
        if self.dmin is None:
            return None
        return -(self.dmin.to(torch.float32).repeat_interleave(16, dim=-1)
                 * self.mn.to(torch.float32))


_CONTAINERS = {Q4_0Tensor: "q4_0", Q4_1Tensor: "q4_1", Q5_0Tensor: "q5_0",
               Q5_1Tensor: "q5_1", Q8_0Tensor: "q8_0",
               kquants.EffectiveQ41: "q4_k", kquants.EffectiveQ51: "q5_k",
               kquants.EffectiveQ80: "iq4_xs"}


def prepare(w_q) -> PreparedWeight:
    """Re-lay a planar row-major container (q4_0, q4_1, q5_0, q5_1, q8_0,
    a q4_K / q5_K tensor's ``kquants.EffectiveQ41`` / ``EffectiveQ51``,
    or an IQ4_XS tensor's ``kquants.EffectiveQ80``; torch tensors) into
    the kernel layout, on the container's device."""
    qtype = _CONTAINERS.get(type(w_q))
    if qtype is None:
        raise NotImplementedError(
            f"prepare: {type(w_q).__name__} weights are not ported (per-32 "
            f"formats: {', '.join(QTYPES)})")
    dev = w_q.d.device

    def plane(x, dtype=torch.float16):
        return torch.as_tensor(x).to(device=dev, dtype=dtype).contiguous()

    sdt = torch.float32 if qtype in F32_PLANES else torch.float16
    if qtype in INT8_CODES:
        n, k = w_q.qs.shape
        if k % QK:
            raise ValueError(f"K={k} must be a multiple of {QK}")
        return PreparedWeight(qtype, n, k, plane(w_q.qs, torch.int8),
                              plane(w_q.d, sdt))
    packed = torch.as_tensor(w_q.packed)
    n, khalf = packed.shape
    k = 2 * khalf
    if k % QK:
        raise ValueError(f"K={k} must be a multiple of {QK}")
    c = unpack_planar_4bit(packed).reshape(n, k // QK, 2, QK // 2)
    qs = (c[:, :, 0] | (c[:, :, 1] << 4)).reshape(n, khalf).contiguous()
    m = plane(w_q.m, sdt) if qtype in HAS_MIN else None
    # planar bits in natural order: block b's 32 bits are bytes 4b..4b+3
    qh = (plane(w_q.qh, torch.uint8).view(torch.int32)
          if qtype in HAS_QH else None)
    return PreparedWeight(qtype, n, k, qs, plane(w_q.d, sdt), m, qh)


def prepare_k16(t) -> PreparedK16:
    """A q6_K / q3_K / q2_K container (torch tensors) -> :class:`PreparedK16`
    on its device."""
    qtype = kquants.k16_qtype(t)
    if qtype is None:
        raise NotImplementedError(
            f"prepare_k16 takes q6_K/q3_K/q2_K, not {type(t).__name__}")
    n, k = t.qs.shape

    def plane(x, dtype):
        return x.to(dtype).contiguous()

    mins = ((plane(t.dmin, torch.float16), plane(t.mn, torch.int8))
            if qtype == "q2_k" else ())
    return PreparedK16(qtype, n, k, plane(t.qs, torch.int8),
                       plane(t.d, torch.float16), plane(t.sc, torch.int8),
                       *mins)


def k16_planes(w: PreparedK16) -> tuple:
    """A per-16 weight's planes in K7's argument order: d, sc, then q2_K's
    dmin and mn."""
    return tuple(t for t in (w.d, w.sc, w.dmin, w.mn) if t is not None)


def codes(w: PreparedWeight) -> torch.Tensor:
    """Raw codes ``[N, K]`` in natural K order: uint8 0..15 (q4), 0..31
    (q5, the 5th bit from ``qh``), or the int8 codes (q8_0, iq4_xs)."""
    if w.qtype in INT8_CODES:
        return w.qs
    b = w.qs.reshape(w.n, w.k // QK, QK // 2)
    q = torch.cat([b & 0x0F, b >> 4], dim=-1)
    if w.qh is not None:
        j = torch.arange(QK, device=w.qh.device, dtype=torch.int32)
        q = q | (((w.qh[..., None] >> j) & 1) << 4).to(torch.uint8)
    return q.reshape(w.n, w.k)


def dequantize(w: PreparedWeight, dtype=torch.float32) -> torch.Tensor:
    """``(q - offset) * d`` or ``q * d + m`` as ``dtype [N, K]``, computed
    in float32 as the JAX kernels dequantize."""
    q = codes(w).to(torch.float32).reshape(w.n, w.k // QK, QK)
    d = w.d.to(torch.float32)[..., None]
    if w.m is not None:
        x = q * d + w.m.to(torch.float32)[..., None]
    else:
        x = (q - float(OFFSET.get(w.qtype, 0))) * d
    return x.reshape(w.n, w.k).to(dtype)


def dequantize_k16(w: PreparedK16) -> torch.Tensor:
    """``qs * scp (+ mp)`` per 16-element sub-block, float32 [N, K] (the
    JAX ``_k16_dequant_gemm``'s weight)."""
    x = w.qs.to(torch.float32) * w.scp.repeat_interleave(16, dim=-1)
    mp = w.mp
    if mp is not None:
        x = x + mp.repeat_interleave(16, dim=-1)
    return x


__all__ = ["QTYPES", "OFFSET", "HAS_MIN", "HAS_QH", "INT8_CODES",
           "F32_PLANES",
           "PreparedWeight", "PreparedK16",
           "planes", "k16_planes", "prepare", "prepare_k16",
           "codes", "dequantize", "dequantize_k16"]
