"""llama.cpp K-quant super-blocks (256 elements): q4_K, q6_K, q2_K, q3_K.

Torch twins of the JAX package's ``formats/kquants.py`` containers and
byte codecs, written as tensor operations so that a model file decodes on
whatever device its bytes were moved to (a full-width file on the card in
seconds).  Every function is bit-equal to its numpy counterpart on the same
bytes.  The encoders (``quantize_q*_k``) are not ported.

Serialized blocks (AoS, ``uint8 [N, K/256, bytes]``) and their SoA
containers:

======  =====  =========================================================
format  bytes  block_* layout -> container
======  =====  =========================================================
q4_K     144   d, dmin f16 | scales[12] (eight 6-bit (ls, lm) pairs) |
               qs[128] (per 64-chunk: byte l = x[l] | x[l+32] << 4)
               -> :class:`Q4_KTensor` (planar packed codes 0..15)
q6_K     210   ql[128] | qh[64] | scales[16] int8 | d f16
               -> :class:`Q6_KTensor` (int8 codes q - 32)
q2_K      84   scales[16] (sc | mn << 4) | qs[64] 2-bit | d, dmin f16
               -> :class:`Q2_KTensor` (int8 codes 0..3)
q3_K     110   hmask[32] | qs[64] 2-bit | scales[12] 6-bit | d f16
               -> :class:`Q3_KTensor` (int8 shifted codes -4..3)
======  =====  =========================================================

q4_K dequantizes per 32-element sub-block as ``d*ls*q - dmin*lm``: the
q4_1 form with per-32 **effective** f32 scales ``d' = d*ls`` and ``m' =
-dmin*lm`` (:func:`to_effective`; the products are not f16 values).  The
per-16 formats keep their exact codes and per-16 f32 scales ``scp`` (and
q2_K's additive ``mp``) for the per-16 kernel K7.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .blocks import QK

QK_K = 256  # super-block size
NSB = QK_K // QK  # 32-element sub-blocks per super-block
BLOCK_BYTES = 144  # q4_K: 2 + 2 + 12 + 128
QK6_BLOCK_BYTES = 210  # 128 ql + 64 qh + 16 scales + 2 d
QK2_BLOCK_BYTES = 84  # 16 scales + 64 qs + 2 d + 2 dmin
QK3_BLOCK_BYTES = 110  # 32 hmask + 64 qs + 12 scales + 2 d


class Q4_KTensor(NamedTuple):
    """SoA q4_K; ``packed`` is the project's planar layout (byte c holds
    elements c and c + K/2), not the per-64 interleave of the bytes."""

    d: torch.Tensor  # f16 [N, K/256]
    dmin: torch.Tensor  # f16 [N, K/256]
    ls: torch.Tensor  # u8 [N, K/32] 6-bit sub-block scales
    lm: torch.Tensor  # u8 [N, K/32] 6-bit sub-block mins
    packed: torch.Tensor  # u8 [N, K/2] planar codes 0..15

    @property
    def k(self) -> int:
        return self.packed.shape[-1] * 2


class EffectiveQ41(NamedTuple):
    """Per-32 effective ``(d', m')`` view of a q4_K tensor: q4_1-shaped
    with f32 scales; ``x = q * d' + m'``."""

    packed: torch.Tensor  # u8 [N, K/2] planar codes 0..15
    d: torch.Tensor  # f32 [N, K/32]
    m: torch.Tensor  # f32 [N, K/32]

    qtype = "q4_k"

    @property
    def k(self) -> int:
        return self.packed.shape[-1] * 2


def _f16(raw: torch.Tensor, lo: int) -> torch.Tensor:
    """The f16 stored at bytes ``[lo, lo+2)`` of each block: [N, nsb]."""
    return raw[..., lo:lo + 2].contiguous().view(torch.float16)[..., 0]


def _f16_bytes(x: torch.Tensor) -> torch.Tensor:
    """f16 [..., n] -> its little-endian bytes u8 [..., n, 2]."""
    return x.to(torch.float16).contiguous()[..., None].view(torch.uint8)


def _planar(codes: torch.Tensor) -> torch.Tensor:
    """Natural-order 4-bit codes [N, K] -> planar packed [N, K/2]."""
    half = codes.shape[-1] // 2
    return (codes[..., :half] | (codes[..., half:] << 4)).to(torch.uint8)


def _unplanar(packed: torch.Tensor) -> torch.Tensor:
    """Planar packed [N, K/2] -> natural-order codes u8 [N, K]."""
    return torch.cat([packed & 0x0F, packed >> 4], dim=-1)


def _rep(x: torch.Tensor, n: int) -> torch.Tensor:
    """``np.repeat(x.astype(f32), n, axis=-1)``."""
    return x.to(torch.float32).repeat_interleave(n, dim=-1)


# ---------------------------------------------------------------------------
# q4_K
# ---------------------------------------------------------------------------


def _pack_scales(ls: torch.Tensor, lm: torch.Tensor) -> torch.Tensor:
    """[..., 8] 6-bit pairs -> [..., 12] bytes (llama.cpp
    ``get_scale_min_k4`` inverse): bytes 0-3 hold ls 0-3 and the top two
    bits of ls 4-7, bytes 4-7 the same for lm, bytes 8-11 the low nibbles
    of ls/lm 4-7 -- so scales 4-7 straddle two bytes each."""
    ls, lm = ls.to(torch.uint8), lm.to(torch.uint8)
    b0 = (ls[..., :4] & 63) | ((ls[..., 4:] >> 4) << 6)
    b4 = (lm[..., :4] & 63) | ((lm[..., 4:] >> 4) << 6)
    b8 = (ls[..., 4:] & 0xF) | ((lm[..., 4:] & 0xF) << 4)
    return torch.cat([b0, b4, b8], dim=-1)


def _unpack_scales(b: torch.Tensor):
    """[..., 12] bytes -> ([..., 8] ls, [..., 8] lm) per get_scale_min_k4."""
    b0, b4, b8 = b[..., 0:4], b[..., 4:8], b[..., 8:12]
    ls = torch.cat([b0 & 63, (b8 & 0xF) | ((b0 >> 6) << 4)], dim=-1)
    lm = torch.cat([b4 & 63, (b8 >> 4) | ((b4 >> 6) << 4)], dim=-1)
    return ls, lm


def from_bytes(raw: torch.Tensor) -> Q4_KTensor:
    """AoS u8 [N, K/256, 144] -> :class:`Q4_KTensor` (accepts llama.cpp's
    bytes), on ``raw``'s device."""
    n, nsb, bb = raw.shape
    if bb != BLOCK_BYTES:
        raise ValueError(f"q4_K blocks are {BLOCK_BYTES} bytes, got {bb}")
    ls, lm = _unpack_scales(raw[:, :, 4:16])
    qs = raw[:, :, 16:144].reshape(n, nsb, 4, 1, 32)
    codes = torch.cat([qs & 0x0F, qs >> 4], dim=3).reshape(n, nsb * QK_K)
    return Q4_KTensor(_f16(raw, 0), _f16(raw, 2), ls.reshape(n, -1),
                      lm.reshape(n, -1), _planar(codes))


def to_bytes(t: Q4_KTensor) -> torch.Tensor:
    """SoA -> AoS u8 [N, K/256, 144] (bit-identical to block_q4_K)."""
    n = t.packed.shape[0]
    nsb = t.k // QK_K
    scales = _pack_scales(t.ls.reshape(n, nsb, 8), t.lm.reshape(n, nsb, 8))
    c = _unplanar(t.packed).reshape(n, nsb, 4, 2, 32)
    qs = (c[:, :, :, 0] | (c[:, :, :, 1] << 4)).reshape(n, nsb, 128)
    return torch.cat([_f16_bytes(t.d.reshape(n, nsb)).reshape(n, nsb, 2),
                      _f16_bytes(t.dmin.reshape(n, nsb)).reshape(n, nsb, 2),
                      scales, qs], dim=-1)


def to_effective(t: Q4_KTensor) -> EffectiveQ41:
    """Per-32 effective scales: ``d' = d*ls``, ``m' = -dmin*lm`` (f32)."""
    d = _rep(t.d, NSB) * t.ls.to(torch.float32)
    m = -(_rep(t.dmin, NSB) * t.lm.to(torch.float32))
    return EffectiveQ41(t.packed, d, m)


def dequantize_q4_k(t: Q4_KTensor) -> torch.Tensor:
    """f32 [N, K]: ``q * d' + m'`` per 32-element sub-block."""
    eff = to_effective(t)
    n, k = t.packed.shape[0], t.k
    q = _unplanar(t.packed).to(torch.float32).reshape(n, k // QK, QK)
    return (q * eff.d[..., None] + eff.m[..., None]).reshape(n, k)


# ---------------------------------------------------------------------------
# q6_K
# ---------------------------------------------------------------------------


class Q6_KTensor(NamedTuple):
    """SoA q6_K: ``x = d * sc_j * (q - 32)``, codes stored shifted
    (``q - 32`` in [-32, 31], int8) with per-16 int8 sub-scales."""

    d: torch.Tensor  # f16 [N, K/256]
    sc: torch.Tensor  # i8 [N, K/16]
    qs: torch.Tensor  # i8 [N, K] codes - 32

    @property
    def k(self) -> int:
        return self.qs.shape[-1]

    @property
    def scp(self) -> torch.Tensor:
        """Per-16 effective scale ``d * sc`` (exact f32 products)."""
        return _rep(self.d, QK_K // 16) * self.sc.to(torch.float32)

    mp = None


def from_bytes_q6_k(raw: torch.Tensor) -> Q6_KTensor:
    """AoS u8 [N, K/256, 210] -> :class:`Q6_KTensor`.  Within each
    128-element half, ``ql`` holds the low nibbles of segments (0, 2) in
    its first 32 bytes and (1, 3) in its next 32, ``qh`` the top two bits
    of segments 0-3 at bit pairs 0-1, 2-3, 4-5, 6-7."""
    n, nsb, bb = raw.shape
    if bb != QK6_BLOCK_BYTES:
        raise ValueError(f"q6_K blocks are {QK6_BLOCK_BYTES} bytes, got {bb}")
    ql = raw[:, :, 0:128].reshape(n, nsb, 2, 2, 32)  # [half, 32-row, l]
    qh = raw[:, :, 128:192].reshape(n, nsb, 2, 1, 32)
    lo = torch.stack([ql[:, :, :, 0] & 0xF, ql[:, :, :, 1] & 0xF,
                      ql[:, :, :, 0] >> 4, ql[:, :, :, 1] >> 4], dim=3)
    hi = (qh >> torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                             device=raw.device)[:, None]) & 3
    q = (lo.to(torch.int16) | (hi.to(torch.int16) << 4)) - 32
    sc = raw[:, :, 192:208].contiguous().view(torch.int8)
    return Q6_KTensor(_f16(raw, 208), sc.reshape(n, nsb * 16),
                      q.to(torch.int8).reshape(n, nsb * QK_K))


def to_bytes_q6_k(t: Q6_KTensor) -> torch.Tensor:
    """SoA -> AoS u8 [N, K/256, 210] (inverse of :func:`from_bytes_q6_k`)."""
    n, k = t.qs.shape
    nsb = k // QK_K
    q = (t.qs.to(torch.int16) + 32).to(torch.uint8).reshape(n, nsb, 2, 4, 32)
    s1, s2, s3, s4 = q.unbind(3)
    ql = torch.stack([(s1 & 0xF) | ((s3 & 0xF) << 4),
                      (s2 & 0xF) | ((s4 & 0xF) << 4)], dim=3)
    qh = (s1 >> 4) | ((s2 >> 4) << 2) | ((s3 >> 4) << 4) | ((s4 >> 4) << 6)
    sc = t.sc.to(torch.int8).contiguous().view(torch.uint8)
    return torch.cat([ql.reshape(n, nsb, 128), qh.reshape(n, nsb, 64),
                      sc.reshape(n, nsb, 16),
                      _f16_bytes(t.d.reshape(n, nsb)).reshape(n, nsb, 2)],
                     dim=-1)


def dequantize_q6_k(t: Q6_KTensor) -> torch.Tensor:
    """f32 [N, K]: ``scp * (q - 32)``."""
    return t.scp.repeat_interleave(16, dim=-1) * t.qs.to(torch.float32)


# ---------------------------------------------------------------------------
# q2_K / q3_K: per-16 scales like q6_K
# ---------------------------------------------------------------------------


class Q2_KTensor(NamedTuple):
    """SoA q2_K: ``x = d*sc_j*q - dmin*mn_j`` (q in 0..3, per-16 4-bit
    sc/mn); codes stored unpacked as int8."""

    d: torch.Tensor  # f16 [N, K/256]
    dmin: torch.Tensor  # f16 [N, K/256]
    sc: torch.Tensor  # u8 [N, K/16] 4-bit scales
    mn: torch.Tensor  # u8 [N, K/16] 4-bit mins
    qs: torch.Tensor  # i8 [N, K] codes 0..3

    @property
    def k(self) -> int:
        return self.qs.shape[-1]

    @property
    def scp(self) -> torch.Tensor:
        return _rep(self.d, QK_K // 16) * self.sc.to(torch.float32)

    @property
    def mp(self) -> torch.Tensor:
        """Per-16 additive term: ``x = scp*q + mp`` (``mp = -dmin*mn``)."""
        return -(_rep(self.dmin, QK_K // 16) * self.mn.to(torch.float32))


class Q3_KTensor(NamedTuple):
    """SoA q3_K: ``x = d*(sc_j - 32)*q'`` with shifted codes ``q' = q2 -
    (0 if hbit else 4)`` in [-4, 3], stored as int8."""

    d: torch.Tensor  # f16 [N, K/256]
    sc: torch.Tensor  # i8 [N, K/16] 6-bit scales minus 32
    qs: torch.Tensor  # i8 [N, K] shifted codes

    @property
    def k(self) -> int:
        return self.qs.shape[-1]

    @property
    def scp(self) -> torch.Tensor:
        return _rep(self.d, QK_K // 16) * self.sc.to(torch.float32)

    mp = None


def _crumbs(qs: torch.Tensor) -> torch.Tensor:
    """The 2-bit plane of q2_K/q3_K, u8 [N, nsb, 64] -> codes u8 [N, nsb,
    256]: element e lives in byte ``(e//128)*32 + e%32`` at shift
    ``2*((e%128)//32)``."""
    n, nsb, _ = qs.shape
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=qs.device)
    q = (qs.reshape(n, nsb, 2, 1, 32) >> shifts[:, None]) & 3
    return q.reshape(n, nsb, QK_K)


def _uncrumbs(q: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_crumbs`: codes [N, nsb, 256] (0..3) -> u8 [N,
    nsb, 64]."""
    n, nsb, _ = q.shape
    c = q.to(torch.uint8).reshape(n, nsb, 2, 4, 32)
    packed = c[:, :, :, 0] | (c[:, :, :, 1] << 2) | (c[:, :, :, 2] << 4) \
        | (c[:, :, :, 3] << 6)
    return packed.reshape(n, nsb, 64)


def from_bytes_q2_k(raw: torch.Tensor) -> Q2_KTensor:
    """AoS u8 [N, K/256, 84] -> :class:`Q2_KTensor`."""
    n, nsb, bb = raw.shape
    if bb != QK2_BLOCK_BYTES:
        raise ValueError(f"q2_K blocks are {QK2_BLOCK_BYTES} bytes, got {bb}")
    scales = raw[:, :, 0:16]
    q = _crumbs(raw[:, :, 16:80]).to(torch.int8)
    return Q2_KTensor(_f16(raw, 80), _f16(raw, 82),
                      (scales & 0xF).reshape(n, nsb * 16),
                      (scales >> 4).reshape(n, nsb * 16),
                      q.reshape(n, nsb * QK_K))


def to_bytes_q2_k(t: Q2_KTensor) -> torch.Tensor:
    n, k = t.qs.shape
    nsb = k // QK_K
    scales = (t.sc.to(torch.uint8) | (t.mn.to(torch.uint8) << 4))
    return torch.cat([scales.reshape(n, nsb, 16),
                      _uncrumbs((t.qs & 3).reshape(n, nsb, QK_K)),
                      _f16_bytes(t.d.reshape(n, nsb)).reshape(n, nsb, 2),
                      _f16_bytes(t.dmin.reshape(n, nsb)).reshape(n, nsb, 2)],
                     dim=-1)


def _q3_scales(s12: torch.Tensor) -> torch.Tensor:
    """[..., 12] packed bytes -> [..., 16] 6-bit scales (0..63), the
    llama.cpp kmask1/kmask2 unpacking per byte."""
    s = s12.to(torch.int16)
    lo, mid, hi = s[..., 0:4], s[..., 4:8], s[..., 8:12]
    w0 = (lo & 0xF) | ((hi & 3) << 4)
    w1 = (mid & 0xF) | (((hi >> 2) & 3) << 4)
    w2 = (lo >> 4) | (((hi >> 4) & 3) << 4)
    w3 = (mid >> 4) | (((hi >> 6) & 3) << 4)
    return torch.cat([w0, w1, w2, w3], dim=-1)


def from_bytes_q3_k(raw: torch.Tensor) -> Q3_KTensor:
    """AoS u8 [N, K/256, 110] -> :class:`Q3_KTensor`.  Bit ``e//32`` of
    hmask byte ``e%32`` set means no -4 offset for element e."""
    n, nsb, bb = raw.shape
    if bb != QK3_BLOCK_BYTES:
        raise ValueError(f"q3_K blocks are {QK3_BLOCK_BYTES} bytes, got {bb}")
    shifts = torch.arange(8, dtype=torch.uint8, device=raw.device)
    hbit = (raw[:, :, None, 0:32] >> shifts[:, None]) & 1  # [n, nsb, 8, 32]
    q = _crumbs(raw[:, :, 32:96]).to(torch.int8) \
        - 4 * (1 - hbit.reshape(n, nsb, QK_K).to(torch.int8))
    sc = (_q3_scales(raw[:, :, 96:108]) - 32).to(torch.int8)
    return Q3_KTensor(_f16(raw, 108), sc.reshape(n, nsb * 16),
                      q.reshape(n, nsb * QK_K))


def to_bytes_q3_k(t: Q3_KTensor) -> torch.Tensor:
    n, k = t.qs.shape
    nsb = k // QK_K
    q = t.qs.to(torch.int16).reshape(n, nsb, QK_K)
    hbit = (q >= 0).to(torch.int16)  # shifted >= 0 iff the high bit is set
    q2 = (q + 4 * (1 - hbit)) & 3
    shifts = torch.arange(8, dtype=torch.int16, device=q.device)
    hm = (hbit.reshape(n, nsb, 8, 32) << shifts[:, None]).sum(dim=2)
    sc = (t.sc.to(torch.int16) + 32).reshape(n, nsb, 4, 4)
    w0, w1, w2, w3 = sc.unbind(2)
    s12 = torch.cat([(w0 & 0xF) | ((w2 & 0xF) << 4),
                     (w1 & 0xF) | ((w3 & 0xF) << 4),
                     (w0 >> 4) | ((w1 >> 4) << 2) | ((w2 >> 4) << 4)
                     | ((w3 >> 4) << 6)], dim=-1)
    return torch.cat([hm.to(torch.uint8), _uncrumbs(q2),
                      s12.to(torch.uint8),
                      _f16_bytes(t.d.reshape(n, nsb)).reshape(n, nsb, 2)],
                     dim=-1)


def dequantize_q2_k(t: Q2_KTensor) -> torch.Tensor:
    return (t.scp.repeat_interleave(16, dim=-1) * t.qs.to(torch.float32)
            + t.mp.repeat_interleave(16, dim=-1))


def dequantize_q3_k(t: Q3_KTensor) -> torch.Tensor:
    return t.scp.repeat_interleave(16, dim=-1) * t.qs.to(torch.float32)


#: per-16-scale containers (served by K7, ``kernels/gemm_exact_k16.py``)
K16_TENSORS = (Q2_KTensor, Q3_KTensor, Q6_KTensor)

#: container -> dequantizer (f32 [N, K])
DEQUANT = {
    Q4_KTensor: dequantize_q4_k,
    Q2_KTensor: dequantize_q2_k,
    Q3_KTensor: dequantize_q3_k,
    Q6_KTensor: dequantize_q6_k,
}

#: GGUF type name -> (bytes per 256-element block, decoder, encoder)
CODECS = {
    "q4_K": (BLOCK_BYTES, from_bytes, to_bytes),
    "q6_K": (QK6_BLOCK_BYTES, from_bytes_q6_k, to_bytes_q6_k),
    "q2_K": (QK2_BLOCK_BYTES, from_bytes_q2_k, to_bytes_q2_k),
    "q3_K": (QK3_BLOCK_BYTES, from_bytes_q3_k, to_bytes_q3_k),
}

#: container type -> GGUF type name
GGUF_TYPE = {Q4_KTensor: "q4_K", Q6_KTensor: "q6_K", Q2_KTensor: "q2_K",
             Q3_KTensor: "q3_K"}


def random_blocks(qtype: str, n: int, k: int, std: float,
                  generator: torch.Generator):
    """A container of random valid blocks on ``generator``'s device whose
    values have mean about 0 and standard deviation about ``std``: uniform
    codes, sub-scales drawn from a band that keeps the f16 scales normal
    at the usual widths, and (q4_K, q2_K) mins that centre the codes.  For
    smoke runs and tests of full-width models without a checkpoint;
    ``qtype`` is a GGUF name (``"q4_K"``, ...)."""
    if k % QK_K:
        raise ValueError(f"K={k} must be a multiple of {QK_K}")
    nsb = k // QK_K
    device = generator.device

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=generator,
                             device=device)

    def sign(*shape):
        return ints(0, 2, *shape) * 2 - 1

    def f16(mean_scale):  # per super-block, +-25% around the target
        u = torch.rand(n, nsb, generator=generator, device=device)
        return (mean_scale * (0.75 + 0.5 * u)).to(torch.float16)

    if qtype == "q4_K":  # x = d*ls*q - dmin*lm, q uniform 0..15 (sd 4.6)
        ls = ints(16, 64, n, k // QK).to(torch.uint8)
        d = f16(std / (4.6 * 40))
        dmin = (d.to(torch.float32) * 7.5).to(torch.float16)
        codes = ints(0, 16, n, k).to(torch.uint8)
        return Q4_KTensor(d, dmin, ls, ls.clone(), _planar(codes))
    if qtype == "q6_K":  # x = d*sc*q', q' uniform -32..31 (sd 18.5)
        sc = (ints(4, 17, n, k // 16) * sign(n, k // 16)).to(torch.int8)
        return Q6_KTensor(f16(std / (18.5 * 10)), sc,
                          ints(-32, 32, n, k).to(torch.int8))
    if qtype == "q3_K":  # x = d*sc*q', q' uniform -4..3 (sd 2.3)
        sc = (ints(4, 17, n, k // 16) * sign(n, k // 16)).to(torch.int8)
        return Q3_KTensor(f16(std / (2.3 * 10)), sc,
                          ints(-4, 4, n, k).to(torch.int8))
    if qtype == "q2_K":  # x = d*sc*q - dmin*mn, q uniform 0..3 (sd 1.12)
        sc = ints(4, 16, n, k // 16).to(torch.uint8)
        d = f16(std / (1.12 * 10))
        dmin = (d.to(torch.float32) * 1.5).to(torch.float16)
        return Q2_KTensor(d, dmin, sc, sc.clone(),
                          ints(0, 4, n, k).to(torch.int8))
    raise NotImplementedError(f"random_blocks: {qtype} is not ported")


def k16_qtype(t) -> Optional[str]:
    """``"q2_k"``/``"q3_k"``/``"q6_k"`` for a per-16 container, else None."""
    name = GGUF_TYPE.get(type(t))
    return None if name is None or name == "q4_K" else name.lower()


__all__ = ["QK_K", "NSB", "BLOCK_BYTES", "QK6_BLOCK_BYTES",
           "QK2_BLOCK_BYTES", "QK3_BLOCK_BYTES", "Q4_KTensor", "EffectiveQ41",
           "Q6_KTensor", "Q2_KTensor", "Q3_KTensor", "from_bytes",
           "to_bytes", "to_effective", "dequantize_q4_k", "from_bytes_q6_k",
           "to_bytes_q6_k", "dequantize_q6_k", "from_bytes_q2_k",
           "to_bytes_q2_k", "from_bytes_q3_k", "to_bytes_q3_k",
           "dequantize_q2_k", "dequantize_q3_k", "K16_TENSORS", "DEQUANT",
           "CODECS", "GGUF_TYPE", "random_blocks", "k16_qtype"]
