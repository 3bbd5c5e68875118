"""llama.cpp K-quant super-blocks (256 elements): q4_K, q5_K, q6_K, q2_K,
q3_K; and the non-linear IQ4_NL / IQ4_XS blocks (read, encoded, served
on the q8_0 path; see the IQ4 section below).

Torch twins of the JAX package's ``formats/kquants.py`` containers and
byte codecs, written as tensor operations so that a model file decodes on
whatever device its bytes were moved to (a full-width file on the card in
seconds).  Every function is bit-equal to its numpy counterpart on the same
bytes.  The q4_K and q5_K encoders (:func:`quantize_q4_k`,
:func:`quantize_q5_k`, with llama.cpp's ``make_qkx2_quants`` scale/min
search) and the simplified q6_K/q3_K/q2_K encoders
(:func:`quantize_q6_k`, :func:`quantize_q3_k`, :func:`quantize_q2_k`) are
host code in numpy, copies of the JAX package's; they return containers
of CPU tensors.

Serialized blocks (AoS, ``uint8 [N, K/256, bytes]``) and their SoA
containers:

======  =====  =========================================================
format  bytes  block_* layout -> container
======  =====  =========================================================
q4_K     144   d, dmin f16 | scales[12] (eight 6-bit (ls, lm) pairs) |
               qs[128] (per 64-chunk: byte l = x[l] | x[l+32] << 4)
               -> :class:`Q4_KTensor` (planar packed codes 0..15)
q5_K     176   d, dmin f16 | scales[12] | qh[32] (byte l: bit 2c = 5th
               bit of x[64c + l], bit 2c+1 of x[64c + 32 + l]) | qs[128]
               -> :class:`Q5_KTensor` (planar low nibbles + planar 5th
               bits)
q6_K     210   ql[128] | qh[64] | scales[16] int8 | d f16
               -> :class:`Q6_KTensor` (int8 codes q - 32)
q2_K      84   scales[16] (sc | mn << 4) | qs[64] 2-bit | d, dmin f16
               -> :class:`Q2_KTensor` (int8 codes 0..3)
q3_K     110   hmask[32] | qs[64] 2-bit | scales[12] 6-bit | d f16
               -> :class:`Q3_KTensor` (int8 shifted codes -4..3)
======  =====  =========================================================

q4_K dequantizes per 32-element sub-block as ``d*ls*q - dmin*lm``: the
q4_1 form with per-32 **effective** f32 scales ``d' = d*ls`` and ``m' =
-dmin*lm`` (:func:`to_effective`; the products are not f16 values), and
q5_K likewise the q5_1 form (:func:`to_effective_q5_k`).  The
per-16 formats keep their exact codes and per-16 f32 scales ``scp`` (and
q2_K's additive ``mp``) for the per-16 kernel K7.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .blocks import QK
from .numpy_ref import f16_sat
from .quant import pack_planar_bits, unpack_planar_bits

QK_K = 256  # super-block size
NSB = QK_K // QK  # 32-element sub-blocks per super-block
BLOCK_BYTES = 144  # q4_K: 2 + 2 + 12 + 128
QK6_BLOCK_BYTES = 210  # 128 ql + 64 qh + 16 scales + 2 d
QK2_BLOCK_BYTES = 84  # 16 scales + 64 qs + 2 d + 2 dmin
QK3_BLOCK_BYTES = 110  # 32 hmask + 64 qs + 12 scales + 2 d
QK5_BLOCK_BYTES = 176  # 2 + 2 + 12 + 32 + 128


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
# the q4_K / q5_K encoders (numpy host code, as in the JAX package)
# ---------------------------------------------------------------------------


def _qkx2_search(xs: np.ndarray, nmax: int, rmin: float, rdelta: float,
                 nstep: int) -> tuple[np.ndarray, np.ndarray]:
    """Weighted least-squares (scale, min) search per 32-element sub-block:
    llama.cpp ``make_qkx2_quants`` (use_mad=false), vectorized.

    For each candidate inverse scale ``(rmin + rdelta*s + nmax) / span``
    the codes are rounded and (scale, min) refit by weighted least squares
    over them; the candidate with the lowest weighted SSE wins against the
    plain min/max start.  Weights: ``sqrt(mean(x^2)) + |x|``.  Returns
    ``(scale, minv)`` f32 ``[..., B]``, minv stored positive (m = -min);
    a constant sub-block gets scale 0."""
    w = np.sqrt((xs * xs).mean(axis=-1, keepdims=True)) + np.abs(xs)
    mn = np.minimum(xs.min(axis=-1), 0.0)
    mx = xs.max(axis=-1)
    span = mx - mn
    ok = span > 0
    span_safe = np.where(ok, span, 1.0)
    sum_w = w.sum(axis=-1)
    sum_x = (w * xs).sum(axis=-1)

    def sse(scale, minv_neg, codes):
        r = scale[..., None] * codes + minv_neg[..., None] - xs
        return (w * r * r).sum(axis=-1)

    # initialization: plain min/max rounding, no refit
    l0 = np.clip(
        np.floor((xs - mn[..., None]) * (nmax / span_safe)[..., None] + 0.5),
        0, nmax)
    best_scale = span / nmax
    best_min = mn.copy()
    best_err = sse(best_scale, best_min, l0)

    for s in range(nstep + 1):
        isc = (rmin + rdelta * s + nmax) / span_safe
        l = np.clip(np.floor(isc[..., None] * (xs - mn[..., None]) + 0.5),
                    0, nmax)
        sum_l = (w * l).sum(axis=-1)
        sum_l2 = (w * l * l).sum(axis=-1)
        sum_xl = (w * l * xs).sum(axis=-1)
        det = sum_w * sum_l2 - sum_l * sum_l
        valid = det > 0
        det_safe = np.where(valid, det, 1.0)
        this_scale = (sum_w * sum_xl - sum_x * sum_l) / det_safe
        this_min = (sum_l2 * sum_x - sum_l * sum_xl) / det_safe
        # a positive min is clamped to 0 and the scale refit unconstrained
        pos = this_min > 0
        l2_safe = np.where(sum_l2 > 0, sum_l2, 1.0)
        this_scale = np.where(pos, sum_xl / l2_safe, this_scale)
        this_min = np.where(pos, 0.0, this_min)
        err = np.where(valid, sse(this_scale, this_min, l), np.inf)
        better = err < best_err
        best_err = np.where(better, err, best_err)
        best_scale = np.where(better, this_scale, best_scale)
        best_min = np.where(better, this_min, best_min)

    scale = np.where(ok, best_scale, 0.0).astype(np.float32)
    minv = np.where(ok, -best_min, -mn).astype(np.float32)
    return scale, np.maximum(minv, 0.0)


def _encode_k(x, nmax: int, rmin: float, nstep: int, search: bool):
    """The shared q4_K/q5_K encoder: super-scales ``d``/``dmin`` (f16),
    6-bit sub-scales ``ls``/``lm`` and the codes 0..nmax, numpy."""
    x = np.asarray(x, np.float32)
    n, k = x.shape
    if k % QK_K:
        raise ValueError(f"K={k} must be a multiple of {QK_K}")
    xs = x.reshape(n, k // QK, QK)
    if search:
        scale, minv = _qkx2_search(xs, nmax, rmin=rmin, rdelta=0.1,
                                   nstep=nstep)
    else:
        mn = np.minimum(xs.min(axis=2), 0.0)  # mins stored positive
        scale = (xs.max(axis=2) - mn) / float(nmax)
        minv = -mn
    d = f16_sat(scale.reshape(n, -1, NSB).max(axis=2) / 63.0)
    dmin = f16_sat(minv.reshape(n, -1, NSB).max(axis=2) / 63.0)

    def six_bit(vals, sup):  # vals [N, nb], sup [N, nsb] (f32 of the f16)
        rep = np.repeat(sup, NSB, axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            q = np.floor(vals / np.where(rep > 0, rep, 1.0) + 0.5)
        return np.clip(np.where(rep > 0, q, 0), 0, 63).astype(np.uint8)

    d32, dmin32 = d.astype(np.float32), dmin.astype(np.float32)
    ls, lm = six_bit(scale, d32), six_bit(minv, dmin32)
    d_eff = np.repeat(d32, NSB, axis=1) * ls  # [N, nb]
    m_eff = np.repeat(dmin32, NSB, axis=1) * lm
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.floor((xs + m_eff[:, :, None])
                     / np.where(d_eff > 0, d_eff, 1.0)[:, :, None] + 0.5)
    codes = np.clip(np.where(d_eff[:, :, None] > 0, q, 0), 0, nmax)
    return d, dmin, ls, lm, codes.astype(np.uint8).reshape(n, k)


def _tensors(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def quantize_q4_k(x, search: bool = True) -> Q4_KTensor:
    """float [N, K] (numpy or a CPU tensor) -> :class:`Q4_KTensor` of CPU
    tensors, K % 256 == 0.  ``search=True`` runs the weighted scale/min
    search (rmin -1, 20 steps: llama.cpp ``quantize_row_q4_K_ref``'s
    parameters), ``False`` the min/max encoder."""
    d, dmin, ls, lm, codes = _encode_k(np.asarray(x), 15, -1.0, 20, search)
    half = codes.shape[1] // 2
    packed = codes[:, :half] | (codes[:, half:] << 4)
    return Q4_KTensor(*_tensors(d, dmin, ls, lm, packed))


# ---------------------------------------------------------------------------
# q5_K
# ---------------------------------------------------------------------------


class Q5_KTensor(NamedTuple):
    """SoA q5_K: super-scales, 6-bit sub-scales, planar low nibbles and
    planar 5th bits (bit ``c % 8`` of byte ``c // 8`` is code c's)."""

    d: torch.Tensor  # f16 [N, K/256]
    dmin: torch.Tensor  # f16 [N, K/256]
    ls: torch.Tensor  # u8 [N, K/32]
    lm: torch.Tensor  # u8 [N, K/32]
    packed: torch.Tensor  # u8 [N, K/2] planar low nibbles
    qh: torch.Tensor  # u8 [N, K/8] planar 5th bits

    @property
    def k(self) -> int:
        return self.packed.shape[-1] * 2


def quantize_q5_k(x, search: bool = True) -> Q5_KTensor:
    """float [N, K] (numpy or a CPU tensor) -> :class:`Q5_KTensor` of CPU
    tensors, K % 256 == 0.  ``search=True`` runs the weighted scale/min
    search (rmin -0.5, 15 steps: llama.cpp ``quantize_row_q5_K_ref``'s
    parameters), ``False`` the min/max encoder."""
    d, dmin, ls, lm, codes = _encode_k(np.asarray(x), 31, -0.5, 15, search)
    n, k = codes.shape
    half = k // 2
    packed = (codes[:, :half] & 0xF) | ((codes[:, half:] & 0xF) << 4)
    bits = (codes >> 4).reshape(n, k // 8, 8)
    qh = (bits << np.arange(8, dtype=np.uint8)).sum(axis=-1).astype(np.uint8)
    return Q5_KTensor(*_tensors(d, dmin, ls, lm, packed, qh))


class EffectiveQ51(NamedTuple):
    """Per-32 effective ``(d', m')`` view of a q5_K tensor: q5_1-shaped
    with f32 scales; ``x = q * d' + m'``."""

    packed: torch.Tensor  # u8 [N, K/2] planar low nibbles
    qh: torch.Tensor  # u8 [N, K/8] planar 5th bits
    d: torch.Tensor  # f32 [N, K/32]
    m: torch.Tensor  # f32 [N, K/32]

    qtype = "q5_k"

    @property
    def k(self) -> int:
        return self.packed.shape[-1] * 2


def to_effective_q5_k(t: Q5_KTensor) -> EffectiveQ51:
    """Per-32 effective scales: ``d' = d*ls``, ``m' = -dmin*lm`` (f32)."""
    d = _rep(t.d, NSB) * t.ls.to(torch.float32)
    m = -(_rep(t.dmin, NSB) * t.lm.to(torch.float32))
    return EffectiveQ51(t.packed, t.qh, d, m)


def _codes5(t: Q5_KTensor) -> torch.Tensor:
    """Natural-order codes 0..31, int32 [N, K]."""
    return (_unplanar(t.packed).to(torch.int32)
            | (unpack_planar_bits(t.qh).to(torch.int32) << 4))


def dequantize_q5_k(t: Q5_KTensor) -> torch.Tensor:
    """f32 [N, K]: ``q * d' + m'`` per 32-element sub-block, ``d' =
    d*ls``, ``m' = -dmin*lm``."""
    eff = to_effective_q5_k(t)
    n, k = t.packed.shape[0], t.k
    q = _codes5(t).to(torch.float32).reshape(n, k // QK, QK)
    return (q * eff.d[..., None] + eff.m[..., None]).reshape(n, k)


def to_bytes_q5_k(t: Q5_KTensor) -> torch.Tensor:
    """SoA -> AoS u8 [N, K/256, 176] (bit-identical to block_q5_K)."""
    n = t.packed.shape[0]
    nsb = t.k // QK_K
    scales = _pack_scales(t.ls.reshape(n, nsb, 8), t.lm.reshape(n, nsb, 8))
    c = _codes5(t).reshape(n, nsb, 4, 2, 32)  # [.., chunk, half, 32]
    hi = (c >> 4) & 1
    qh = sum((hi[:, :, j, 0] << (2 * j)) | (hi[:, :, j, 1] << (2 * j + 1))
             for j in range(4)).to(torch.uint8)
    low = (c & 0xF).to(torch.uint8)
    qs = (low[:, :, :, 0] | (low[:, :, :, 1] << 4)).reshape(n, nsb, 128)
    return torch.cat([_f16_bytes(t.d.reshape(n, nsb)).reshape(n, nsb, 2),
                      _f16_bytes(t.dmin.reshape(n, nsb)).reshape(n, nsb, 2),
                      scales, qh, qs], dim=-1)


def from_bytes_q5_k(raw: torch.Tensor) -> Q5_KTensor:
    """AoS u8 [N, K/256, 176] -> :class:`Q5_KTensor` (accepts llama.cpp's
    bytes), on ``raw``'s device."""
    n, nsb, bb = raw.shape
    if bb != QK5_BLOCK_BYTES:
        raise ValueError(f"q5_K blocks are {QK5_BLOCK_BYTES} bytes, got {bb}")
    ls, lm = _unpack_scales(raw[:, :, 4:16])
    qh = raw[:, :, 16:48]
    qs = raw[:, :, 48:176].reshape(n, nsb, 4, 32)
    codes = torch.stack(
        [torch.stack([(qs[:, :, j] & 0xF) | (((qh >> (2 * j)) & 1) << 4),
                      (qs[:, :, j] >> 4) | (((qh >> (2 * j + 1)) & 1) << 4)],
                     dim=2) for j in range(4)], dim=2).reshape(n, nsb * QK_K)
    return Q5_KTensor(_f16(raw, 0), _f16(raw, 2), ls.reshape(n, -1),
                      lm.reshape(n, -1), _planar(codes & 0xF),
                      pack_planar_bits(codes >> 4))


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


# ---------------------------------------------------------------------------
# the q6_K / q3_K / q2_K encoders (numpy host code, as in the JAX package)
# ---------------------------------------------------------------------------


def _k16_groups(x):
    x = np.asarray(x, np.float32)
    n, k = x.shape
    if k % QK_K:
        raise ValueError(f"K={k} must be a multiple of {QK_K}")
    return n, k, x.reshape(n, k // 16, 16)


def _sub_scales(f, d, lo, hi):
    """Per-16 sub-scales ``clip(rint(f / d), lo, hi)`` against the f16
    super-scale ``d`` (0 where ``d`` is 0) and ``d`` per 16, float32."""
    d32 = np.repeat(d.astype(np.float32), 16, axis=-1)
    sc = np.where(d32 > 0, np.rint(f / np.where(d32 > 0, d32, 1.0)), 0.0)
    return sc.clip(lo, hi), d32


def _inverse(scp, signed=False):
    ok = scp != 0 if signed else scp > 0
    return np.where(ok, 1.0 / np.where(ok, scp, 1.0), 0.0)


def quantize_q6_k(x) -> Q6_KTensor:
    """float [N, K] -> :class:`Q6_KTensor` of CPU tensors, K % 256 == 0:
    the JAX package's simplified two-level encoder (per-16 ``f =
    amax/31``, ``d = max f / 127`` per 256, ``sc = rint(f/d)``, codes
    ``rint(x / (d*sc))`` in [-32, 31])."""
    n, k, g = _k16_groups(x)
    f = np.abs(g).max(-1) / 31.0
    d = f16_sat(f.reshape(n, -1, 16).max(-1) / 127.0)
    sc, d32 = _sub_scales(f, d, 0, 127)
    sc = sc.astype(np.int8)
    inv = _inverse(d32 * sc.astype(np.float32))
    q = np.clip(np.rint(g * inv[..., None]), -32, 31).astype(np.int8)
    return Q6_KTensor(*_tensors(d, sc, q.reshape(n, k)))


def quantize_q3_k(x) -> Q3_KTensor:
    """float [N, K] -> :class:`Q3_KTensor` of CPU tensors (the JAX
    package's simplified encoder, codes in [-4, 3])."""
    n, k, g = _k16_groups(x)
    f = np.abs(g).max(-1) / 4.0
    d = f16_sat(f.reshape(n, -1, 16).max(-1) / 31.0)
    sc, d32 = _sub_scales(f, d, -32, 31)
    sc = sc.astype(np.int8)
    inv = _inverse(d32 * sc.astype(np.float32), signed=True)
    q = np.clip(np.rint(g * inv[..., None]), -4, 3).astype(np.int8)
    return Q3_KTensor(*_tensors(d, sc, q.reshape(n, k)))


def quantize_q2_k(x) -> Q2_KTensor:
    """float [N, K] -> :class:`Q2_KTensor` of CPU tensors (the JAX
    package's simplified encoder, ``x ~ d*sc*q - dmin*mn``, positive mins
    clamped to 0 as llama.cpp does)."""
    n, k, g = _k16_groups(x)
    mn_f = np.minimum(g.min(-1), 0.0)
    sc_f = (g.max(-1) - mn_f) / 3.0
    d = f16_sat(sc_f.reshape(n, -1, 16).max(-1) / 15.0)
    dmin = f16_sat((-mn_f).reshape(n, -1, 16).max(-1) / 15.0)
    sc, d32 = _sub_scales(sc_f, d, 0, 15)
    mn, dm32 = _sub_scales(-mn_f, dmin, 0, 15)
    sc, mn = sc.astype(np.uint8), mn.astype(np.uint8)
    mp = dm32 * mn.astype(np.float32)
    inv = _inverse(d32 * sc.astype(np.float32))
    q = np.clip(np.rint((g + mp[..., None]) * inv[..., None]), 0, 3)
    return Q2_KTensor(*_tensors(d, dmin, sc, mn,
                                q.astype(np.int8).reshape(n, k)))


#: per-16-scale containers (served by K7, ``kernels/gemm_exact_k16.py``)
K16_TENSORS = (Q2_KTensor, Q3_KTensor, Q6_KTensor)

#: container -> dequantizer (f32 [N, K])
DEQUANT = {
    Q4_KTensor: dequantize_q4_k,
    Q5_KTensor: dequantize_q5_k,
    Q2_KTensor: dequantize_q2_k,
    Q3_KTensor: dequantize_q3_k,
    Q6_KTensor: dequantize_q6_k,
}

#: GGUF type name -> (bytes per 256-element block, decoder, encoder)
CODECS = {
    "q4_K": (BLOCK_BYTES, from_bytes, to_bytes),
    "q5_K": (QK5_BLOCK_BYTES, from_bytes_q5_k, to_bytes_q5_k),
    "q6_K": (QK6_BLOCK_BYTES, from_bytes_q6_k, to_bytes_q6_k),
    "q2_K": (QK2_BLOCK_BYTES, from_bytes_q2_k, to_bytes_q2_k),
    "q3_K": (QK3_BLOCK_BYTES, from_bytes_q3_k, to_bytes_q3_k),
}

#: container type -> GGUF type name
GGUF_TYPE = {Q4_KTensor: "q4_K", Q5_KTensor: "q5_K", Q6_KTensor: "q6_K",
             Q2_KTensor: "q2_K", Q3_KTensor: "q3_K"}


def random_blocks(qtype: str, n: int, k: int, std: float,
                  generator: torch.Generator):
    """A container of random valid blocks on ``generator``'s device whose
    values have mean about 0 and standard deviation about ``std``: uniform
    codes, sub-scales drawn from a band that keeps the f16 scales normal
    at the usual widths, and (q4_K, q5_K, q2_K) mins that centre the
    codes.  For smoke runs and tests of full-width models without a
    checkpoint; ``qtype`` is a GGUF name (``"q4_K"``, ...)."""
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
    if qtype == "q5_K":  # x = d*ls*q - dmin*lm, q uniform 0..31 (sd 9.2)
        ls = ints(16, 64, n, k // QK).to(torch.uint8)
        d = f16(std / (9.2 * 40))
        dmin = (d.to(torch.float32) * 15.5).to(torch.float16)
        codes = ints(0, 32, n, k).to(torch.uint8)
        return Q5_KTensor(d, dmin, ls, ls.clone(), _planar(codes & 0xF),
                          pack_planar_bits(codes >> 4))
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


# IQ4_NL (block_iq4_nl, 18 bytes per 32 elements) and IQ4_XS
# (block_iq4_xs, 136 bytes per 256): llama.cpp's non-linear 4-bit
# formats, x = d * KVALUES_IQ4NL[q] (IQ4_NL) and x = d * (sc - 32) *
# KVALUES_IQ4NL[q] per 32-element sub-block (IQ4_XS, 6-bit sub-scales).
# The codebook holds int8 values, so both serve on the q8_0 path as the
# JAX package serves them: an IQ4_NL tensor decodes to a Q8_0Tensor (its
# f16 d verbatim), an IQ4_XS tensor to an :class:`EffectiveQ80` (int8
# codebook values and the float32 per-32 scales d * (sc - 32), which f16
# cannot hold), K1/K4/K6's ``iq4_xs`` form.

IQ4_NL_BLOCK_BYTES = 18
IQ4_XS_BLOCK_BYTES = 136  # 2 d + 2 scales_h + 4 scales_l + 128 qs
KVALUES_IQ4NL = (-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38,
                 53, 69, 89, 113)


class EffectiveQ80(NamedTuple):
    """q8_0-shaped view of an IQ4_XS tensor with float32 per-32 scales:
    ``x = qs * d``."""

    qs: torch.Tensor  # int8 [N, K] codebook values
    d: torch.Tensor  # f32 [N, K/32] effective scales d * (sc - 32)

    qtype = "iq4_xs"

    @property
    def k(self) -> int:
        return self.qs.shape[-1]


def _kvalues(q: torch.Tensor) -> torch.Tensor:
    """Codebook values of the 4-bit indices ``q`` (uint8) as int8."""
    lut = torch.tensor(KVALUES_IQ4NL, dtype=torch.int8, device=q.device)
    return lut[q.to(torch.int64)]


def _iq4_codes(qs: torch.Tensor) -> torch.Tensor:
    """u8 [..., 16] block bytes -> int8 [..., 32] values: byte j holds
    element j (low nibble) and j + 16 (high)."""
    return torch.cat([_kvalues(qs & 0xF), _kvalues(qs >> 4)], dim=-1)


def from_bytes_iq4_nl(raw: torch.Tensor):
    """AoS uint8 [N, K/32, 18] -> Q8_0Tensor of codebook values (``q * d``
    is llama.cpp's ``dequantize_row_iq4_nl``)."""
    from .blocks import Q8_0Tensor

    n, nb, bb = raw.shape
    if bb != IQ4_NL_BLOCK_BYTES:
        raise ValueError(f"iq4_nl blocks are {IQ4_NL_BLOCK_BYTES} bytes, "
                         f"got {bb}")
    codes = _iq4_codes(raw[:, :, 2:18]).reshape(n, nb * QK)
    return Q8_0Tensor(codes, _f16(raw, 0))


def quantize_iq4_nl(x) -> torch.Tensor:
    """IQ4_NL encoder -> AoS bytes u8 [N, K/32, 18], bit-equal to the JAX
    package's ``quantize_iq4_nl``: ``d = f16(amax / 127)`` and each value
    the nearest codebook entry of ``x / d`` (the first of two equally
    near ones).  As there, the scale is not searched the way llama.cpp's
    ``quantize_row_iq4_nl`` searches it; the bytes decode the same way."""
    from .quant import _blocks, _safe_inv, div, f16_sat

    x = torch.as_tensor(x, dtype=torch.float32)
    n = x.shape[0]
    xb = _blocks(x)  # [N, nb, 32]
    d = f16_sat(div(xb.abs().amax(dim=-1), 127.0))
    scaled = xb * _safe_inv(d)[..., None]
    lut = torch.tensor(KVALUES_IQ4NL, dtype=torch.float32, device=x.device)
    q = (scaled[..., None] - lut).abs().argmin(dim=-1).to(torch.uint8)
    return torch.cat([_f16_bytes(d), q[..., :16] | (q[..., 16:] << 4)],
                     dim=-1).reshape(n, -1, IQ4_NL_BLOCK_BYTES)


def _iq4_xs_scales(raw: torch.Tensor) -> torch.Tensor:
    """[N, nsb, 136] bytes -> int32 [N, nsb, 8]: the 6-bit sub-scales
    minus 32 (low four bits from ``scales_l``, high two from
    ``scales_h``)."""
    sh = raw[..., 2].to(torch.int32) | (raw[..., 3].to(torch.int32) << 8)
    sl = raw[..., 4:8].to(torch.int32)
    j = torch.arange(8, device=raw.device)
    lo = (sl[..., j // 2] >> (4 * (j % 2))) & 0xF
    hi = (sh[..., None] >> (2 * j)) & 3
    return (lo | (hi << 4)) - 32


def from_bytes_iq4_xs(raw: torch.Tensor) -> EffectiveQ80:
    """AoS uint8 [N, K/256, 136] -> :class:`EffectiveQ80` (``qs * d`` is
    llama.cpp's ``dequantize_row_iq4_xs``; the f16 ``d`` times an integer
    below 64 is exact in float32)."""
    n, nsb, bb = raw.shape
    if bb != IQ4_XS_BLOCK_BYTES:
        raise ValueError(f"iq4_xs blocks are {IQ4_XS_BLOCK_BYTES} bytes, "
                         f"got {bb}")
    d = _f16(raw, 0).to(torch.float32)
    eff = (d[..., None] * _iq4_xs_scales(raw).to(torch.float32))
    codes = _iq4_codes(raw[:, :, 8:136].reshape(n, nsb, 8, 16))
    return EffectiveQ80(codes.reshape(n, nsb * QK_K).contiguous(),
                        eff.reshape(n, nsb * NSB))


def dequantize_iq4(t) -> torch.Tensor:
    """float32 [N, K] of a decoded IQ4_NL (Q8_0Tensor) or IQ4_XS
    (:class:`EffectiveQ80`) tensor: ``qs * d`` per 32-block."""
    d = t.d.to(torch.float32).repeat_interleave(QK, dim=-1)
    return t.qs.to(torch.float32) * d


def random_iq4(qtype: str, n: int, k: int, std: float,
               generator: torch.Generator) -> torch.Tensor:
    """Random valid ``iq4_nl`` (u8 [N, K/32, 18]) or ``iq4_xs`` (u8 [N,
    K/256, 136]) block bytes on ``generator``'s device, values of mean
    about 0 and standard deviation about ``std``: uniform codebook
    indices (values of mean -5.9 and standard deviation about 69), f16
    scales +-25% around the target, and a random sign on each scale
    (iq4_nl's ``d``, iq4_xs's sub-scales ``sc - 32`` of 4 to 16), without
    which every weight would carry the codebook's mean."""
    dev = generator.device

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=generator, device=dev)

    def f16(mean, *shape):
        u = torch.rand(*shape, generator=generator, device=dev)
        return _f16_bytes((mean * (0.75 + 0.5 * u)).to(torch.float16))

    if qtype == "iq4_nl":
        nb = k // QK
        sign = ints(0, 2, n, nb) * 2 - 1
        return torch.cat([f16(sign * (std / 69.0), n, nb),
                          ints(0, 256, n, nb, 16).to(torch.uint8)], dim=-1)
    if qtype != "iq4_xs":
        raise NotImplementedError(f"random_iq4: {qtype}")
    nsb = k // QK_K
    sc = (ints(4, 17, n, nsb, 8) * (ints(0, 2, n, nsb, 8) * 2 - 1) + 32)
    j = torch.arange(8, device=dev)
    sh = ((sc >> 4) << (2 * j)).sum(-1)
    lo = sc & 0xF
    sl = lo[..., 0::2] | (lo[..., 1::2] << 4)
    return torch.cat([f16(std / (69.0 * 10.0), n, nsb),
                      (sh & 0xFF)[..., None].to(torch.uint8),
                      (sh >> 8)[..., None].to(torch.uint8),
                      sl.to(torch.uint8),
                      ints(0, 256, n, nsb, 128).to(torch.uint8)], dim=-1)


def k16_qtype(t) -> Optional[str]:
    """``"q2_k"``/``"q3_k"``/``"q6_k"`` for a per-16 container, else None."""
    return GGUF_TYPE[type(t)].lower() if isinstance(t, K16_TENSORS) else None


__all__ = ["QK_K", "NSB", "BLOCK_BYTES", "QK6_BLOCK_BYTES",
           "QK2_BLOCK_BYTES", "QK3_BLOCK_BYTES", "QK5_BLOCK_BYTES",
           "Q4_KTensor", "EffectiveQ41", "Q5_KTensor", "EffectiveQ51",
           "Q6_KTensor",
           "Q2_KTensor", "Q3_KTensor", "from_bytes", "to_bytes",
           "to_effective", "dequantize_q4_k", "quantize_q4_k",
           "quantize_q5_k", "to_effective_q5_k", "dequantize_q5_k",
           "to_bytes_q5_k", "quantize_q6_k", "quantize_q3_k",
           "quantize_q2_k",
           "from_bytes_q5_k", "from_bytes_q6_k",
           "to_bytes_q6_k", "dequantize_q6_k", "from_bytes_q2_k",
           "to_bytes_q2_k", "from_bytes_q3_k", "to_bytes_q3_k",
           "dequantize_q2_k", "dequantize_q3_k", "K16_TENSORS", "DEQUANT",
           "CODECS", "GGUF_TYPE", "random_blocks", "k16_qtype",
           "IQ4_NL_BLOCK_BYTES", "IQ4_XS_BLOCK_BYTES", "KVALUES_IQ4NL",
           "EffectiveQ80", "from_bytes_iq4_nl", "quantize_iq4_nl",
           "from_bytes_iq4_xs", "dequantize_iq4", "random_iq4"]
