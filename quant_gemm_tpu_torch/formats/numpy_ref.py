"""CPU (numpy) reference quantize/dequantize for the six block formats: the
port's golden.

A copy of the JAX package's ``formats/numpy_ref.py``.  Semantics: round
half to even (``np.rint``), scales saturate to float16 (``f16_sat``), the
quantizers multiply by a safe reciprocal rather than divide, and Q8_1
stores ``s = f16(d * sum(q))``.  Every function takes ``[..., K]`` float
arrays and returns the planar containers of :mod:`.blocks`.
"""

from __future__ import annotations

import numpy as np

from ..utils import F16_MAX
from .blocks import (QK, Q4_0Tensor, Q4_1Tensor, Q5_0Tensor, Q5_1Tensor,
                     Q8_0Tensor, Q8_1Tensor)


def f16_sat(x):
    """Saturating cast to float16: stored block values clip to +-65504
    instead of overflowing to inf (an inf scale turns 0 * inf into NaN)."""
    return np.asarray(np.clip(x, -F16_MAX, F16_MAX), dtype=np.float16)


def pack_planar_4bit(q: np.ndarray) -> np.ndarray:
    """Pack 4-bit codes ``uint[..., K]`` -> ``uint8[..., K/2]`` planar:
    byte ``c`` holds ``q[..., c]`` (low) and ``q[..., c + K/2]`` (high)."""
    k = q.shape[-1]
    assert k % 2 == 0
    lo = q[..., : k // 2].astype(np.uint8)
    hi = q[..., k // 2 :].astype(np.uint8)
    return (lo & 0x0F) | (hi << 4)


def unpack_planar_4bit(packed: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_planar_4bit`; returns ``uint8[..., K]``."""
    return np.concatenate([packed & 0x0F, packed >> 4], axis=-1)


def pack_planar_bits(b: np.ndarray) -> np.ndarray:
    """Pack single bits ``uint[..., K]`` -> ``uint8[..., K/8]`` planar:
    bit ``c % 8`` of byte ``c // 8`` is ``b[..., c]`` (natural order)."""
    k = b.shape[-1]
    assert k % 8 == 0
    b = (b.astype(np.uint8) & 1).reshape(b.shape[:-1] + (k // 8, 8))
    shifts = np.arange(8, dtype=np.uint8)
    return (b << shifts).sum(axis=-1).astype(np.uint8)


def unpack_planar_bits(packed: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_planar_bits`; returns ``uint8[..., K]``."""
    shifts = np.arange(8, dtype=np.uint8)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))


def _blocks(x: np.ndarray) -> np.ndarray:
    k = x.shape[-1]
    assert k % QK == 0, f"K={k} must be a multiple of {QK}"
    return x.reshape(x.shape[:-1] + (k // QK, QK)).astype(np.float32)


def _safe_inv(d: np.ndarray) -> np.ndarray:
    """1/d in f32 with 0 where d == 0."""
    d32 = d.astype(np.float32)
    out = np.zeros_like(d32)
    np.divide(1.0, d32, out=out, where=d32 > 0)
    return out


def quantize_q4_0(x: np.ndarray) -> Q4_0Tensor:
    """d = amax/7, q = clip(rint(x/d), -8, 7) + 8."""
    xb = _blocks(x)
    amax = np.abs(xb).max(axis=-1)
    d = f16_sat(amax / 7.0)
    inv = _safe_inv(d)
    q = np.clip(np.rint(xb * inv[..., None]), -8, 7).astype(np.int8) + 8
    return Q4_0Tensor(pack_planar_4bit(q.reshape(x.shape)), d)


def quantize_q4_1(x: np.ndarray) -> Q4_1Tensor:
    """d = (max-min)/15, m = min, q = clip(rint((x-m)/d), 0, 15)."""
    xb = _blocks(x)
    mn = xb.min(axis=-1)
    mx = xb.max(axis=-1)
    d = f16_sat((mx - mn) / 15.0)
    m = f16_sat(mn)
    inv = _safe_inv(d)
    q = np.clip(np.rint((xb - mn[..., None]) * inv[..., None]), 0, 15)
    return Q4_1Tensor(pack_planar_4bit(q.astype(np.uint8).reshape(x.shape)),
                      d, m)


def quantize_q5_0(x: np.ndarray) -> Q5_0Tensor:
    """d = amax/15, q = clip(rint(x/d), -16, 15) + 16."""
    xb = _blocks(x)
    amax = np.abs(xb).max(axis=-1)
    d = f16_sat(amax / 15.0)
    inv = _safe_inv(d)
    q = np.clip(np.rint(xb * inv[..., None]) + 16, 0, 31).astype(np.uint8)
    q = q.reshape(x.shape)
    return Q5_0Tensor(pack_planar_4bit(q & 0x0F), pack_planar_bits(q >> 4), d)


def quantize_q5_1(x: np.ndarray) -> Q5_1Tensor:
    """d = (max-min)/31, m = min, q = clip(rint((x-m)/d), 0, 31)."""
    xb = _blocks(x)
    mn = xb.min(axis=-1)
    mx = xb.max(axis=-1)
    d = f16_sat((mx - mn) / 31.0)
    m = f16_sat(mn)
    inv = _safe_inv(d)
    q = np.clip(np.rint((xb - mn[..., None]) * inv[..., None]), 0, 31)
    q = q.astype(np.uint8).reshape(x.shape)
    return Q5_1Tensor(pack_planar_4bit(q & 0x0F), pack_planar_bits(q >> 4),
                      d, m)


def quantize_q8_0(x: np.ndarray) -> Q8_0Tensor:
    """d = amax/127, q = clip(rint(x/d), -127, 127)."""
    xb = _blocks(x)
    amax = np.abs(xb).max(axis=-1)
    d = f16_sat(amax / 127.0)
    inv = _safe_inv(d)
    q = np.clip(np.rint(xb * inv[..., None]), -127, 127).astype(np.int8)
    return Q8_0Tensor(q.reshape(x.shape), d)


def quantize_q8_1(x: np.ndarray) -> Q8_1Tensor:
    """Q8_0 codes plus the compensation sum s = f16(d * sum(q))."""
    xb = _blocks(x)
    amax = np.abs(xb).max(axis=-1)
    d = f16_sat(amax / 127.0)
    inv = _safe_inv(d)
    q = np.clip(np.rint(xb * inv[..., None]), -127, 127).astype(np.int8)
    sum_q = q.astype(np.int32).sum(axis=-1)
    s = f16_sat(sum_q.astype(np.float32) * d.astype(np.float32))
    return Q8_1Tensor(q.reshape(x.shape), d, s)


QUANTIZE = {"q4_0": quantize_q4_0, "q4_1": quantize_q4_1,
            "q5_0": quantize_q5_0, "q5_1": quantize_q5_1,
            "q8_0": quantize_q8_0, "q8_1": quantize_q8_1}


def codes(t) -> np.ndarray:
    """Raw stored integer codes ``int32[..., K]`` in natural K order (q4_0:
    the unshifted 0..15 nibbles; q5: the 0..31 codes with their 5th
    bit)."""
    if isinstance(t, (Q4_0Tensor, Q4_1Tensor)):
        return unpack_planar_4bit(np.asarray(t.packed)).astype(np.int32)
    if isinstance(t, (Q5_0Tensor, Q5_1Tensor)):
        lo = unpack_planar_4bit(np.asarray(t.packed)).astype(np.int32)
        hi = unpack_planar_bits(np.asarray(t.qh)).astype(np.int32)
        return lo | (hi << 4)
    if isinstance(t, (Q8_0Tensor, Q8_1Tensor)):
        return np.asarray(t.qs).astype(np.int32)
    raise TypeError(type(t))


def dequantize(t) -> np.ndarray:
    """Dequantize a block tensor back to float32 ``[..., K]``."""
    q = codes(t)
    spec = t.spec
    d = np.repeat(np.asarray(t.d).astype(np.float32), QK, axis=-1)
    if spec.has_min:
        m = np.repeat(np.asarray(t.m).astype(np.float32), QK, axis=-1)
        return q.astype(np.float32) * d + m
    return (q - spec.offset).astype(np.float32) * d


__all__ = ["f16_sat", "pack_planar_4bit", "unpack_planar_4bit",
           "pack_planar_bits", "unpack_planar_bits", "quantize_q4_0",
           "quantize_q4_1", "quantize_q5_0", "quantize_q5_1",
           "quantize_q8_0", "quantize_q8_1", "QUANTIZE", "codes",
           "dequantize"]
