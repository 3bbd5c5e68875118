"""Torch quantize/dequantize for the block formats, on any device.

Twins of the JAX package's ``formats/jax_quant.py``, bit-equal to
:mod:`.numpy_ref` (the tests hold them to it):

* the scale is ``f16_sat(amax / qmax)`` (q4_1/q5_1: ``f16_sat((max -
  min) / qmax)`` and ``m = f16_sat(min)``) computed in float32;
* codes multiply by the safe reciprocal ``d > 0 ? 1/d : 0`` (not a
  division) and round half to even (``torch.round``); the asymmetric
  formats subtract the float32 block min, not the stored f16 ``m``;
* Q8_1's sum is ``s = f16_sat(f32(sum(q)) * d)``.

Containers are the planar SoA tuples of :mod:`.blocks` holding tensors.
"""

from __future__ import annotations

import torch

from ..utils import F16_MAX
from .blocks import (QK, Q4_0Tensor, Q4_1Tensor, Q5_0Tensor, Q5_1Tensor,
                     Q8_0Tensor, Q8_1Tensor)


def f16_sat(x: torch.Tensor) -> torch.Tensor:
    """Saturating float32 -> float16 cast (round to nearest even)."""
    return x.clamp(-F16_MAX, F16_MAX).to(torch.float16)


def _blocks(x: torch.Tensor) -> torch.Tensor:
    k = x.shape[-1]
    if k % QK:
        raise ValueError(f"K={k} must be a multiple of {QK}")
    return x.reshape(x.shape[:-1] + (k // QK, QK)).to(torch.float32)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as the IEEE float32 quotient on every device.  PyTorch's
    CUDA division by a Python scalar multiplies by the scalar's rounded
    reciprocal instead, which can move the last bit, and with it an f16
    scale at a rounding tie, away from numpy's, JAX's and the kernels'
    quotient; a tensor divisor takes the true division."""
    return x / torch.full_like(x, c)


def _safe_inv(d_f16: torch.Tensor) -> torch.Tensor:
    d = d_f16.to(torch.float32)
    return torch.where(d > 0, 1.0 / torch.where(d > 0, d, 1.0),
                       torch.zeros_like(d))


def expand_scale(d: torch.Tensor) -> torch.Tensor:
    """Per-block scale [..., nb] -> per-element float32 [..., nb*32]."""
    return d.to(torch.float32).repeat_interleave(QK, dim=-1)


def pack_planar_4bit(q: torch.Tensor) -> torch.Tensor:
    k = q.shape[-1]
    lo = q[..., : k // 2].to(torch.uint8)
    hi = q[..., k // 2 :].to(torch.uint8)
    return (lo & 0x0F) | (hi << 4)


def unpack_planar_4bit(packed: torch.Tensor) -> torch.Tensor:
    return torch.cat([packed & 0x0F, packed >> 4], dim=-1)


_SHIFTS = (0, 1, 2, 3, 4, 5, 6, 7)


def pack_planar_bits(b: torch.Tensor) -> torch.Tensor:
    """Single bits ``[..., K]`` -> ``uint8[..., K/8]``: bit ``c % 8`` of
    byte ``c // 8`` is ``b[..., c]``."""
    k = b.shape[-1]
    b = (b.to(torch.uint8) & 1).reshape(b.shape[:-1] + (k // 8, 8))
    shifts = torch.tensor(_SHIFTS, dtype=torch.uint8, device=b.device)
    return (b << shifts).sum(dim=-1).to(torch.uint8)


def unpack_planar_bits(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_planar_bits`: ``uint8[..., K]`` of 0/1."""
    shifts = torch.tensor(_SHIFTS, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))


def quantize_q4_0(x: torch.Tensor) -> Q4_0Tensor:
    xb = _blocks(x)
    amax = xb.abs().amax(dim=-1)
    d = f16_sat(div(amax, 7.0))
    q = torch.round(xb * _safe_inv(d)[..., None]).clamp(-8, 7) + 8
    return Q4_0Tensor(pack_planar_4bit(q.reshape(x.shape)), d)


def quantize_q4_1(x: torch.Tensor) -> Q4_1Tensor:
    xb = _blocks(x)
    mn, mx = xb.amin(dim=-1), xb.amax(dim=-1)
    d = f16_sat(div(mx - mn, 15.0))
    q = torch.round((xb - mn[..., None]) * _safe_inv(d)[..., None])
    q = q.clamp(0, 15).to(torch.uint8)
    return Q4_1Tensor(pack_planar_4bit(q.reshape(x.shape)), d, f16_sat(mn))


def quantize_q5_0(x: torch.Tensor) -> Q5_0Tensor:
    xb = _blocks(x)
    amax = xb.abs().amax(dim=-1)
    d = f16_sat(div(amax, 15.0))
    q = (torch.round(xb * _safe_inv(d)[..., None]) + 16).clamp(0, 31)
    q = q.to(torch.uint8).reshape(x.shape)
    return Q5_0Tensor(pack_planar_4bit(q & 0x0F), pack_planar_bits(q >> 4), d)


def quantize_q5_1(x: torch.Tensor) -> Q5_1Tensor:
    xb = _blocks(x)
    mn, mx = xb.amin(dim=-1), xb.amax(dim=-1)
    d = f16_sat(div(mx - mn, 31.0))
    q = torch.round((xb - mn[..., None]) * _safe_inv(d)[..., None])
    q = q.clamp(0, 31).to(torch.uint8).reshape(x.shape)
    return Q5_1Tensor(pack_planar_4bit(q & 0x0F), pack_planar_bits(q >> 4),
                      d, f16_sat(mn))


def quantize_q8_0(x: torch.Tensor) -> Q8_0Tensor:
    xb = _blocks(x)
    amax = xb.abs().amax(dim=-1)
    d = f16_sat(div(amax, 127.0))
    q = torch.round(xb * _safe_inv(d)[..., None]).clamp(-127, 127)
    return Q8_0Tensor(q.to(torch.int8).reshape(x.shape), d)


def quantize_q8_1(x: torch.Tensor) -> Q8_1Tensor:
    """Activation quantizer with the llama.cpp-exact s = f16(d * sum(q))."""
    xb = _blocks(x)
    amax = xb.abs().amax(dim=-1)
    d = f16_sat(div(amax, 127.0))
    q = torch.round(xb * _safe_inv(d)[..., None]).clamp(-127, 127)
    q = q.to(torch.int8)
    sum_q = q.to(torch.int32).sum(dim=-1)
    s = f16_sat(sum_q.to(torch.float32) * d.to(torch.float32))
    return Q8_1Tensor(q.reshape(x.shape), d, s)


QUANTIZE = {"q4_0": quantize_q4_0, "q4_1": quantize_q4_1,
            "q5_0": quantize_q5_0, "q5_1": quantize_q5_1,
            "q8_0": quantize_q8_0, "q8_1": quantize_q8_1}


def codes(t) -> torch.Tensor:
    """Raw stored integer codes ``int32[..., K]`` in natural order."""
    if isinstance(t, (Q4_0Tensor, Q4_1Tensor)):
        return unpack_planar_4bit(t.packed).to(torch.int32)
    if isinstance(t, (Q5_0Tensor, Q5_1Tensor)):
        lo = unpack_planar_4bit(t.packed).to(torch.int32)
        return lo | (unpack_planar_bits(t.qh).to(torch.int32) << 4)
    if isinstance(t, (Q8_0Tensor, Q8_1Tensor)):
        return t.qs.to(torch.int32)
    raise TypeError(type(t))


def dequantize(t, dtype=torch.float32) -> torch.Tensor:
    """Dequantize a block tensor to ``dtype`` (default float32): ``(q -
    offset) * d``, or ``q * d + m`` for q4_1/q5_1."""
    q = codes(t)
    if t.spec.has_min:
        x = q.to(torch.float32) * expand_scale(t.d) + expand_scale(t.m)
    else:
        x = (q - t.spec.offset).to(torch.float32) * expand_scale(t.d)
    return x.to(dtype)


__all__ = ["f16_sat", "div", "expand_scale", "pack_planar_4bit",
           "unpack_planar_4bit", "pack_planar_bits", "unpack_planar_bits",
           "quantize_q4_0", "quantize_q4_1", "quantize_q5_0",
           "quantize_q5_1", "quantize_q8_0", "quantize_q8_1", "QUANTIZE",
           "codes", "dequantize"]
