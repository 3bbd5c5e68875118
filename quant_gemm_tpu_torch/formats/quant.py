"""Torch quantize/dequantize for the block formats, on any device.

Twins of the JAX package's ``formats/jax_quant.py``, bit-equal to
:mod:`.numpy_ref` (the tests hold them to it):

* the scale is ``f16_sat(amax / qmax)`` computed in float32;
* codes multiply by the safe reciprocal ``d > 0 ? 1/d : 0`` (not a
  division) and round half to even (``torch.round``);
* Q8_1's sum is ``s = f16_sat(f32(sum(q)) * d)``.

Containers are the planar SoA tuples of :mod:`.blocks` holding tensors.
"""

from __future__ import annotations

import torch

from ..utils import F16_MAX
from .blocks import QK, Q4_0Tensor, Q8_0Tensor, Q8_1Tensor


def f16_sat(x: torch.Tensor) -> torch.Tensor:
    """Saturating float32 -> float16 cast (round to nearest even)."""
    return x.clamp(-F16_MAX, F16_MAX).to(torch.float16)


def _blocks(x: torch.Tensor) -> torch.Tensor:
    k = x.shape[-1]
    if k % QK:
        raise ValueError(f"K={k} must be a multiple of {QK}")
    return x.reshape(x.shape[:-1] + (k // QK, QK)).to(torch.float32)


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


def quantize_q4_0(x: torch.Tensor) -> Q4_0Tensor:
    xb = _blocks(x)
    amax = xb.abs().amax(dim=-1)
    d = f16_sat(amax / 7.0)
    q = torch.round(xb * _safe_inv(d)[..., None]).clamp(-8, 7) + 8
    return Q4_0Tensor(pack_planar_4bit(q.reshape(x.shape)), d)


def quantize_q8_1(x: torch.Tensor) -> Q8_1Tensor:
    """Activation quantizer with the llama.cpp-exact s = f16(d * sum(q))."""
    xb = _blocks(x)
    amax = xb.abs().amax(dim=-1)
    d = f16_sat(amax / 127.0)
    q = torch.round(xb * _safe_inv(d)[..., None]).clamp(-127, 127)
    q = q.to(torch.int8)
    sum_q = q.to(torch.int32).sum(dim=-1)
    s = f16_sat(sum_q.to(torch.float32) * d.to(torch.float32))
    return Q8_1Tensor(q.reshape(x.shape), d, s)


QUANTIZE = {"q4_0": quantize_q4_0, "q8_1": quantize_q8_1}


def codes(t) -> torch.Tensor:
    """Raw stored integer codes ``int32[..., K]`` in natural order."""
    if isinstance(t, Q4_0Tensor):
        return unpack_planar_4bit(t.packed).to(torch.int32)
    if isinstance(t, (Q8_0Tensor, Q8_1Tensor)):
        return t.qs.to(torch.int32)
    raise TypeError(type(t))


def dequantize(t, dtype=torch.float32) -> torch.Tensor:
    """Dequantize a block tensor to ``dtype`` (default float32)."""
    x = (codes(t) - t.spec.offset).to(torch.float32) * expand_scale(t.d)
    return x.to(dtype)


__all__ = ["f16_sat", "expand_scale", "pack_planar_4bit",
           "unpack_planar_4bit", "quantize_q4_0",
           "quantize_q8_1", "QUANTIZE", "codes", "dequantize"]
