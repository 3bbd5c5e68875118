"""The port's device weight layout for q4_0 (counterpart of the JAX
package's ``gemm_pallas.PreparedWeight`` / ``prepare``).

The TPU layout (K-major planar nibbles, bytes stored XOR 0x80, f32 scale
planes, K and N padded to 256) works around Mosaic's lowering and does not
carry over.  Hopper's GEMV-shaped kernels want each output row's bytes
contiguous, so the port stores, per weight row ``n`` (N-major):

* ``qs: uint8[N, K/2]`` — block ``b``'s 16 code bytes at
  ``[16b, 16b + 16)``, byte ``j`` holding code ``32b + j`` in its low
  nibble and code ``32b + j + 16`` in its high nibble: exactly the
  ``qs`` field of llama.cpp's ``block_q4_0``, so one 16-byte load per lane
  brings a whole block;
* ``d: float16[N, K/32]`` — the block scales as stored in GGUF.

No padding: the kernels mask ragged N themselves and need K % 32 == 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..formats.blocks import QK, Q4_0Tensor
from ..formats.quant import unpack_planar_4bit


class PreparedWeight(NamedTuple):
    qtype: str  # format name ("q4_0")
    n: int  # out-features
    k: int  # reduction dim
    qs: torch.Tensor  # uint8 [N, K/2], GGUF block order (see module doc)
    d: torch.Tensor  # float16 [N, K/32]


def prepare(w_q: Q4_0Tensor) -> PreparedWeight:
    """Re-lay a planar row-major Q4_0 container (torch tensors) into the
    kernel layout, on the container's device."""
    if not isinstance(w_q, Q4_0Tensor):
        raise NotImplementedError(
            f"prepare: only q4_0 weights are ported, got {type(w_q).__name__}")
    packed = torch.as_tensor(w_q.packed)
    n, khalf = packed.shape
    k = 2 * khalf
    if k % QK:
        raise ValueError(f"K={k} must be a multiple of {QK}")
    c = unpack_planar_4bit(packed).reshape(n, k // QK, 2, QK // 2)
    qs = (c[:, :, 0] | (c[:, :, 1] << 4)).reshape(n, khalf).contiguous()
    d = torch.as_tensor(w_q.d).to(device=packed.device,
                                  dtype=torch.float16).contiguous()
    return PreparedWeight("q4_0", n, k, qs, d)


def codes(w: PreparedWeight) -> torch.Tensor:
    """Raw 0..15 codes ``uint8[N, K]`` in natural K order."""
    b = w.qs.reshape(w.n, w.k // QK, QK // 2)
    return torch.cat([b & 0x0F, b >> 4], dim=-1).reshape(w.n, w.k)


def dequantize(w: PreparedWeight, dtype=torch.float32) -> torch.Tensor:
    """``(q - 8) * d`` as ``dtype [N, K]`` (exact in float32)."""
    q = codes(w).to(torch.float32).reshape(w.n, w.k // QK, QK) - 8.0
    return (q * w.d.to(torch.float32)[..., None]).reshape(w.n, w.k).to(dtype)


__all__ = ["PreparedWeight", "prepare", "codes", "dequantize"]
