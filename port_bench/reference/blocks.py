"""llama.cpp block dequantizers, written from ggml's block layouts.

``raw`` is ``uint8 [N, K / per, block bytes]``: the rows' blocks as a
GGUF file stores them.  Each returns float32 ``[N, K]`` on ``raw``'s
device.  ggml-common.h ``block_q4_0``: f16 ``d``, then 16 bytes whose low
nibbles are weights 0-15 and high nibbles 16-31, ``x = (q - 8) * d``.
``block_q6_K`` (256 weights): ``ql[128]``, ``qh[64]``, int8
``scales[16]``, f16 ``d``; ggml's ``dequantize_row_q6_K`` walks two
halves of 128 weights, each taking 64 bytes of ``ql``, 32 of ``qh`` and 8
scales, ``x = d * scale * (q - 32)``.
"""

from __future__ import annotations

import torch


def _f16(raw: torch.Tensor, at: int) -> torch.Tensor:
    """The little-endian f16 at byte ``at`` of each block, as float32
    ``[N, nb, 1]``."""
    two = raw[..., at:at + 2].contiguous()
    return two.view(torch.float16).to(torch.float32)


def q4_0(raw: torch.Tensor) -> torch.Tensor:
    n, nb, _ = raw.shape
    d = _f16(raw, 0)
    qs = raw[..., 2:18].to(torch.int32)
    q = torch.cat([qs & 0xF, qs >> 4], dim=-1).to(torch.float32)
    return ((q - 8.0) * d).reshape(n, nb * 32)


def q6_K(raw: torch.Tensor) -> torch.Tensor:
    n, nb, _ = raw.shape
    d = _f16(raw, 208)  # [N, nb, 1]
    sc = raw[..., 192:208].contiguous().view(torch.int8).to(torch.float32)
    halves = []
    for h in range(2):
        ql = raw[..., 64 * h: 64 * h + 64].to(torch.int32)
        qh = raw[..., 128 + 32 * h: 128 + 32 * h + 32].to(torch.int32)
        s = sc[..., 8 * h: 8 * h + 8]
        q1 = (ql[..., :32] & 0xF) | ((qh & 3) << 4)
        q2 = (ql[..., 32:] & 0xF) | (((qh >> 2) & 3) << 4)
        q3 = (ql[..., :32] >> 4) | (((qh >> 4) & 3) << 4)
        q4 = (ql[..., 32:] >> 4) | (((qh >> 6) & 3) << 4)
        for j, q in enumerate((q1, q2, q3, q4)):
            # weights 32j .. 32j + 31 of the half: scale 2j for l < 16,
            # 2j + 1 for l >= 16
            scale = torch.repeat_interleave(s[..., 2 * j: 2 * j + 2], 16,
                                            dim=-1)
            halves.append((q.to(torch.float32) - 32.0) * scale)
    x = torch.cat(halves, dim=-1) * d
    return x.reshape(n, nb * 256)


def f32(raw: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bytes ``uint8 [..., 4 k]`` as float32."""
    return raw.contiguous().view(torch.float32)


DEQUANT = {"q4_0": q4_0, "q6_K": q6_K}

__all__ = ["q4_0", "q6_K", "f32", "DEQUANT"]
