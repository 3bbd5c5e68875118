"""SiLU and the fused llama FFN activation, in plain PyTorch.

``silu(x) = x * sigmoid(x)``; ``silu_mul(x, gate) = silu(x) * gate``.
"""

from __future__ import annotations

import torch


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def silu_mul(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    return silu(x) * gate


__all__ = ["silu", "silu_mul"]
