"""RMSNorm in plain PyTorch (the JAX model runs it through XLA, not Pallas).

``y = x * rsqrt(mean(x^2) + eps) * weight`` in float32, in the operation
order of ``quant_gemm_tpu/ops/rms_norm.py::rms_norm`` (``csrc/norm_qkv.cu``
takes the same steps, summing the squares in its own order).
"""

from __future__ import annotations

import torch

EPS_DEFAULT = 1e-5


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = EPS_DEFAULT) -> torch.Tensor:
    x32 = x.to(torch.float32)
    ms = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps)
            * weight.to(torch.float32)).to(x.dtype)


__all__ = ["rms_norm", "EPS_DEFAULT"]
