"""RMSNorm: the model's plain PyTorch form and K9, the row kernel.

* :func:`rms_norm` — ``y = x * rsqrt(mean(x^2) + eps) * weight`` in
  float32, in the operation order of ``quant_gemm_tpu/ops/rms_norm.py::
  rms_norm``, which the JAX model runs through XLA (``csrc/norm_qkv.cu``
  takes the same steps, summing the squares in its own order).
* :func:`rms_norm_pallas` — K9, replacing the Pallas kernel ``quant_gemm_
  tpu/ops/rms_norm.py::rms_norm_pallas`` (body ``_rms_kernel``): ``x *
  rsqrt(sum(x^2) / C + eps) * weight`` over the rows of a float32 [R, C]
  ``x``.  Bound on an H100: bytes, x read once and the output written once;
  the design (``csrc/rms_norm.cu``): one warp per row up to C = 1024, one
  256-thread block per row above, coalesced scalar accesses, so a ragged C
  needs no padding.  It launches the kernel for CUDA tensors and runs
  :func:`rms_norm_pallas_plain` (the same steps in plain PyTorch) for CPU
  tensors; ``rms_norm_pallas.launches`` counts launches.
* :func:`rms_norm_ref` — the golden (numpy, the sum of squares in
  float64), a copy of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build

EPS_DEFAULT = 1e-5


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = EPS_DEFAULT) -> torch.Tensor:
    x32 = x.to(torch.float32)
    ms = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps)
            * weight.to(torch.float32)).to(x.dtype)


def _check(x: torch.Tensor, weight: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"rms_norm_pallas takes float32 [R, C], got "
                        f"{x.dtype} {tuple(x.shape)}")
    if weight.shape != (x.shape[1],):
        raise ValueError(f"weight {tuple(weight.shape)} does not match C="
                         f"{x.shape[1]}")


def rms_norm_pallas_plain(x: torch.Tensor, weight: torch.Tensor,
                          eps: float = EPS_DEFAULT) -> torch.Tensor:
    """Plain PyTorch version, in ``_rms_kernel``'s order: the sum of
    squares divided by C (not ``mean``)."""
    _check(x, weight)
    ms = torch.sum(x * x, dim=-1, keepdim=True) / float(x.shape[1])
    return x * torch.rsqrt(ms + eps) * weight.to(torch.float32)


def rms_norm_pallas(x: torch.Tensor, weight: torch.Tensor,
                    eps: float = EPS_DEFAULT) -> torch.Tensor:
    """RMSNorm of each row of a float32 ``x`` [R, C] with ``weight`` [C];
    float32 [R, C]."""
    _check(x, weight)
    if x.device.type == "cpu" and weight.device.type == "cpu":
        return rms_norm_pallas_plain(x, weight, eps)
    dev = x.device
    if dev.type != "cuda" or weight.device != dev:
        raise ValueError("rms_norm_pallas: x and weight must be on one CUDA "
                         "device (or both on the CPU)")
    r, c = x.shape
    x = x.contiguous()
    w = weight.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    fn = _build.function("rms_norm", "qgt_rms_norm",
                         [_build.P] * 3 + [_build.I] * 2
                         + [_build.F, _build.P])
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(x), _build.ptr(w), _build.ptr(out), r, c,
                float(eps), _build.stream(dev))
    _build.check("rms_norm", "qgt_rms_norm", rc)
    rms_norm_pallas.launches += 1
    return out


rms_norm_pallas.launches = 0


def rms_norm_ref(x, weight, eps: float = EPS_DEFAULT) -> np.ndarray:
    """The golden: the sum of squares in float64 (numpy arrays)."""
    x = np.asarray(x, np.float32)
    ss = (x.astype(np.float64) ** 2).sum(axis=-1, keepdims=True)
    rms = np.sqrt((ss / x.shape[-1]).astype(np.float32) + np.float32(eps))
    return x / rms * np.asarray(weight, np.float32)


__all__ = ["rms_norm", "rms_norm_pallas", "rms_norm_pallas_plain",
           "rms_norm_ref", "EPS_DEFAULT"]
