"""RMSNorm: the model's plain PyTorch form and K9, the row kernel.

* :func:`rms_norm` — ``y = x * rsqrt(mean(x^2) + eps) * weight`` in
  float32, in the operation order of ``quant_gemm_tpu/ops/rms_norm.py::
  rms_norm``, which the JAX model runs through XLA (``csrc/norm_qkv.cu``
  takes the same steps, summing the squares in its own order).
* :func:`rms_norm_pallas` — K9, replacing the Pallas kernel ``quant_gemm_
  tpu/ops/rms_norm.py::rms_norm_pallas`` (body ``_rms_kernel``): ``x *
  rsqrt(sum(x^2) / C + eps) * weight`` over the rows of a float32 [R, C]
  ``x``.  Bound on an H100: bytes, x read once and the output written once;
  the design (``csrc/rms_norm.cu``, ``csrc/rows.cuh``): the row plan of
  :func:`.rows.plan`, each row held in registers (one read, every load
  issued before the first reduction), 16-byte loads where the data is
  aligned and ``C % 4 == 0``, a long row split over a thread-block cluster
  where the rows alone leave the SMs idle, the sum of squares in one fixed
  order and every other step IEEE-rounded as here, so the kernel differs
  from :func:`rms_norm_pallas_plain` only in that order.  It launches the
  kernel for CUDA tensors and runs :func:`rms_norm_pallas_plain` (the same
  steps in plain PyTorch) for CPU tensors; ``rms_norm_pallas.launches``
  counts launches.
* :func:`rms_norm_ref` — the golden (numpy, the sum of squares in
  float64), a copy of the JAX package's.

:func:`rms_norm` and :func:`rms_norm_pallas_plain` give the same bits on
the card as on the CPU wherever the two devices' sums of squares agree
(every sum exact, say; they add in other orders): the division by C is
the IEEE quotient by a tensor divisor (``formats/quant.py::div``; CUDA's
``torch.mean`` and division by a Python scalar multiply by the rounded
1/C instead), and the reciprocal square root :func:`rsqrt` is the CPU's
``torch.rsqrt``, the IEEE ``1 / sqrt``, on both (CUDA's ``torch.rsqrt``
is ``rsqrtf``, within 2 ulp).
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.quant import div
from ..kernels import _build
from . import rows

EPS_DEFAULT = 1e-5


def rsqrt(v: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(v)``, the square root and the quotient each rounded as
    IEEE float32 rounds them, on every device: ``torch.rsqrt`` on the CPU;
    on the card, where ``torch.rsqrt`` is CUDA's ``rsqrtf``, the IEEE
    square root divided into a tensor of ones (the CPU's ``torch.sqrt``
    is not correctly rounded, its ``torch.rsqrt`` is)."""
    if v.device.type == "cpu":
        return torch.rsqrt(v)
    return torch.ones_like(v) / torch.sqrt(v)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = EPS_DEFAULT) -> torch.Tensor:
    x32 = x.to(torch.float32)
    ms = div(torch.sum(x32 * x32, dim=-1, keepdim=True), x32.shape[-1])
    return (x32 * rsqrt(ms + eps) * weight.to(torch.float32)).to(x.dtype)


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
    ms = div(torch.sum(x * x, dim=-1, keepdim=True), x.shape[1])
    return x * rsqrt(ms + eps) * weight.to(torch.float32)


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
    p = rows.plan(r, c, x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    fn = _build.function("rms_norm", "qgt_rms_norm",
                         [_build.P] * 3 + [_build.I] * 2 + [_build.F]
                         + [_build.I] * 6 + [_build.P])
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(x), _build.ptr(w), _build.ptr(out), r, c,
                float(eps), *p, _build.stream(dev))
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


__all__ = ["rms_norm", "rms_norm_pallas", "rms_norm_pallas_plain", "rsqrt",
           "rms_norm_ref", "EPS_DEFAULT"]
