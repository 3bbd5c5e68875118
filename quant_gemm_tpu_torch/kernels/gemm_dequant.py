"""K4: dequant GEMM for prefill (bf16 activations x q4_0 weights).

Replaces the Pallas kernel ``quant_gemm_tpu/kernels/gemm_pallas.py::gemm``
(body ``_kernel_w4``): ``C[M, N] = A[M, K] @ ((q - 8) d)[N, K]^T`` with
float32 accumulation.  A Q8_1 activation is folded to bf16 before the
call, as ``gemm_pallas.py:554-562`` does (see :func:`.registry.dispatch`).

Bound on an H100: bytes at the slice's prefill chunks (M <= 48: 170
operations per weight byte, under the ~295 where bf16 tensor cores would
become the limit).  The first design (``csrc/gemm_dequant.cu``) is a plain
shared-memory tiled GEMM with float32 FMA on the CUDA cores; it is far
from that bound and moving it to the tensor cores is later work.

:func:`gemm_dequant` launches the kernel for CUDA tensors and runs
:func:`gemm_dequant_plain` for CPU tensors; ``gemm_dequant.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build, layout
from .layout import PreparedWeight


def _check(w: PreparedWeight, a: torch.Tensor) -> None:
    if w.qtype != "q4_0":
        raise NotImplementedError(f"gemm_dequant: {w.qtype} is not ported")
    if a.dim() != 2 or a.shape[1] != w.k:
        raise ValueError(f"activation {tuple(a.shape)} does not match K={w.k}")
    if a.dtype != torch.bfloat16:
        raise TypeError(f"gemm_dequant takes bf16 activations, got {a.dtype}")


def gemm_dequant_plain(w: PreparedWeight, a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the bf16 activation and the exactly
    dequantized weight multiplied in float32, as the JAX kernel does on its
    CPU reference backend (on a card, with TF32 off:
    ``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    _check(w, a)
    return a.to(torch.float32) @ layout.dequantize(w).T


def gemm_dequant(w: PreparedWeight, a: torch.Tensor) -> torch.Tensor:
    """``C[M, N]`` float32 of q4_0 ``w`` [N, K] and bf16 ``a`` [M, K]."""
    _check(w, a)
    dev = w.qs.device
    if dev.type == "cpu" and a.device.type == "cpu":
        return gemm_dequant_plain(w, a)
    if dev.type != "cuda" or a.device != dev or w.d.device != dev:
        raise ValueError("gemm_dequant: all operands must be on one CUDA "
                         "device (or all on the CPU)")
    m = a.shape[0]
    a = a.contiguous()
    out = torch.empty(m, w.n, dtype=torch.float32, device=dev)
    fn = _build.function("gemm_dequant", "qgt_gemm_dequant_q4_0",
                         [_build.P] * 4 + [_build.I] * 3 + [_build.P])
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(a), _build.ptr(w.qs), _build.ptr(w.d),
                _build.ptr(out), m, w.n, w.k, _build.stream(dev))
    _build.check("gemm_dequant", "qgt_gemm_dequant_q4_0", rc)
    gemm_dequant.launches += 1
    return out


gemm_dequant.launches = 0

__all__ = ["gemm_dequant", "gemm_dequant_plain"]
