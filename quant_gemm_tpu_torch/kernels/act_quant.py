"""Q8_1 activation quantization in one launch (``csrc/act_quant.cu``).

Not a TPU kernel: the JAX package quantizes an activation with one XLA
fusion (``quant_gemm_tpu/kernels/registry.py:148-157``) ahead of K1 and,
in prefill, of K4's bf16 operand.  Its plain version here is the torch
twin, :func:`formats.quant.quantize_q8_1` (about 27 eager ops), which
``registry.PLAIN`` keeps:

* :func:`quantize_q8_1` — float32 ``x`` [M, K] -> :class:`Q8_1Tensor`
  (codes int8 [M, K], f16 ``d`` and ``s`` [M, K/32]), bit-equal to the
  twin: the kernel runs ``csrc/common.cuh::quantize_q8_1_block``, the
  quantizer K1, K2, K6 and K8 share;
* :func:`quantize_fold_q8_1` — the bf16 [M, K] ``registry.fold_q8_1(
  quantize_q8_1(x))``, K4's operand on the prefill route.

Bound on an H100: bytes (x read once; the codes and scales, or the fold,
written once).  Each wrapper launches the kernel for a CUDA tensor and
runs the twin for a CPU tensor; ``<wrapper>.launches`` counts launches.
A launch that fails raises.
"""

from __future__ import annotations

import torch

from ..formats.blocks import QK, Q8_1Tensor
from ..formats.quant import expand_scale
from ..formats.quant import quantize_q8_1 as quantize_q8_1_plain
from . import _build


def quantize_fold_q8_1_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the twin, then ``qs * d`` in float32 rounded to
    bf16 (``registry.fold_q8_1``)."""
    a = quantize_q8_1_plain(x.to(torch.float32))
    return (a.qs.to(torch.float32) * expand_scale(a.d)).to(torch.bfloat16)


def _prepare(name: str, x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2 or x.dtype != torch.float32 or x.shape[1] % QK:
        raise ValueError(f"{name} takes float32 [M, K], K % {QK} == 0, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must be on a CUDA device or the CPU")
    return _build.aligned16(x.contiguous())


def quantize_q8_1(x: torch.Tensor) -> Q8_1Tensor:
    """Q8_1 of a float32 ``x`` [M, K] (codes, d, s)."""
    if x.device.type == "cpu":
        return quantize_q8_1_plain(x)
    x = _prepare("quantize_q8_1", x)
    m, k = x.shape
    dev = x.device
    qs = torch.empty(m, k, dtype=torch.int8, device=dev)
    d = torch.empty(m, k // QK, dtype=torch.float16, device=dev)
    s = torch.empty_like(d)
    fn = _build.function("act_quant", "qgt_quantize_q8_1",
                         [_build.P] * 4 + [_build.I] * 2 + [_build.P])
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(x), _build.ptr(qs), _build.ptr(d), _build.ptr(s),
                m, k, _build.stream(dev))
    _build.check("act_quant", "qgt_quantize_q8_1", rc)
    quantize_q8_1.launches += 1
    return Q8_1Tensor(qs, d, s)


quantize_q8_1.launches = 0


def quantize_fold_q8_1(x: torch.Tensor) -> torch.Tensor:
    """bf16 [M, K] ``qs * d`` of the Q8_1 of a float32 ``x`` [M, K]."""
    if x.device.type == "cpu":
        return quantize_fold_q8_1_plain(x)
    x = _prepare("quantize_fold_q8_1", x)
    m, k = x.shape
    out = torch.empty(m, k, dtype=torch.bfloat16, device=x.device)
    fn = _build.function("act_quant", "qgt_quantize_fold_q8_1",
                         [_build.P] * 2 + [_build.I] * 2 + [_build.P])
    with torch.cuda.device(x.device):
        rc = fn(_build.ptr(x), _build.ptr(out), m, k,
                _build.stream(x.device))
    _build.check("act_quant", "qgt_quantize_fold_q8_1", rc)
    quantize_fold_q8_1.launches += 1
    return out


quantize_fold_q8_1.launches = 0

__all__ = ["quantize_q8_1", "quantize_q8_1_plain", "quantize_fold_q8_1",
           "quantize_fold_q8_1_plain"]
