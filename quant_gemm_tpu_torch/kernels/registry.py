"""GEMM dispatch of the serving slice, and the kernel / plain op sets.

Counterpart of ``quant_gemm_tpu/kernels/registry.py::dispatch`` for the
cases the slice runs (q4_0 weights, K % 32 == 0):

* a float activation with ``quantize_act=True`` is quantized to Q8_1 by
  the torch twin (``formats.quant.quantize_q8_1``);
* a Q8_1 activation of M <= :data:`DECODE_M_MAX` rows takes K1
  (``gemm_exact``);
* anything else is folded to bf16 (``qs * d``, as ``gemm_pallas.py:
  554-562``) and takes K4 (``gemm_dequant``).  A float activation passed
  without ``quantize_act`` is cast to bf16 for K4; the model only passes
  such activations in bf16 already.

:data:`KERNELS` and :data:`PLAIN` name the five operations of the slice;
the model takes one of them (``ops=``), so a run can go through the plain
versions on purpose — on the card too — for a comparison.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..formats.blocks import Q8_1Tensor
from ..formats.quant import expand_scale, quantize_q8_1
from ..ops.attention import (flash_decode, flash_decode_plain,
                             flash_prefill, flash_prefill_plain)
from .gemm_dequant import gemm_dequant, gemm_dequant_plain
from .gemm_exact import gemm_exact, gemm_exact_plain
from .gemm_megalayer import norm_qkv, norm_qkv_plain


class Ops(NamedTuple):
    gemm_exact: Callable
    gemm_dequant: Callable
    norm_qkv: Callable
    flash_decode: Callable
    flash_prefill: Callable


#: the hand-written kernels (plain versions on CPU tensors)
KERNELS = Ops(gemm_exact, gemm_dequant, norm_qkv, flash_decode, flash_prefill)
#: the plain PyTorch versions, on any device
PLAIN = Ops(gemm_exact_plain, gemm_dequant_plain, norm_qkv_plain,
            flash_decode_plain, flash_prefill_plain)

# Decode-regime crossover between the exact kernel and the dequant kernel.
# A placeholder: 12 was measured on a TPU v5e (quant_gemm_tpu registry);
# the H100 crossover has not been measured.
DECODE_M_MAX = 12


def fold_q8_1(act: Q8_1Tensor) -> torch.Tensor:
    """Q8_1 -> bf16 ``qs * d`` (exact in float32, then rounded to bf16)."""
    return (act.qs.to(torch.float32) * expand_scale(act.d)).to(torch.bfloat16)


def dispatch(w, act, quantize_act: bool = False, ops: Ops = KERNELS):
    """``C[M, N] = act @ dequant(w)^T`` float32 through the slice's
    kernels (or the plain versions with ``ops=PLAIN``)."""
    if quantize_act and not isinstance(act, Q8_1Tensor):
        act = quantize_q8_1(act.to(torch.float32))
    if isinstance(act, Q8_1Tensor):
        if act.qs.shape[0] <= DECODE_M_MAX:
            return ops.gemm_exact(w, act)
        return ops.gemm_dequant(w, fold_q8_1(act))
    return ops.gemm_dequant(w, act.to(torch.bfloat16))


__all__ = ["Ops", "KERNELS", "PLAIN", "DECODE_M_MAX", "fold_q8_1",
           "dispatch"]
