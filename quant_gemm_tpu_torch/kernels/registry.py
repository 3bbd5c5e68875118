"""GEMM dispatch of the serving slice, and the kernel / plain op sets.

Counterpart of ``quant_gemm_tpu/kernels/registry.py::dispatch`` for the
weights the port serves:

* per-32 weights (``layout.PreparedWeight``: q4_0, q4_1, q5_0, q5_1,
  q8_0, and q4_k / q5_k, a q4_K / q5_K tensor in its effective q4_1 /
  q5_1 form), K % 32 == 0:

  - a float activation with ``quantize_act=True`` of M <=
    :data:`DECODE_M_MAX` rows takes K6 (``gemm_exact_fused``: the Q8_1
    quantization inside the kernel, bit-identical to the unfused route)
    when :data:`FUSED_DECODE` is True and K6 has the weight's form
    (``gemm_exact.FUSED_QTYPES``: every form without a qh plane), as
    ``registry.py:199-205`` routes it; otherwise, and at any M,
    it is quantized to Q8_1 by one launch (``act_quant.quantize_q8_1``,
    bit-equal to the torch twin ``formats.quant.quantize_q8_1``);
  - a Q8_1 activation of M <= :data:`DECODE_M_MAX` rows takes K1
    (``gemm_exact``);
  - anything else is folded to bf16 (``qs * d``, as ``gemm_pallas.py:
    554-562``) and takes K4 (``gemm_dequant``); a float activation with
    ``quantize_act`` is quantized and folded in one launch
    (``act_quant.quantize_fold_q8_1``).  A float activation passed
    without ``quantize_act`` is cast to bf16 for K4; the model only passes
    such activations in bf16 already;

* per-16 K-quant weights (``layout.PreparedK16``: q6_K, q3_K, q2_K), as
  ``registry.py:177-195`` routes them:

  - at M <= :data:`DECODE_M_MAX` the activation is quantized to Q8_1 (if
    it is not already; ``act_quant.quantize_q8_1``) and takes K7
    (``gemm_exact_k16``);
  - at M > :data:`DECODE_M_MAX` (prefill), or for a float activation
    without ``quantize_act``, a Q8_1 activation is dequantized to float32
    (``qs * d``, keeping the A8 rounding; not K4's bf16 fold), a float one
    is used as it is, even with ``quantize_act``, and
    :func:`k16_dequant_gemm` multiplies it by the dequantized weight in
    float32 plain torch, the matmul the JAX package leaves to XLA
    (``_k16_dequant_gemm``).

Any other weight type raises: nothing falls back to a plain version.

:data:`KERNELS` and :data:`PLAIN` name the eight operations of the port;
the model takes one of them (``ops=``), so a run can go through the plain
versions on purpose — on the card too — for a comparison.  The
activation quantizers go with them (:func:`quantize`,
:func:`quantize_fold`): the launches of :mod:`.act_quant` on CUDA tensors
beside any op set but :data:`PLAIN`, the torch twins on CPU tensors or
beside it.  :func:`counters` reads every launch counter of the serving
path.

:data:`LADDER` is the JAX package's named kernel ladder (``kernels/
registry.py::KERNELS``), each rung ``fn(w, act)`` with ``w`` a planar SoA
container (or, for the kernel rungs, an already prepared weight) and
``act`` a float [M, K] or a Q8_1 activation:

==================  =====================================================
name                route
==================  =====================================================
xla_dequant         plain torch (``gemm_xla``): dequantize + matmul, a Q8_1
                    activation with its scales folded
xla_compensated     plain torch: the compensation formula, Q8_1 only
xla_int             plain torch: exact per-block integer dots, Q8_1 only
pallas_exact        K1 ``gemm_exact``, Q8_1 only
pallas_exact_fused  K6 ``gemm_exact_fused``, float activations
pallas_k16          K7 ``gemm_exact_k16`` (q6_K/q3_K/q2_K), Q8_1 only
pallas_f32          K4 ``gemm_dequant`` on a float32 activation (a Q8_1
                    one folded to float32)
pallas_bf16         K4 on a bf16 activation (a Q8_1 one folded to bf16)
pallas              the same as pallas_bf16 (JAX's f32 operands at DEFAULT
                    precision round them to bf16 in the MXU)
pallas_fused_quant  K4 with ``fused_quant``: a float activation
                    fake-quantized per 32-block in the kernel, the
                    operand bf16 (``a_dtype=torch.float32`` keeps it
                    float32, JAX's ``mxu_dtype``)
==================  =====================================================
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..formats.blocks import Q8_1Tensor
from ..formats.quant import expand_scale, quantize_q8_1
from ..ops.attention import (flash_decode, flash_decode_plain,
                             flash_prefill, flash_prefill_plain)
from . import act_quant, gemm_xla, layout
from .gemm_dequant import gemm_dequant, gemm_dequant_plain
from .gemm_exact import (FUSED_QTYPES, gemm_exact, gemm_exact_fused,
                         gemm_exact_fused_plain, gemm_exact_plain)
from .gemm_exact_k16 import gemm_exact_k16, gemm_exact_k16_plain
from .gemm_megalayer import (attn_tail, attn_tail_plain, norm_qkv,
                             norm_qkv_plain)
from .layout import PreparedK16, PreparedWeight, dequantize_k16


class Ops(NamedTuple):
    gemm_exact: Callable
    gemm_dequant: Callable
    norm_qkv: Callable
    flash_decode: Callable
    flash_prefill: Callable
    gemm_exact_k16: Callable
    gemm_exact_fused: Callable
    attn_tail: Callable


#: the hand-written kernels (plain versions on CPU tensors)
KERNELS = Ops(gemm_exact, gemm_dequant, norm_qkv, flash_decode, flash_prefill,
              gemm_exact_k16, gemm_exact_fused, attn_tail)
#: the plain PyTorch versions, on any device
PLAIN = Ops(gemm_exact_plain, gemm_dequant_plain, norm_qkv_plain,
            flash_decode_plain, flash_prefill_plain, gemm_exact_k16_plain,
            gemm_exact_fused_plain, attn_tail_plain)

# Decode-regime crossover between the exact kernels and the dequant route.
# A placeholder: 12 was measured on a TPU v5e (quant_gemm_tpu registry);
# the H100 crossover has not been measured.
DECODE_M_MAX = 12

# Decode W4A8 with a float activation: quantize inside the exact kernel
# (K6, True) or quantize in a launch of its own and run K1 (False).  Both are
# bit-identical.  False is the JAX default: the fused kernel measured 4-10
# us slower per GEMM on a TPU v5e (quant_gemm_tpu registry); its H100
# times are in PERF.md.
FUSED_DECODE = False


def fold_q8_1(act: Q8_1Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Q8_1 -> ``qs * d`` as ``dtype`` (exact in float32, then rounded to
    bf16 by default)."""
    return (act.qs.to(torch.float32) * expand_scale(act.d)).to(dtype)


def _twins(ops: Ops, x: torch.Tensor) -> bool:
    return ops is PLAIN or x.device.type == "cpu"


def quantize(x: torch.Tensor, ops: Ops = KERNELS) -> Q8_1Tensor:
    """Q8_1 of a float32 ``x`` [M, K]: one launch (``act_quant.
    quantize_q8_1``) on a CUDA tensor, the torch twin
    (:func:`quantize_q8_1`, looked up here at each call) on a CPU one or
    with ``ops=PLAIN``; the same bits."""
    if _twins(ops, x):
        return quantize_q8_1(x)
    return act_quant.quantize_q8_1(x)


def quantize_fold(x: torch.Tensor, ops: Ops = KERNELS) -> torch.Tensor:
    """``fold_q8_1(quantize(x))``, K4's bf16 operand on the prefill
    route: one launch (``act_quant.quantize_fold_q8_1``) on a CUDA
    tensor, the twin then :func:`fold_q8_1` on a CPU one or with
    ``ops=PLAIN``."""
    if _twins(ops, x):
        return fold_q8_1(quantize_q8_1(x))
    return act_quant.quantize_fold_q8_1(x)


def k16_dequant_gemm(w: PreparedK16, a: torch.Tensor) -> torch.Tensor:
    """The per-16 K-quants' prefill route: ``a`` float32 [M, K] times the
    float32-dequantized weight (plain torch; TF32 off on a card).
    ``k16_dequant_gemm.calls`` counts its calls."""
    k16_dequant_gemm.calls += 1
    return a.to(torch.float32) @ dequantize_k16(w).T


k16_dequant_gemm.calls = 0


def dispatch(w, act, quantize_act: bool = False, ops: Ops = KERNELS,
             route_m: Optional[int] = None):
    """``C[M, N] = act @ dequant(w)^T`` float32 through the slice's
    kernels (or the plain versions with ``ops=PLAIN``).  ``route_m``: the
    row count the route is chosen by, where it is not M (a prefill
    chunk's head on the rows read, which keep the chunk's route)."""
    m = (act.qs if isinstance(act, Q8_1Tensor) else act).shape[0]
    if route_m is not None:
        m = route_m
    if isinstance(w, PreparedK16):
        a8 = quantize_act or isinstance(act, Q8_1Tensor)
        if m > DECODE_M_MAX or not a8:
            if isinstance(act, Q8_1Tensor):
                act = act.qs.to(torch.float32) * expand_scale(act.d)
            return k16_dequant_gemm(w, act)
        if not isinstance(act, Q8_1Tensor):
            act = quantize(act.to(torch.float32), ops)
        return ops.gemm_exact_k16(w, act)
    if not isinstance(w, PreparedWeight):
        raise TypeError(f"dispatch: no kernel serves {type(w).__name__} "
                        "weights")
    if quantize_act and not isinstance(act, Q8_1Tensor):
        if FUSED_DECODE and m <= DECODE_M_MAX and w.qtype in FUSED_QTYPES:
            return ops.gemm_exact_fused(w, act.to(torch.float32))
        if m > DECODE_M_MAX:
            return ops.gemm_dequant(w, quantize_fold(act.to(torch.float32),
                                                   ops))
        act = quantize(act.to(torch.float32), ops)
    if isinstance(act, Q8_1Tensor):
        if m <= DECODE_M_MAX:
            return ops.gemm_exact(w, act)
        return ops.gemm_dequant(w, fold_q8_1(act))
    return ops.gemm_dequant(w, act.to(torch.bfloat16))


def counters() -> dict:
    """Every launch counter of the serving path by name: each kernel
    wrapper's and activation quantizer's ``launches``, and
    ``k16_dequant_gemm.calls`` (the per-16 prefill matmul)."""
    out = {name: fn.launches for name, fn in KERNELS._asdict().items()}
    out["quantize_q8_1"] = act_quant.quantize_q8_1.launches
    out["quantize_fold_q8_1"] = act_quant.quantize_fold_q8_1.launches
    out["k16_dequant_gemm"] = k16_dequant_gemm.calls
    return out


def _prepared(w) -> PreparedWeight:
    return w if isinstance(w, PreparedWeight) else layout.prepare(w)


def _need_q8_1(name, act):
    if not isinstance(act, Q8_1Tensor):
        raise TypeError(f"{name} takes a Q8_1 activation")


def _need_float(name, act):
    if isinstance(act, Q8_1Tensor):
        raise TypeError(f"{name} takes a float activation")


def _xla_dequant(w, act):
    if isinstance(act, Q8_1Tensor):
        return gemm_xla.gemm_wxa8_scaled(w, act)
    return gemm_xla.gemm_wxa16(w, act)


def _xla_compensated(w, act):
    _need_q8_1("xla_compensated", act)
    return gemm_xla.gemm_wxa8_compensated(w, act)


def _xla_int(w, act):
    _need_q8_1("xla_int", act)
    return gemm_xla.gemm_wxa8_int(w, act)


def _pallas_exact(w, act):
    _need_q8_1("pallas_exact", act)
    return gemm_exact(_prepared(w), act)


def _pallas_exact_fused(w, act):
    _need_float("pallas_exact_fused", act)
    return gemm_exact_fused(_prepared(w), act.to(torch.float32))


def _pallas_k16(w, act):
    _need_q8_1("pallas_k16", act)
    wk = w if isinstance(w, PreparedK16) else layout.prepare_k16(w)
    return gemm_exact_k16(wk, act)


def _pallas_f32(w, act):
    if isinstance(act, Q8_1Tensor):  # folded in float32, as JAX's f32 mode
        act = fold_q8_1(act, torch.float32)
    return gemm_dequant(_prepared(w), act.to(torch.float32))


def _pallas_bf16(w, act):
    a = fold_q8_1(act) if isinstance(act, Q8_1Tensor) else act
    return gemm_dequant(_prepared(w), a.to(torch.bfloat16))


def _pallas_fused_quant(w, act, a_dtype=torch.bfloat16):
    _need_float("pallas_fused_quant", act)
    return gemm_dequant(_prepared(w), act.to(torch.float32),
                        fused_quant=True, a_dtype=a_dtype)


#: the JAX package's kernel ladder under its names (module doc)
LADDER = {
    "xla_dequant": _xla_dequant,
    "xla_compensated": _xla_compensated,
    "xla_int": _xla_int,
    "pallas_exact": _pallas_exact,
    "pallas_exact_fused": _pallas_exact_fused,
    "pallas_k16": _pallas_k16,
    "pallas_f32": _pallas_f32,
    "pallas_bf16": _pallas_bf16,
    "pallas_fused_quant": _pallas_fused_quant,
    "pallas": _pallas_bf16,
}

__all__ = ["Ops", "KERNELS", "PLAIN", "LADDER", "DECODE_M_MAX",
           "FUSED_DECODE", "fold_q8_1", "quantize", "quantize_fold",
           "counters", "k16_dequant_gemm", "dispatch"]
