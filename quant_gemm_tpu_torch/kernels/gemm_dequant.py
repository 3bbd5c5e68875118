"""K4: dequant GEMM for prefill (bf16 or float32 activations x per-32
weights: q4_0, q4_1, q5_0, q5_1, q8_0, q4_k, q5_k, iq4_xs), and its
``fused_quant`` form.

Replaces the Pallas kernel ``quant_gemm_tpu/kernels/gemm_pallas.py::gemm``
(bodies ``_kernel_w4`` and, for q8_0, ``_kernel_w8``): ``C[M, N] = A[M, K]
@ W[N, K]^T`` with float32 accumulation, ``W = (q - 8) d`` (q4_0), ``(q -
16) d`` (q5_0, the 5th bit from ``qh``), ``q d`` (q8_0, and iq4_xs with
an IQ4_XS tensor's codebook values and float32 ``d``) and ``q d + m``
(q4_1, q5_1, and q4_k / q5_k with the effective f32 scale and min of a
q4_K / q5_K tensor: ``has_min``).  A is bf16, the serving prefill's (a
Q8_1 activation is folded to bf16 before the call, as ``gemm_pallas.py:
554-562`` does; see :func:`.registry.dispatch`), or float32, the JAX
ladder's ``pallas_f32``, which keeps A in f32.

``fused_quant=True`` (``gemm_pallas.py``'s ``fused_quant``, the body
``_fake_quant_q8``) fake-quantizes a float A per 32-block inside the
kernel's A-tile prologue: ``d = amax / 127`` in float32, ``inv = 1/d``
(0 where ``d`` is 0), ``q = clip(rint(a * inv), -127, 127)``, ``a' = q *
d``, each step rounded on its own, so ``a'`` is bit-equal to
:func:`fake_quant_q8`'s; ``a'`` then goes in the operand type
``a_dtype``: bf16 by default, float32 where the caller asks (JAX's
``mxu_dtype``).  This is **not** Q8_1: ``d`` is not rounded to f16 and no
``s = d * sum(q)`` is formed.

Bound on an H100: operations at the Server's prefill chunk of 128 rows
(455 operations per q4_0 weight byte, above the ~295 where the bf16
tensor cores become the limit; bytes only below M of about 80): 0.0304
ms of bf16 tensor-core work at Mistral-7B's ``wgu`` (N 28672, K 4096),
0.0060 ms at TinyLlama-1.1B's (N 11264, K 2048); the float32 forms do
three bf16 passes, 0.0456 ms at Mistral-7B's ``w_down`` (N 4096, K 14336).
Design (``csrc/gemm_dequant.cu``): every form runs on the tensor cores
(``mma.sync`` bf16, float32 accumulation) with exact per-block scaling:
each 32-block's codes are small integers, exact in bf16, so every
product is exact and the block's sum is folded in as ``d * T_b`` (``+ m
* sum(A_b)`` for the min formats); the weight is never rounded.  A bf16
operand (a bf16 ``a``, or ``fused_quant`` with ``a_dtype=bf16``) is one
bf16 piece; a float32 operand (the ladder's ``pallas_f32``,
``fused_quant`` with ``a_dtype=float32``) is split into three,
:func:`split3`, whose sum is the operand exactly: JAX's
``Precision.HIGHEST`` (``gemm_pallas.py::_dot``), a multi-pass bf16
product.  So the result differs from :func:`gemm_dequant_plain` only in
float32 summation order.  Where the 64 x 64 output tiles do not fill the
card, K is split into pieces (:func:`k4_grid`) whose float32 partials a
second kernel adds in piece order, so every call gives the same bits.

:func:`gemm_dequant` launches the kernel for CUDA tensors and runs
:func:`gemm_dequant_plain` for CPU tensors; ``gemm_dequant.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from ..formats.blocks import QK
from ..formats.quant import div
from . import _build, layout
from .layout import QTYPES, PreparedWeight, planes

ACT_DTYPES = (torch.bfloat16, torch.float32)

#: the tensor-core body's output tile (rows, columns: ``TBM``, ``TBN`` of
#: ``csrc/gemm_dequant.cu``) and the H100's SMs
TILE_M, TILE_N, SMS = 64, 64, 132
#: fewest quant blocks in a K piece
MIN_CHUNK = 2


def k4_grid(m: int, n: int, k: int) -> tuple:
    """The tensor-core body's grid ``(tiles_n, tiles_m, pieces)`` and the
    K piece length ``chunk`` in 32-blocks (piece z takes blocks ``[z *
    chunk, min(nb, (z + 1) * chunk))``, none empty).  K is split only
    where the output tiles do not fill the card's SMs: into about
    ``SMS / tiles`` pieces of at least ``MIN_CHUNK`` blocks."""
    tn, tm = -(-n // TILE_N), -(-m // TILE_M)
    nb = k // QK
    want = -(-SMS // (tn * tm))
    chunk = nb if want <= 1 else max(MIN_CHUNK, nb // want)
    chunk = min(chunk, nb)
    return (tn, tm, -(-nb // chunk)), chunk


def pieces(a: torch.Tensor, fused_quant: bool, a_dtype) -> int:
    """The bf16 pieces the tensor-core body takes the operand in: 1 for a
    bf16 operand (a bf16 activation, or ``fused_quant`` into bf16), 3 for
    a float32 one (:func:`split3`)."""
    if fused_quant:
        return 1 if a_dtype == torch.bfloat16 else 3
    return 1 if a.dtype == torch.bfloat16 else 3


def split3(a: torch.Tensor) -> tuple:
    """The prologue's split of a float32 operand into bf16 pieces: ``hi =
    bf16(a)``, ``mid = bf16(a - hi)``, ``lo = bf16(a - hi - mid)``, each
    difference exact in float32, so ``hi + mid + lo == a`` exactly where
    the pieces stay normal in bf16 (``|a| >= 2**-103`` or ``a == 0``)."""
    a = a.to(torch.float32)
    hi = a.to(torch.bfloat16)
    r = a - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def _check(w: PreparedWeight, a: torch.Tensor, a_dtype=None) -> None:
    if w.qtype not in QTYPES:
        raise NotImplementedError(f"gemm_dequant: {w.qtype} is not ported")
    if a.dim() != 2 or a.shape[1] != w.k:
        raise ValueError(f"activation {tuple(a.shape)} does not match K={w.k}")
    if a.dtype not in ACT_DTYPES:
        raise TypeError(f"gemm_dequant takes bf16 or float32 activations, "
                        f"got {a.dtype}")
    if a_dtype is not None and a_dtype not in ACT_DTYPES:
        raise TypeError(f"fused_quant operands are bf16 or float32, not "
                        f"{a_dtype}")


def fake_quant_q8(a: torch.Tensor) -> torch.Tensor:
    """The JAX ``_fake_quant_q8``: float32 ``q * d`` per 32-block of ``a``
    [M, K], ``d = amax / 127`` (float32), ``q = clip(rint(a / d), -127,
    127)`` (``a * (1/d)``; 0 where ``d`` is 0)."""
    m, k = a.shape
    blocks = a.to(torch.float32).reshape(m, k // QK, QK)
    d = div(blocks.abs().amax(dim=-1, keepdim=True), 127.0)
    inv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, 1.0), 0.0)
    q = torch.clamp(torch.round(blocks * inv), -127.0, 127.0)
    return (q * d).reshape(m, k)


def gemm_dequant_plain(w: PreparedWeight, a: torch.Tensor,
                       fused_quant: bool = False,
                       a_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version: the activation (with ``fused_quant``,
    :func:`fake_quant_q8` of it rounded to ``a_dtype``) and the weight
    dequantized in float32 (``layout.dequantize``) multiplied in float32,
    as the JAX kernel does on its CPU reference backend (on a card, with
    TF32 off: ``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    _check(w, a, a_dtype if fused_quant else None)
    if fused_quant:
        a = fake_quant_q8(a).to(a_dtype)
    return a.to(torch.float32) @ layout.dequantize(w).T


def gemm_dequant(w: PreparedWeight, a: torch.Tensor,
                 fused_quant: bool = False,
                 a_dtype=torch.bfloat16) -> torch.Tensor:
    """``C[M, N]`` float32 of a per-32 ``w`` [N, K] (``layout.QTYPES``)
    and a bf16 or float32 ``a`` [M, K]; with ``fused_quant``, ``a``
    fake-quantized per 32-block in the kernel, the operand in
    ``a_dtype``."""
    _check(w, a, a_dtype if fused_quant else None)
    dev = w.qs.device
    wp = planes(w)
    if dev.type == "cpu" and a.device.type == "cpu":
        return gemm_dequant_plain(w, a, fused_quant, a_dtype)
    if dev.type != "cuda" or any(t.device != dev for t in (a, *wp)):
        raise ValueError("gemm_dequant: all operands must be on one CUDA "
                         "device (or all on the CPU)")
    m = a.shape[0]
    a = a.contiguous()
    _build.check_aligned("gemm_dequant", a, w.qs)
    out = torch.empty(m, w.n, dtype=torch.float32, device=dev)
    fq = 0 if not fused_quant else (2 if a_dtype == torch.bfloat16 else 1)
    part = sa = a2 = _build.P(None)
    (_, _, npieces), chunk = k4_grid(m, w.n, w.k)
    p = pieces(a, fused_quant, a_dtype)
    keep = []  # scratch alive until the launch is enqueued
    if npieces > 1:
        keep.append(torch.empty(npieces, m, w.n, dtype=torch.float32,
                                device=dev))
        part = _build.ptr(keep[-1])
    if w.m is not None:
        keep.append(torch.empty(m, w.k // QK, dtype=torch.float32,
                                device=dev))
        sa = _build.ptr(keep[-1])
    if fq == 2 or p == 3:  # the operand's bf16 planes
        keep.append(torch.empty(p, m, w.k, dtype=torch.bfloat16, device=dev))
        a2 = _build.ptr(keep[-1])
    symbol = f"qgt_gemm_dequant_{w.qtype}"
    fn = _build.function("gemm_dequant", symbol,
                         [_build.P, _build.I, _build.I]
                         + [_build.P] * (5 + len(wp)) + [_build.I] * 4
                         + [_build.P])
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(a), int(a.dtype == torch.float32), fq,
                _build.ptr(w.qs), *map(_build.ptr, wp), _build.ptr(out),
                part, sa, a2, m, w.n, w.k, chunk, _build.stream(dev))
    _build.check("gemm_dequant", symbol, rc)
    gemm_dequant.launches += 1
    return out


gemm_dequant.launches = 0

__all__ = ["gemm_dequant", "gemm_dequant_plain", "fake_quant_q8",
           "k4_grid", "pieces", "split3", "ACT_DTYPES", "TILE_M", "TILE_N",
           "SMS"]
