"""K1: exact W4A8 decode GEMM (q4_0 weights x Q8_1 activations, M <= 12).

Replaces the Pallas kernel ``quant_gemm_tpu/kernels/gemm_exact.py::
gemm_exact``.  Per 32-block, the exact int32 dot ``sumi`` of the raw 0..15
weight codes and the int8 activation codes, then the golden's epilogue
``d_w * (d_a * sumi - 8 * s_a)`` in float32 (``gemm_reference.h:175-222``,
not the TPU kernel's fused-compensation order), the block terms summed in
float32 as the TPU kernel sums them.  Kernel and plain version sum in
different orders, so they agree to float32 rounding, not bit for bit.

Bound on an H100: bytes — the weight stream (``N*K*9/16`` bytes) at
3.35 TB/s; the design (``csrc/gemm_exact.cu``) streams whole q4_0 blocks
with 16-byte loads, eight ``__dp4a`` each, over a grid of ``N/4`` blocks.

:func:`gemm_exact` launches the CUDA kernel for CUDA tensors and runs
:func:`gemm_exact_plain` for CPU tensors; ``gemm_exact.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from ..formats.blocks import QK, Q8_1Tensor
from . import _build, layout
from .layout import PreparedWeight

MMAX = 12  # most activation rows the kernel takes


def _check(w: PreparedWeight, a: Q8_1Tensor, mmax: int = MMAX) -> None:
    if w.qtype != "q4_0":
        raise NotImplementedError(f"gemm_exact: {w.qtype} is not ported")
    m, k = a.qs.shape
    if k != w.k:
        raise ValueError(f"activation K={k} != weight K={w.k}")
    if not 1 <= m <= mmax:
        raise ValueError(f"gemm_exact takes 1..{mmax} rows, got {m}")
    if a.qs.dtype != torch.int8 or a.d.dtype != torch.float16 \
            or a.s.dtype != torch.float16:
        raise TypeError("Q8_1 activation must be int8 codes with f16 d/s")


def gemm_exact_plain(w: PreparedWeight, a: Q8_1Tensor) -> torch.Tensor:
    """Plain PyTorch version: the same float32 per-block terms, summed in
    float32.

    ``sumi`` is computed as a float64 product of the integer codes, which
    is exact (every partial sum is an integer below 2^53) on any device and
    whatever the matmul precision settings."""
    _check(w, a, mmax=1 << 30)
    m, k = a.qs.shape
    nb = k // QK
    qw = layout.codes(w).to(torch.float64).reshape(w.n, nb, QK)
    qa = a.qs.to(torch.float64).reshape(m, nb, QK)
    sumi = torch.einsum("mbk,nbk->mnb", qa, qw).to(torch.float32)
    dw = w.d.to(torch.float32)[None]
    da = a.d.to(torch.float32)[:, None]
    sa = a.s.to(torch.float32)[:, None]
    terms = dw * (da * sumi - 8.0 * sa)
    return terms.sum(dim=-1)


def gemm_exact(w: PreparedWeight, a: Q8_1Tensor) -> torch.Tensor:
    """``C[M, N]`` float32 of q4_0 ``w`` [N, K] and Q8_1 ``a`` [M, K]."""
    _check(w, a)
    dev = w.qs.device
    if dev.type == "cpu" and a.qs.device.type == "cpu":
        return gemm_exact_plain(w, a)
    if dev.type != "cuda" or any(t.device != dev for t in (*a, w.d)):
        raise ValueError("gemm_exact: all operands must be on one CUDA "
                         "device (or all on the CPU)")
    m, k = a.qs.shape
    qa, da, sa = (t.contiguous() for t in a)
    out = torch.empty(m, w.n, dtype=torch.float32, device=dev)
    fn = _build.function("gemm_exact", "qgt_gemm_exact_q4_0",
                         [_build.P] * 6 + [_build.I] * 3 + [_build.P])
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(w.qs), _build.ptr(w.d), _build.ptr(qa),
                _build.ptr(da), _build.ptr(sa), _build.ptr(out), m, w.n, k,
                _build.stream(dev))
    _build.check("gemm_exact", "qgt_gemm_exact_q4_0", rc)
    gemm_exact.launches += 1
    return out


gemm_exact.launches = 0

__all__ = ["gemm_exact", "gemm_exact_plain", "MMAX"]
