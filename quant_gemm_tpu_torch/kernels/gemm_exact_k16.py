"""K7: exact per-16-scale decode GEMM (q6_K / q3_K / q2_K weights x Q8_1
activations, M <= 12).

Replaces the Pallas kernel ``quant_gemm_tpu/kernels/gemm_exact.py::
gemm_exact_k16`` (body ``_kernel_k16``).  Per 16-element sub-block ``j``,
the exact int32 dot ``sumi_j`` of the stored shifted weight codes and the
int8 activation codes, then ``scp_j * d_a[j//2] * sumi_j`` in float32;
q2_K adds ``mp_j * (d_a[j//2] * sumq_j)`` with ``sumq_j`` the exact sum of
the sub-block's activation codes.  The sub-block terms are summed in
float32, as the TPU kernel sums them; kernel and plain version sum in
different orders, so they agree to float32 rounding.  Both are held to the
JAX package's float64-summed golden ``kquants.gemm_k16_ref``.

Bound on an H100: bytes — the weight stream, 10 bits per weight in the
port's layout (``layout.PreparedK16``: int8 codes and an f32 ``scp`` per
16; q2_K 12 bits with ``mp``), at 3.35 TB/s.  The design
(``csrc/gemm_exact_k16.cu``) is K1's: blocks of up to four warps own four
weight rows, every lane takes 32-element units with two 16-byte code
loads, one 8-byte scale load and eight ``__dp4a``.

:func:`gemm_exact_k16` launches the CUDA kernel for CUDA tensors and runs
:func:`gemm_exact_k16_plain` for CPU tensors; ``gemm_exact_k16.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from ..formats.blocks import QK, Q8_1Tensor
from . import _build
from .layout import PreparedK16

MMAX = 12  # most activation rows the kernel takes


def _check(w: PreparedK16, a: Q8_1Tensor, mmax: int = MMAX) -> None:
    if not isinstance(w, PreparedK16):
        raise TypeError(f"gemm_exact_k16 takes a PreparedK16, not "
                        f"{type(w).__name__}")
    m, k = a.qs.shape
    if k != w.k or k % QK:
        raise ValueError(f"activation K={k} != weight K={w.k} (or not a "
                         f"multiple of {QK})")
    if not 1 <= m <= mmax:
        raise ValueError(f"gemm_exact_k16 takes 1..{mmax} rows, got {m}")
    if a.qs.dtype != torch.int8 or a.d.dtype != torch.float16:
        raise TypeError("Q8_1 activation must be int8 codes with f16 d")
    if (w.mp is not None) != (w.qtype == "q2_k"):
        raise ValueError(f"{w.qtype}: the min plane mp belongs to q2_k only")


def gemm_exact_k16_plain(w: PreparedK16, a: Q8_1Tensor) -> torch.Tensor:
    """Plain PyTorch version: the same float32 per-16 terms, summed in
    float32.  ``sumi`` is a float64 product of the integer codes, exact on
    any device and whatever the matmul precision settings."""
    _check(w, a, mmax=1 << 30)
    m, k = a.qs.shape
    nj = k // 16
    qa = a.qs.to(torch.float64).reshape(m, nj, 16)
    qw = w.qs.to(torch.float64).reshape(w.n, nj, 16)
    sumi = torch.einsum("mji,nji->mnj", qa, qw).to(torch.float32)
    da = a.d.to(torch.float32).repeat_interleave(2, dim=-1)[:, None]
    terms = w.scp[None] * da * sumi
    if w.mp is not None:
        sumq = a.qs.to(torch.int32).reshape(m, nj, 16).sum(-1)
        terms = terms + w.mp[None] * (sumq.to(torch.float32)[:, None] * da)
    return terms.sum(dim=-1)


def gemm_exact_k16(w: PreparedK16, a: Q8_1Tensor) -> torch.Tensor:
    """``C[M, N]`` float32 of a per-16 K-quant ``w`` [N, K] and Q8_1 ``a``
    [M, K]."""
    _check(w, a)
    dev = w.qs.device
    planes = (w.scp,) if w.mp is None else (w.scp, w.mp)
    if dev.type == "cpu" and a.qs.device.type == "cpu":
        return gemm_exact_k16_plain(w, a)
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (a.qs, a.d, *planes)):
        raise ValueError("gemm_exact_k16: all operands must be on one CUDA "
                         "device (or all on the CPU)")
    m, k = a.qs.shape
    qa, da = a.qs.contiguous(), a.d.contiguous()
    _build.check_aligned("gemm_exact_k16", w.qs, qa, *planes)
    out = torch.empty(m, w.n, dtype=torch.float32, device=dev)
    fn = _build.function("gemm_exact_k16", "qgt_gemm_exact_k16",
                         [_build.P] * 6 + [_build.I] * 3 + [_build.P])
    mp = None if w.mp is None else _build.ptr(w.mp)
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(w.qs), _build.ptr(w.scp), mp, _build.ptr(qa),
                _build.ptr(da), _build.ptr(out), m, w.n, k,
                _build.stream(dev))
    _build.check("gemm_exact_k16", "qgt_gemm_exact_k16", rc)
    gemm_exact_k16.launches += 1
    return out


gemm_exact_k16.launches = 0

__all__ = ["gemm_exact_k16", "gemm_exact_k16_plain", "MMAX"]
