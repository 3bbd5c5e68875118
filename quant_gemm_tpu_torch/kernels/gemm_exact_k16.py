"""K7: exact per-16-scale decode GEMM (q6_K / q3_K / q2_K weights x Q8_1
activations, M <= 12).

Replaces the Pallas kernel ``quant_gemm_tpu/kernels/gemm_exact.py::
gemm_exact_k16`` (body ``_kernel_k16``).  Per 16-element sub-block ``j``,
the exact int32 dot ``sumi_j`` of the stored shifted weight codes and the
int8 activation codes, then ``(scp_j * d_a[j//2]) * sumi_j`` in float32
(``scp = d * sc``); q2_K adds ``mp_j * (sumq_j * d_a[j//2])`` with ``mp =
-(dmin * mn)`` and ``sumq_j`` the exact sum of the sub-block's activation
codes.  The sub-block terms are summed in float32, as the TPU kernel sums
them; the kernel adds the two terms of each 32-block first and sums those
block terms in K1's order (:func:`k16_block_terms`, then
``gemm_exact.k1_order``: equal to the kernel bit for bit), the plain
version in another order, so the two agree to float32 rounding.  Both are
held to the JAX package's float64-summed golden ``kquants.gemm_k16_ref``.

Bound on an H100: bytes — the weight stream, 8.5625 bits per weight in
the port's layout (``layout.PreparedK16``: int8 codes, an int8 ``sc`` per
16 and an f16 ``d`` per 256; q2_K 9.125 bits with ``mn`` and ``dmin``), at
3.35 TB/s.  The design (``csrc/gemm_exact_k16.cu``) is K1's body
(``csrc/k1.cuh``): a persistent grid streams 32-row tiles' chunks of 32
blocks through a cp.async ring, and each 32-block's two sub-blocks take
one int8 ``mma.sync`` m16n8k16 each, ``scp`` and ``mp`` formed in
registers from the compact planes.

:func:`gemm_exact_k16` launches the CUDA kernel for CUDA tensors and runs
:func:`gemm_exact_k16_plain` for CPU tensors; ``gemm_exact_k16.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from ..formats.blocks import QK, Q8_1Tensor
from . import _build
from .layout import PreparedK16, k16_planes

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
    if k % 256:
        raise ValueError(f"gemm_exact_k16 takes K % 256 == 0, got {k}")
    if (w.dmin is not None) != (w.qtype == "q2_k") \
            or (w.dmin is None) != (w.mn is None):
        raise ValueError(f"{w.qtype}: the min planes dmin, mn belong to q2_k "
                         "only")


def _sub_terms(w: PreparedK16, a: Q8_1Tensor) -> torch.Tensor:
    """The float32 per-16 terms ``[M, N, K/16]``, each step rounded on its
    own; ``sumi`` is a float64 product of the integer codes, exact on any
    device and whatever the matmul precision settings."""
    m, k = a.qs.shape
    nj = k // 16
    qa = a.qs.to(torch.float64).reshape(m, nj, 16)
    qw = w.qs.to(torch.float64).reshape(w.n, nj, 16)
    sumi = torch.einsum("mji,nji->mnj", qa, qw).to(torch.float32)
    da = a.d.to(torch.float32).repeat_interleave(2, dim=-1)[:, None]
    terms = w.scp[None] * da * sumi
    mp = w.mp
    if mp is not None:
        sumq = a.qs.to(torch.int32).reshape(m, nj, 16).sum(-1)
        terms = terms + mp[None] * (sumq.to(torch.float32)[:, None] * da)
    return terms


def gemm_exact_k16_plain(w: PreparedK16, a: Q8_1Tensor) -> torch.Tensor:
    """Plain PyTorch version: the same float32 per-16 terms, summed in
    float32."""
    _check(w, a, mmax=1 << 30)
    return _sub_terms(w, a).sum(dim=-1)


def k16_block_terms(w: PreparedK16, a: Q8_1Tensor) -> torch.Tensor:
    """The kernel's per-32-block terms ``[M, N, K/32]``: each block's two
    sub-block terms added in float32 (``gemm_exact.k1_order`` of these is
    the kernel's output, bit for bit)."""
    _check(w, a, mmax=1 << 30)
    t = _sub_terms(w, a)
    return t[..., 0::2] + t[..., 1::2]


def gemm_exact_k16(w: PreparedK16, a: Q8_1Tensor) -> torch.Tensor:
    """``C[M, N]`` float32 of a per-16 K-quant ``w`` [N, K] and Q8_1 ``a``
    [M, K]."""
    _check(w, a)
    dev = w.qs.device
    planes = k16_planes(w)
    if dev.type == "cpu" and a.qs.device.type == "cpu":
        return gemm_exact_k16_plain(w, a)
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (a.qs, a.d, *planes)):
        raise ValueError("gemm_exact_k16: all operands must be on one CUDA "
                         "device (or all on the CPU)")
    m, k = a.qs.shape
    qa = a.qs.contiguous()
    _build.check_aligned("gemm_exact_k16", w.qs, qa)
    # the kernel copies the planes and d_a from 16-byte boundaries
    d, sc, *mins = map(_build.aligned16, planes)
    da = _build.aligned16(a.d.contiguous())
    out = torch.empty(m, w.n, dtype=torch.float32, device=dev)
    fn = _build.function("gemm_exact_k16", "qgt_gemm_exact_k16",
                         [_build.P] * 8 + [_build.I] * 3 + [_build.P])
    mins = [_build.ptr(t) for t in mins] or [None, None]
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(w.qs), _build.ptr(d), _build.ptr(sc), *mins,
                _build.ptr(qa), _build.ptr(da), _build.ptr(out), m, w.n, k,
                _build.stream(dev))
    _build.check("gemm_exact_k16", "qgt_gemm_exact_k16", rc)
    gemm_exact_k16.launches += 1
    return out


gemm_exact_k16.launches = 0

__all__ = ["gemm_exact_k16", "gemm_exact_k16_plain", "k16_block_terms",
           "MMAX"]
