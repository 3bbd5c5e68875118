"""K1: exact WxA8 decode GEMM (per-32 weights x Q8_1 activations, M <=
12), and K6, the same GEMM with the Q8_1 quantization of a float
activation inside the kernel.

Replaces the Pallas kernel ``quant_gemm_tpu/kernels/gemm_exact.py::
gemm_exact`` (``_kernel``, and ``_kernel_w8`` for q8_0).  Per 32-block,
the exact int32 dot ``sumi`` of the raw weight codes (0..15, 0..31 for q5
with the 5th bit from ``qh``, signed for q8_0) and the int8 activation
codes, then the golden's epilogue in float32 (``ref/gemm.py::gemm_wxa8``,
not the TPU kernel's fused-compensation order): q4_0 ``d_w * (d_a * sumi -
8 * s_a)`` (``gemm_reference.h:175-222``), q5_0 the same with 16; q4_1,
q5_1, q4_k and q5_k (a q4_K / q5_K tensor in its effective q4_1 / q5_1
form) ``d_w * d_a * sumi + m_w * s_a`` with ``s_a`` the stored f16 ``s =
d_a * sum(q)`` of
Q8_1, not the float sum of the activations; q8_0 ``d_w * d_a * sumi``,
and iq4_xs (an IQ4_XS tensor's int8 codebook values with float32 per-32
scales, q8_0's layout) the same.
The block terms are summed in float32 as the TPU kernel sums them.
The plain version sums in another order, so the two agree to float32
rounding; :func:`k1_order` sums the same terms in the kernel's order.

Bound on an H100: bytes — the weight stream (per 32 weights: 18 bytes for
q4_0, 20 q4_1, 22 q5_0, 24 q5_1, 34 q8_0, 24 for q4_k with its f32 d' and
m' planes, 28 for q5_k, 36 for iq4_xs) at 3.35 TB/s.  The design (``csrc/gemm_exact.cu``)
computes each 32-block's sumi with one int8 ``mma.sync`` m16n8k32 over
16 weight rows x 8 activation rows, from chunks of 32 blocks staged with
16-byte ``cp.async``, and keeps the old kernel's summation order bit for
bit (:func:`k1_order`), which K2, K6, K7 and K8 share (``csrc/k1.cuh``,
the same body): the kernel's output equals
``k1_order`` of the plain version's per-block terms exactly.

:func:`gemm_exact` launches the CUDA kernel for CUDA tensors and runs
:func:`gemm_exact_plain` for CPU tensors; ``gemm_exact.launches`` counts
kernel launches.

K6 :func:`gemm_exact_fused` replaces ``quant_gemm_tpu/kernels/
gemm_exact.py::gemm_exact_fused``: ``gemm_exact(w, quantize_q8_1(x))``
for a float32 ``x`` [M <= 12, K], **bit-identical** to quantizing first
and running K1 (the JAX contract, ``tests/test_kernels.py::
test_fused_exact_bit_identical`` / ``test_fused_exact_degenerate_blocks``):
the in-kernel quantizer is ``quantize_q8_1`` step for step and the GEMM
is K1's own tensor-core body and order (``csrc/k1.cuh``, shared with K1
and K2).  Its plain version is that unfused chain on the plain K1.
Bound: bytes, K1's weight stream plus ``M*K*4`` bytes of ``x``; the
persistent grid runs in clusters of 8 blocks, each quantizing an eighth
of ``x`` under its first weight chunks' loads and storing the codes in
the shared memory of all eight, or, where those codes do not fit beside
the weight ring (M 9-12 at large K), each block quantizes each chunk as
it is staged (``csrc/gemm_exact_fused.cu``).  K6 takes the per-32
weights without a qh plane, :data:`FUSED_QTYPES` (q4_0, q4_1, q4_k, q8_0
and iq4_xs, the JAX body ``_kernel_w8_fused`` for the last two); the q5
forms keep
quantize + K1, as in JAX.  ``gemm_exact_fused.launches`` counts launches.
"""

from __future__ import annotations

import torch

from ..formats.blocks import QK, Q8_1Tensor
from ..formats.quant import quantize_q8_1
from . import _build, layout
from .layout import OFFSET, QTYPES, PreparedWeight, planes

MMAX = 12  # most activation rows the kernel takes
#: the weight forms K6 has: every per-32 weight without a qh plane (the
#: JAX dispatch's rule, ``registry.py:200-204``)
FUSED_QTYPES = ("q4_0", "q4_1", "q4_k", "q8_0", "iq4_xs")


def _check(w: PreparedWeight, a: Q8_1Tensor, mmax: int = MMAX) -> None:
    if w.qtype not in QTYPES:
        raise NotImplementedError(f"gemm_exact: {w.qtype} is not ported")
    m, k = a.qs.shape
    if k != w.k:
        raise ValueError(f"activation K={k} != weight K={w.k}")
    if not 1 <= m <= mmax:
        raise ValueError(f"gemm_exact takes 1..{mmax} rows, got {m}")
    if a.qs.dtype != torch.int8 or a.d.dtype != torch.float16 \
            or a.s.dtype != torch.float16:
        raise TypeError("Q8_1 activation must be int8 codes with f16 d/s")


def k1_warps(nb: int) -> int:
    """Warps of K1's summation order for ``nb`` K blocks
    (``common.cuh::k1_warps``)."""
    return 4 if nb >= 128 else (2 if nb >= 64 else 1)


def k1_order(terms: torch.Tensor) -> torch.Tensor:
    """K1's float32 sum of per-block terms ``[M, N, nb]`` (K2, K6, K7 and
    K8 keep it): with ``nt = 32 * k1_warps(nb)`` virtual threads, thread t adds
    the terms of blocks t, t + nt, ... in turn from 0; each group of 32
    threads reduces with ``warp_sum``'s xor butterfly (lane 0's value);
    the groups are added in order from 0.  Every add is one rounded
    float32 add, so this equals the kernel bit for bit."""
    nb = terms.shape[-1]
    nt = 32 * k1_warps(nb)
    t = torch.nn.functional.pad(terms.to(torch.float32), (0, -nb % nt))
    t = t.reshape(*terms.shape[:-1], -1, nt)
    acc = torch.zeros_like(t[..., 0, :])
    for i in range(t.shape[-2]):
        acc = acc + t[..., i, :]
    acc = acc.reshape(*terms.shape[:-1], nt // 32, 32)
    for o in (16, 8, 4, 2, 1):
        acc = acc[..., :o] + acc[..., o:2 * o]
    s = torch.zeros_like(acc[..., 0, 0])
    for g in range(nt // 32):
        s = s + acc[..., g, 0]
    return s


def block_terms(w: PreparedWeight, a: Q8_1Tensor) -> torch.Tensor:
    """The per-block float32 terms ``[M, N, nb]`` of :func:`gemm_exact`
    (the golden's epilogue on the exact ``sumi``), each step rounded on
    its own."""
    m, k = a.qs.shape
    nb = k // QK
    qw = layout.codes(w).to(torch.float64).reshape(w.n, nb, QK)
    qa = a.qs.to(torch.float64).reshape(m, nb, QK)
    sumi = torch.einsum("mbk,nbk->mnb", qa, qw).to(torch.float32)
    dw = w.d.to(torch.float32)[None]
    da = a.d.to(torch.float32)[:, None]
    sa = a.s.to(torch.float32)[:, None]
    if w.qtype in OFFSET:
        return dw * (da * sumi - float(OFFSET[w.qtype]) * sa)
    if w.m is not None:
        return dw * da * sumi + w.m.to(torch.float32)[None] * sa
    return dw * da * sumi


def gemm_exact_plain(w: PreparedWeight, a: Q8_1Tensor) -> torch.Tensor:
    """Plain PyTorch version: the same float32 per-block terms, summed in
    float32.

    ``sumi`` is computed as a float64 product of the integer codes, which
    is exact (every partial sum is an integer below 2^53) on any device and
    whatever the matmul precision settings."""
    _check(w, a, mmax=1 << 30)
    return block_terms(w, a).sum(dim=-1)


def gemm_exact(w: PreparedWeight, a: Q8_1Tensor) -> torch.Tensor:
    """``C[M, N]`` float32 of a per-32 ``w`` [N, K] (``layout.QTYPES``)
    and Q8_1 ``a`` [M, K]."""
    _check(w, a)
    dev = w.qs.device
    wp = planes(w)
    if dev.type == "cpu" and a.qs.device.type == "cpu":
        return gemm_exact_plain(w, a)
    if dev.type != "cuda" or any(t.device != dev for t in (*a, *wp)):
        raise ValueError("gemm_exact: all operands must be on one CUDA "
                         "device (or all on the CPU)")
    m, k = a.qs.shape
    qa, da, sa = (t.contiguous() for t in a)
    _build.check_aligned("gemm_exact", w.qs, qa)
    # the kernel copies the scale and qh planes from 16-byte boundaries
    wp = tuple(map(_build.aligned16, wp))
    da, sa = _build.aligned16(da), _build.aligned16(sa)
    out = torch.empty(m, w.n, dtype=torch.float32, device=dev)
    symbol = f"qgt_gemm_exact_{w.qtype}"
    fn = _build.function("gemm_exact", symbol,
                         [_build.P] * (5 + len(wp)) + [_build.I] * 3
                         + [_build.P])
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(w.qs), *map(_build.ptr, wp), _build.ptr(qa),
                _build.ptr(da), _build.ptr(sa), _build.ptr(out), m, w.n, k,
                _build.stream(dev))
    _build.check("gemm_exact", symbol, rc)
    gemm_exact.launches += 1
    return out


gemm_exact.launches = 0


def _check_fused(w: PreparedWeight, x: torch.Tensor) -> None:
    if w.qtype not in FUSED_QTYPES:
        raise NotImplementedError(f"gemm_exact_fused: {w.qtype} has a qh "
                                  "plane; it takes quantize + K1, as in "
                                  "JAX")
    if x.dim() != 2 or x.shape[1] != w.k or not 1 <= x.shape[0] <= MMAX:
        raise ValueError(f"gemm_exact_fused takes x [1..{MMAX}, {w.k}], "
                         f"got {tuple(x.shape)}")


def gemm_exact_fused_plain(w: PreparedWeight, x: torch.Tensor
                           ) -> torch.Tensor:
    """Plain PyTorch version: ``quantize_q8_1`` then the plain K1."""
    _check_fused(w, x)
    return gemm_exact_plain(w, quantize_q8_1(x.to(torch.float32)))


def gemm_exact_fused(w: PreparedWeight, x: torch.Tensor) -> torch.Tensor:
    """``C[M, N]`` float32 ``= gemm_exact(w, quantize_q8_1(x))`` for a
    float ``x`` [M <= 12, K], with the quantization inside the kernel."""
    _check_fused(w, x)
    dev = w.qs.device
    wp = planes(w)
    if dev.type == "cpu" and x.device.type == "cpu":
        return gemm_exact_fused_plain(w, x)
    if dev.type != "cuda" or any(t.device != dev for t in (x, *wp)):
        raise ValueError("gemm_exact_fused: all operands must be on one "
                         "CUDA device (or all on the CPU)")
    m, k = x.shape
    # float4 loads of x; the planes copied from 16-byte boundaries
    x = _build.aligned16(x.to(torch.float32).contiguous())
    wp = tuple(map(_build.aligned16, wp))
    _build.check_aligned("gemm_exact_fused", w.qs)
    out = torch.empty(m, w.n, dtype=torch.float32, device=dev)
    symbol = f"qgt_gemm_exact_fused_{w.qtype}"
    fn = _build.function("gemm_exact_fused", symbol,
                         [_build.P] * (3 + len(wp)) + [_build.I] * 3
                         + [_build.P])
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(w.qs), *map(_build.ptr, wp), _build.ptr(x),
                _build.ptr(out), m, w.n, k, _build.stream(dev))
    _build.check("gemm_exact_fused", symbol, rc)
    gemm_exact_fused.launches += 1
    return out


gemm_exact_fused.launches = 0

__all__ = ["gemm_exact", "gemm_exact_plain", "k1_order", "k1_warps",
           "block_terms", "gemm_exact_fused",
           "gemm_exact_fused_plain", "MMAX", "FUSED_QTYPES"]
