"""The decode-layer fusions of ``quant_gemm_tpu/kernels/gemm_megalayer.py``.

K2 :func:`norm_qkv`: RMSNorm + Q8_1 quantize + exact GEMM on ``wqkv``
in one launch, for the JAX kernel's formats (:data:`QKV_QTYPES`: q4_0,
the min-plane formats q4_1 and q4_k, and the q5 family q5_0, q5_1 and
q5_k through the qh plane; JAX's K2 takes no q8_0).  Replaces the Pallas
kernel ``norm_qkv`` (``_qkv_kernel`` with ``has_min`` / ``has_qh``).  Its
plain version is exactly ``rms_norm -> quantize_q8_1 -> gemm_exact_plain``,
the equivalence the JAX docstring states.  The kernel (``csrc/norm_qkv.cu``)
runs K1's tensor-core body and summation order (``csrc/k1.cuh``), so
where its normalised rows equal the plain version's (rows of +-1 with
eps 0) it equals ``quantize_q8_1`` + K1 bit for bit; elsewhere it
normalises in another float32 summation order, a last-ulp difference can
move a Q8_1 code across a .5 rounding tie, and kernel and plain version
agree to a tolerance (``2e-3 * max|C|``).  Bound on an H100: bytes (the
``wqkv`` stream); a persistent grid of clusters of 8 blocks, each block
normalising and quantizing an eighth of the M <= 8 rows' K blocks under
its first weight chunks' loads and storing the codes in the shared memory
of all eight, then streaming its 32-row tiles through the int8 tensor
cores.

K8 :func:`attn_tail`: everything after attention (``wo`` + residual +
RMSNorm + Q8_1 + ``wgu`` + SiLU*gate + Q8_1 + ``w_down`` + residual) in
one cooperative launch, q4_0, M <= 8.  Replaces the Pallas kernel
``attn_tail``.  Its plain version is exactly the unfused chain of
``models/llama.py::layer`` through the plain functions, so on the CPU it
is bit-identical to the unfused layer tail.  On the card each of the
kernel's three GEMM stages equals ``quantize_q8_1`` + K1 bit for bit for
the same float input (the JAX kernel's "bit-identical GEMM stages"): each
runs K1's body, mode and order (``csrc/k1.cuh``, the codes STREAMED) on
codes made by the shared quantizer; the RMSNorm and the SiLU round in
the kernel's own float32 order, so a Q8_1 code can flip at a .5 tie
against the plain chain: the two are compared on the layer update ``out
- x`` (``2e-3 * max|out - x|``, K2's rule).  Bound on an H100: bytes, the
three weights (21.8 MB per TinyLlama-1.1B layer, 0.0065 ms at 3.35
TB/s); ``csrc/attn_tail.cu`` runs a persistent cooperative grid that
alternates grid-wide Q8_1 passes (attn; RMSNorm of ``xm``; ``ff``) with
the three GEMM stages, five grid barriers, each stage's first weight
chunks prefetched into L2 before the barriers in front of it, ``xm``,
``ff`` and the codes in a scratch buffer the wrapper allocates.  The
wrapper raises where the card refuses the cooperative launch; it never
falls back to the unfused chain.

:data:`ENABLE_TAIL` is the JAX package's switch for K8, off by default
as there (it measured a loss on the TPU, ``gemm_megalayer.py:68-75``);
:func:`tail_supported` reads it per call.  The JAX package's other two
switches (``ENABLED``, ``ENABLE_QKV``) serve its ``bench_serve.py
--mega`` only and are not ported: K2 is taken wherever
:func:`supported` allows it.

:func:`norm_qkv` and :func:`attn_tail` launch their kernels for CUDA
tensors and run the plain versions for CPU tensors; ``.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from ..formats.quant import quantize_q8_1
from ..ops.activations import silu_mul
from ..ops.rms_norm import rms_norm
from . import _build
from .gemm_exact import gemm_exact_plain
from .layout import PreparedWeight, planes

MMAX = 8  # rows the fused kernels take (the serving batch)
#: the weight forms K2 takes (the JAX ``_supported_w`` formats)
QKV_QTYPES = ("q4_0", "q4_1", "q4_k", "q5_0", "q5_1", "q5_k")

ENABLE_TAIL = False  # K8 attn_tail, the JAX default


def _q4_0(w, k: int, n: int = 0) -> bool:
    return (isinstance(w, PreparedWeight) and w.qtype == "q4_0"
            and w.k == k and (not n or w.n == n))


def supported(w, dim: int, m: int) -> bool:
    """True when a decode step of ``m`` rows can take :func:`norm_qkv`
    (the JAX ``qkv_supported`` / ``_supported_w`` rule: M <= 8, dim % 512
    == 0, ``w`` one whole :class:`PreparedWeight` of K = dim in a
    :data:`QKV_QTYPES` form, not a ``SplitLinear`` of parts)."""
    return (isinstance(w, PreparedWeight) and w.qtype in QKV_QTYPES
            and w.k == dim and dim % 512 == 0 and m <= MMAX)


def tail_supported(lyr: dict, cfg, m: int) -> bool:
    """True when a decode step of ``m`` rows of this layer can take
    :func:`attn_tail` (the JAX rule: ENABLE_TAIL, M <= 8, dim and d_ff %
    512 == 0, ``wo`` [dim, dim], ``wgu`` [2 d_ff, dim] and ``w_down``
    [dim, d_ff] all q4_0)."""
    dim, dff = cfg.dim, cfg.d_ff
    return (ENABLE_TAIL and m <= MMAX and dim % 512 == 0
            and dff % 512 == 0 and _q4_0(lyr.get("wo"), dim, dim)
            and _q4_0(lyr.get("wgu"), dim, 2 * dff)
            and _q4_0(lyr.get("w_down"), dff, dim))


def _check(w: PreparedWeight, x: torch.Tensor, norm_w: torch.Tensor) -> None:
    if w.qtype not in QKV_QTYPES:
        raise NotImplementedError(f"norm_qkv takes {', '.join(QKV_QTYPES)}"
                                  f" weights, as in JAX, not {w.qtype}")
    if x.dim() != 2 or x.shape[1] != w.k or not 1 <= x.shape[0] <= MMAX:
        raise ValueError(f"norm_qkv takes x [1..{MMAX}, {w.k}], got "
                         f"{tuple(x.shape)}")
    if norm_w.shape != (w.k,):
        raise ValueError(f"norm weight {tuple(norm_w.shape)} != ({w.k},)")


def norm_qkv_plain(w: PreparedWeight, x: torch.Tensor, norm_w: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Plain PyTorch version: the unfused chain."""
    _check(w, x, norm_w)
    h = rms_norm(x.to(torch.float32), norm_w, eps)
    return gemm_exact_plain(w, quantize_q8_1(h))


def norm_qkv(w: PreparedWeight, x: torch.Tensor, norm_w: torch.Tensor,
             eps: float) -> torch.Tensor:
    """``gemm_exact(w, quantize_q8_1(rms_norm(x, norm_w, eps)))``, float32
    ``[M, N]`` for ``x`` [M <= 8, K]."""
    _check(w, x, norm_w)
    dev = w.qs.device
    if dev.type == "cpu" and x.device.type == "cpu":
        return norm_qkv_plain(w, x, norm_w, eps)
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (x, norm_w, *planes(w))):
        raise ValueError("norm_qkv: all operands must be on one CUDA device "
                         "(or all on the CPU)")
    m = x.shape[0]
    # float4 loads of x and the norm weight; the planes copied from
    # 16-byte boundaries
    x = _build.aligned16(x.to(torch.float32).contiguous())
    nw = _build.aligned16(norm_w.to(torch.float32).contiguous())
    wp = tuple(map(_build.aligned16, planes(w)))
    _build.check_aligned("norm_qkv", w.qs)
    out = torch.empty(m, w.n, dtype=torch.float32, device=dev)
    symbol = f"qgt_norm_qkv_{w.qtype}"
    fn = _build.function(
        "norm_qkv", symbol,
        [_build.P, _build.P, _build.F] + [_build.P] * (2 + len(wp))
        + [_build.I] * 3 + [_build.P])
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(x), _build.ptr(nw), float(eps), _build.ptr(w.qs),
                *map(_build.ptr, wp), _build.ptr(out), m, w.n, w.k,
                _build.stream(dev))
    _build.check("norm_qkv", symbol, rc)
    norm_qkv.launches += 1
    return out


norm_qkv.launches = 0


def _check_tail(attn, x, norm_w, wo, wgu, w_down, d_ff) -> None:
    for name, w in (("wo", wo), ("wgu", wgu), ("w_down", w_down)):
        if not isinstance(w, PreparedWeight) or w.qtype != "q4_0":
            raise NotImplementedError(f"attn_tail: {name} must be a q4_0 "
                                      "PreparedWeight")
    dim = x.shape[-1]
    if (x.dim() != 2 or attn.shape != x.shape
            or not 1 <= x.shape[0] <= MMAX):
        raise ValueError(f"attn_tail takes attn and x [1..{MMAX}, dim], got "
                         f"{tuple(attn.shape)} and {tuple(x.shape)}")
    if ((wo.n, wo.k) != (dim, dim) or (wgu.n, wgu.k) != (2 * d_ff, dim)
            or (w_down.n, w_down.k) != (dim, d_ff) or dim % 32
            or d_ff % 32):
        raise ValueError(f"attn_tail: weights wo {(wo.n, wo.k)}, wgu "
                         f"{(wgu.n, wgu.k)}, w_down {(w_down.n, w_down.k)} "
                         f"do not fit dim {dim}, d_ff {d_ff}")
    if norm_w.shape != (dim,):
        raise ValueError(f"norm weight {tuple(norm_w.shape)} != ({dim},)")


def attn_tail_plain(attn: torch.Tensor, x: torch.Tensor,
                    norm_w: torch.Tensor, wo: PreparedWeight,
                    wgu: PreparedWeight, w_down: PreparedWeight, eps: float,
                    d_ff: int) -> torch.Tensor:
    """Plain PyTorch version: the unfused chain."""
    _check_tail(attn, x, norm_w, wo, wgu, w_down, d_ff)
    x = x.to(torch.float32)
    xm = x + gemm_exact_plain(wo, quantize_q8_1(attn.to(torch.float32)))
    h = rms_norm(xm, norm_w, eps)
    gu = gemm_exact_plain(wgu, quantize_q8_1(h))
    ff = silu_mul(gu[:, :d_ff], gu[:, d_ff:])
    return xm + gemm_exact_plain(w_down, quantize_q8_1(ff))


def attn_tail(attn: torch.Tensor, x: torch.Tensor, norm_w: torch.Tensor,
              wo: PreparedWeight, wgu: PreparedWeight,
              w_down: PreparedWeight, eps: float, d_ff: int) -> torch.Tensor:
    """The layer's new hidden state float32 [M, dim] from the attention
    output ``attn`` and the residual ``x`` (both [M <= 8, dim])."""
    _check_tail(attn, x, norm_w, wo, wgu, w_down, d_ff)
    dev = wo.qs.device
    operands = (attn, x, norm_w, *wo, *wgu, *w_down)
    tensors = [t for t in operands if isinstance(t, torch.Tensor)]
    if all(t.device.type == "cpu" for t in tensors):
        return attn_tail_plain(attn, x, norm_w, wo, wgu, w_down, eps, d_ff)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("attn_tail: all operands must be on one CUDA "
                         "device (or all on the CPU)")
    m, dim = x.shape
    # float4 loads of attn and the norm weight; the scale planes copied
    # from 16-byte boundaries
    attn, x, nw = (_build.aligned16(t.to(torch.float32).contiguous())
                   for t in (attn, x, norm_w))
    wd = [_build.aligned16(w.d) for w in (wo, wgu, w_down)]
    _build.check_aligned("attn_tail", wo.qs, wgu.qs, w_down.qs)
    size = _build.function("attn_tail", "qgt_attn_tail_workspace",
                           [_build.I] * 3)
    ws = torch.empty(size(m, dim, d_ff), dtype=torch.uint8, device=dev)
    out = torch.empty(m, dim, dtype=torch.float32, device=dev)
    fn = _build.function(
        "attn_tail", "qgt_attn_tail_q4_0",
        [_build.P] * 3 + [_build.F] + [_build.P] * 8 + [_build.I] * 3
        + [_build.P])
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(attn), _build.ptr(x), _build.ptr(nw), float(eps),
                *(_build.ptr(t) for w, d in zip((wo, wgu, w_down), wd)
                  for t in (w.qs, d)),
                _build.ptr(ws), _build.ptr(out), m, dim, d_ff,
                _build.stream(dev))
    _build.check("attn_tail", "qgt_attn_tail_q4_0", rc)
    attn_tail.launches += 1
    return out


attn_tail.launches = 0

__all__ = ["norm_qkv", "norm_qkv_plain", "attn_tail", "attn_tail_plain",
           "supported", "tail_supported", "ENABLE_TAIL", "MMAX",
           "QKV_QTYPES"]
