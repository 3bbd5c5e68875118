"""K2: RMSNorm + Q8_1 quantize + exact q4_0 GEMM on ``wqkv`` in one launch.

Replaces the Pallas kernel ``quant_gemm_tpu/kernels/gemm_megalayer.py::
norm_qkv``.  Its plain version is exactly ``rms_norm -> quantize_q8_1 ->
gemm_exact_plain``, the equivalence the JAX docstring states.  The kernel
normalises in another float32 summation order, and a last-ulp difference
can move a Q8_1 code across a .5 rounding tie, so kernel and plain version
agree to a tolerance (``2e-3 * max|C|``), not bit for bit.

Bound on an H100: bytes (the ``wqkv`` stream); every block of
``csrc/norm_qkv.cu`` recomputes the M <= 8 rows' norm and codes in shared
memory and then runs K1's inner loop on 16 weight rows.

:func:`norm_qkv` launches the kernel for CUDA tensors and runs
:func:`norm_qkv_plain` for CPU tensors; ``norm_qkv.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from ..formats.quant import quantize_q8_1
from ..ops.rms_norm import rms_norm
from . import _build
from .gemm_exact import gemm_exact_plain
from .layout import PreparedWeight

MMAX = 8  # rows the fused kernel takes (the serving batch)


def supported(w, dim: int, m: int) -> bool:
    """True when a decode step of ``m`` rows can take :func:`norm_qkv`
    (the JAX ``qkv_supported`` rule: M <= 8, dim % 512 == 0, q4_0)."""
    return (isinstance(w, PreparedWeight) and w.qtype == "q4_0"
            and w.k == dim and dim % 512 == 0 and m <= MMAX)


def _check(w: PreparedWeight, x: torch.Tensor, norm_w: torch.Tensor) -> None:
    if w.qtype != "q4_0":
        raise NotImplementedError(f"norm_qkv: {w.qtype} is not ported")
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
    if dev.type != "cuda" or x.device != dev or norm_w.device != dev:
        raise ValueError("norm_qkv: all operands must be on one CUDA device "
                         "(or all on the CPU)")
    m = x.shape[0]
    x = x.to(torch.float32).contiguous()
    nw = norm_w.to(torch.float32).contiguous()
    out = torch.empty(m, w.n, dtype=torch.float32, device=dev)
    fn = _build.function(
        "norm_qkv", "qgt_norm_qkv_q4_0",
        [_build.P, _build.P, _build.F] + [_build.P] * 3 + [_build.I] * 3
        + [_build.P])
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(x), _build.ptr(nw), float(eps), _build.ptr(w.qs),
                _build.ptr(w.d), _build.ptr(out), m, w.n, w.k,
                _build.stream(dev))
    _build.check("norm_qkv", "qgt_norm_qkv_q4_0", rc)
    norm_qkv.launches += 1
    return out


norm_qkv.launches = 0

__all__ = ["norm_qkv", "norm_qkv_plain", "supported", "MMAX"]
