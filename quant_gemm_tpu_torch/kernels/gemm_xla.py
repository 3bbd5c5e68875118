"""The plain GEMM rungs of the kernel ladder: counterparts of the JAX
package's ``kernels/gemm_xla.py``, which it leaves to XLA outside any
Pallas kernel, so here they are plain PyTorch, not kernels.

Convention: ``C[M, N] = A[M, K] @ W[N, K]^T``, ``w_q`` a planar SoA
container of :mod:`..formats.blocks` (torch tensors), float32 products
(TF32 off on a card: ``torch.backends.cuda.matmul.allow_tf32 = False``).

* :func:`gemm_fp32` — the float32 baseline ``A @ W^T``;
* :func:`gemm_wxa16` — dequantize, then matmul a float activation;
* :func:`gemm_wxa8_scaled` — a Q8_1 activation's scales folded into its
  codes, one float32 matmul with the dequantized weight: the compensation
  formula with the exact code sum in place of the f16-rounded ``s_a``;
* :func:`gemm_wxa8_compensated` — the reference's WxA8 semantics as two
  matmuls: raw codes with their scales folded, then ``- offset * (s_a @
  d_w^T)`` (q4_0, q5_0) or ``+ s_a @ m_w^T`` (q4_1, q5_1);
* :func:`gemm_wxa8_int` — exact per-block integer dots (float64, exact)
  and the float32 epilogue, materializing ``[M, N, K/32]``: a correctness
  oracle, not a serving path.

Each also answers to the JAX package's name (``gemm_wxa16_xla`` and the
others).
"""

from __future__ import annotations

import torch

from ..formats.blocks import QK, Q8_1Tensor
from ..formats.quant import codes, dequantize, expand_scale
from ..utils import matmul_f32


def gemm_wxa16(w_q, a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32) @ dequantize(w_q).T


def _scaled_codes(t) -> torch.Tensor:
    """Raw codes times their block scale, float32 [..., K]."""
    return codes(t).to(torch.float32) * expand_scale(t.d)


def gemm_wxa8_scaled(w_q, a_q: Q8_1Tensor) -> torch.Tensor:
    return _scaled_codes(a_q) @ dequantize(w_q).T


def gemm_wxa8_compensated(w_q, a_q: Q8_1Tensor) -> torch.Tensor:
    spec = w_q.spec
    main = _scaled_codes(a_q) @ _scaled_codes(w_q).T
    s_a = a_q.s.to(torch.float32)
    if spec.has_min:
        return main + s_a @ w_q.m.to(torch.float32).T
    if spec.offset:
        return main - float(spec.offset) * (s_a @ w_q.d.to(torch.float32).T)
    return main


def gemm_wxa8_int(w_q, a_q: Q8_1Tensor) -> torch.Tensor:
    spec = w_q.spec
    qw, qa = codes(w_q), codes(a_q)
    n, k = qw.shape
    m, nb = qa.shape[0], k // QK
    sumi = torch.einsum("mbk,nbk->bmn",
                        qa.reshape(m, nb, QK).to(torch.float64),
                        qw.reshape(n, nb, QK).to(torch.float64))
    sumi = sumi.to(torch.float32)  # [nb, M, N], exact integers
    d_w = w_q.d.to(torch.float32).T[:, None, :]  # [nb, 1, N]
    d_a = a_q.d.to(torch.float32).T[:, :, None]  # [nb, M, 1]
    s_a = a_q.s.to(torch.float32).T[:, :, None]
    if spec.has_min:
        m_w = w_q.m.to(torch.float32).T[:, None, :]
        terms = d_w * d_a * sumi + m_w * s_a
    elif spec.offset:
        terms = d_w * (d_a * sumi - float(spec.offset) * s_a)
    else:
        terms = d_w * d_a * sumi
    return terms.sum(dim=0)


def gemm_fp32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The float32 baseline ``A @ W^T`` (TF32 off)."""
    return matmul_f32(a, w)


# the JAX package's names (``*_xla``: the rungs it leaves to XLA)
gemm_fp32_xla = gemm_fp32
gemm_wxa16_xla = gemm_wxa16
gemm_wxa8_scaled_xla = gemm_wxa8_scaled
gemm_wxa8_compensated_xla = gemm_wxa8_compensated
gemm_wxa8_int_xla = gemm_wxa8_int

__all__ = ["gemm_fp32", "gemm_wxa16", "gemm_wxa8_scaled",
           "gemm_wxa8_compensated", "gemm_wxa8_int", "gemm_fp32_xla",
           "gemm_wxa16_xla", "gemm_wxa8_scaled_xla",
           "gemm_wxa8_compensated_xla", "gemm_wxa8_int_xla"]
