"""Numpy golden GEMMs: a copy of the JAX package's ``ref/gemm.py``
(``gemm_fp32``, ``gemm_wxa16``, ``gemm_wxa8``) on the port's numpy
containers (:mod:`..formats.numpy_ref`).

Convention: ``C[M, N] = A[M, K] @ W[N, K]^T``.  ``gemm_wxa8``'s per-block
integer dots are exact; its per-block terms are float32 values summed in
float64, so it is more accurate than any single-precision kernel.
Epilogues (scales are f16 storage upcast to f32):

* q4_0: ``d_w * (d_a * sumi - 8 * s_a)``; q5_0 with 16;
* q8_0: ``d_w * d_a * sumi``;
* q4_1/q5_1: ``d_w * d_a * sumi + m_w * s_a`` (the JAX golden's
  ``compat="exact"``, its default).
"""

from __future__ import annotations

import numpy as np

from ..formats.blocks import QK, Q8_1Tensor
from ..formats.numpy_ref import codes, dequantize


def gemm_fp32(a: np.ndarray, w: np.ndarray) -> np.ndarray:
    """FP32 ground truth: C[M,N] = A[M,K] @ W[N,K]^T."""
    return np.asarray(a, np.float32) @ np.asarray(w, np.float32).T


def gemm_wxa16(a: np.ndarray, w_q) -> np.ndarray:
    """Float activations x quantized weights, dequantized."""
    return gemm_fp32(a, dequantize(w_q))


def _block_sumi(w_q, a_q: Q8_1Tensor) -> np.ndarray:
    """Exact integer block dots sumi[M, N, nb] from raw stored codes."""
    qw = codes(w_q)
    qa = codes(a_q)
    n, k = qw.shape
    m = qa.shape[0]
    nb = k // QK
    return np.einsum("mbk,nbk->mnb", qa.reshape(m, nb, QK),
                     qw.reshape(n, nb, QK), dtype=np.int64)


def gemm_wxa8(w_q, a_q: Q8_1Tensor) -> np.ndarray:
    """Quantized weights x Q8_1 activations with the format's epilogue."""
    spec = w_q.spec
    sumi = _block_sumi(w_q, a_q).astype(np.float64)  # [M, N, nb]
    d_w = np.asarray(w_q.d, np.float32).astype(np.float64)  # [N, nb]
    d_a = np.asarray(a_q.d, np.float32).astype(np.float64)  # [M, nb]
    s_a = np.asarray(a_q.s, np.float32).astype(np.float64)  # [M, nb]
    if spec.has_min:
        m_w = np.asarray(w_q.m, np.float32).astype(np.float64)
        terms = d_w[None] * d_a[:, None] * sumi + m_w[None] * s_a[:, None]
    elif spec.offset:
        terms = d_w[None] * (d_a[:, None] * sumi
                             - float(spec.offset) * s_a[:, None])
    else:
        terms = d_w[None] * d_a[:, None] * sumi
    return terms.sum(axis=-1).astype(np.float32)


__all__ = ["gemm_fp32", "gemm_wxa16", "gemm_wxa8"]
