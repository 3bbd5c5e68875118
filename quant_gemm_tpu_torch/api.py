"""Drop-in ``quant_gemm``-compatible API (the reference's PyTorch
extension surface), counterpart of ``quant_gemm_tpu/api.py``.

Quantized tensors cross this boundary as uint8 ggml block bytes of shape
``[..., K/32, 18]`` (Q4_0) or ``[..., K/32, 36]`` (Q8_1), and the GEMM
takes the reference's weight-first convention::

    gemm_q4_0_q8_1(weight_q, activation_q, M, N, K) -> [M, N]
    # M = weight rows (out-features), N = activation rows (batch)

Torch tensors in give torch tensors out, on the caller's device: the
quantizers run there (``formats/quant.py``, bit-equal to the numpy
golden), and on a card the GEMM is ``registry.dispatch``: K1
(``gemm_exact``) for up to ``DECODE_M_MAX`` activation rows, else K4; on
CPU tensors their plain versions.  Numpy arrays in give numpy arrays out,
computed on the CPU.  The checks and their messages are the JAX
package's (``api.py:58-126``).
"""

from __future__ import annotations

import numpy as np
import torch

from .formats import quant
from .formats.blocks import QK, SPECS
from .formats.gguf_file import from_block_bytes, to_block_bytes
from .kernels import layout, registry

BLOCK_Q4_0_BYTES = 18
BLOCK_Q8_1_BYTES = 36
QK4_0 = QK
QK8_1 = QK


def _as_tensor(x) -> torch.Tensor:
    """A torch tensor as it is; anything else (numpy, lists) on the CPU."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(x)))


def _out(t: torch.Tensor, *inputs):
    """A torch tensor if any input was one, else numpy."""
    if any(isinstance(x, torch.Tensor) for x in inputs):
        return t
    return t.cpu().numpy()


def _check_k(x, what: str) -> int:
    k = x.shape[-1]
    if k % QK:
        raise ValueError(f"{what}: last dim K={k} must be divisible by {QK}")
    return k


def quantize(x, qtype: str):
    """Quantize float ``[..., K]`` to ggml block bytes ``[..., K/32,
    B]``."""
    if qtype not in SPECS:
        raise ValueError(f"unknown quant type {qtype!r}; have {sorted(SPECS)}")
    xt = _as_tensor(x).to(torch.float32)
    _check_k(xt, f"quantize_{qtype}")
    return _out(to_block_bytes(quant.QUANTIZE[qtype](xt)), x)


def quantize_q4_0(x):
    """FP32 [..., K] -> uint8 [..., K/32, 18]."""
    return quantize(x, "q4_0")


def quantize_q8_1(x):
    """FP32 [..., K] -> uint8 [..., K/32, 36]."""
    return quantize(x, "q8_1")


def dequantize(x_q, qtype: str, K: int):
    spec = SPECS[qtype]
    xt = _as_tensor(x_q)
    if xt.dtype != torch.uint8:
        raise ValueError(f"dequantize_{qtype}: expected uint8, got "
                         f"{getattr(x_q, 'dtype', xt.dtype)}")
    if tuple(xt.shape[-2:]) != (K // QK, spec.block_bytes):
        raise ValueError(
            f"dequantize_{qtype}: expected [..., {K // QK}, "
            f"{spec.block_bytes}], got {tuple(xt.shape)}")
    return _out(quant.dequantize(from_block_bytes(xt, qtype)), x_q)


def dequantize_q4_0(x_q, K: int):
    """uint8 [..., K/32, 18] -> FP32 [..., K]."""
    return dequantize(x_q, "q4_0", K)


def gemm_q4_0_q8_1(weight_q, activation_q, M: int, N: int, K: int):
    """C[M, N] = W[M, K] @ A[N, K]^T, the reference's convention (M =
    out-features), float32 on the weight's device."""
    w, a = _as_tensor(weight_q), _as_tensor(activation_q)
    nb = K // QK
    if w.dtype != torch.uint8 or a.dtype != torch.uint8:
        raise ValueError("gemm_q4_0_q8_1: block tensors must be uint8")
    if w.numel() != M * nb * BLOCK_Q4_0_BYTES:
        raise ValueError(
            f"weight numel {w.numel()} != M*(K/32)*18 = "
            f"{M * nb * BLOCK_Q4_0_BYTES}")
    if a.numel() != N * nb * BLOCK_Q8_1_BYTES:
        raise ValueError(
            f"activation numel {a.numel()} != N*(K/32)*36 = "
            f"{N * nb * BLOCK_Q8_1_BYTES}")
    if a.device != w.device:
        raise ValueError(f"gemm_q4_0_q8_1: weight on {w.device}, activation "
                         f"on {a.device}")
    wq = from_block_bytes(w.reshape(M, nb, BLOCK_Q4_0_BYTES), "q4_0")
    aq = from_block_bytes(a.reshape(N, nb, BLOCK_Q8_1_BYTES), "q8_1")
    # the runtime is activation-first, C[N, M]: transposed back
    out = registry.dispatch(layout.prepare(wq), aq).T.contiguous()
    return _out(out, weight_q, activation_q)


__all__ = ["quantize", "quantize_q4_0", "quantize_q8_1", "dequantize",
           "dequantize_q4_0", "gemm_q4_0_q8_1", "QK4_0", "QK8_1",
           "BLOCK_Q4_0_BYTES", "BLOCK_Q8_1_BYTES"]
