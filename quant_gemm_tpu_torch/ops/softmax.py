"""Softmax over the last axis, with optional causal masking, and K10.

* :func:`softmax` and :func:`softmax_causal` — plain PyTorch, as the JAX
  package leaves ``quant_gemm_tpu/ops/softmax.py::softmax`` and
  ``::softmax_causal`` to XLA: max-subtract, exp, normalise in float32;
  the causal form scales the scores by ``scale``, lets only positions ``<=
  pos`` of each row take part and writes exact zeros elsewhere.
* :func:`softmax_pallas` — K10, replacing the Pallas kernel ``quant_gemm_
  tpu/ops/softmax.py::softmax_pallas`` (body ``_softmax_kernel``) on the
  rows of a float32 [R, C] ``x``.  Bound on an H100: bytes, x read once
  and the output written once; the design (``csrc/softmax.cu``,
  ``csrc/rows.cuh``): the row plan of :func:`.rows.plan`, each row held in
  registers (the max, then ``exp(x - m)`` in place and its sum, then ``e /
  s``: one read, one write), 16-byte loads where aligned and ``C % 4 ==
  0``, a long row split over a thread-block cluster where the rows alone
  leave the SMs idle (a decode step's 8 x 32000 logits: 8 rows x 8 CTAs),
  the sum in one fixed order.  It launches the kernel for CUDA tensors and
  runs :func:`softmax_pallas_plain` (the same steps in plain PyTorch) for
  CPU tensors; ``softmax_pallas.launches`` counts launches.
* :func:`softmax_ref` and :func:`softmax_causal_ref` — the goldens
  (numpy), copies of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build
from . import rows


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    x32 = x.to(torch.float32)
    e = torch.exp(x32 - x32.amax(dim=dim, keepdim=True))
    return (e / e.sum(dim=dim, keepdim=True)).to(x.dtype)


def softmax_causal(x: torch.Tensor, pos, scale: float = 1.0) -> torch.Tensor:
    """Causal-masked scaled softmax over the last axis; ``pos`` (an int or
    an int tensor over the leading axes) is each row's position: columns
    ``> pos`` are masked and written as 0."""
    x32 = x.to(torch.float32) * scale
    idx = torch.arange(x.shape[-1], device=x.device)
    pos = torch.as_tensor(pos, device=x.device)
    valid = idx <= pos[..., None]
    masked = torch.where(valid, x32, torch.finfo(torch.float32).min)
    m = masked.amax(dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(masked - m), 0.0)
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def _check(x: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"softmax_pallas takes float32 [R, C], got {x.dtype} "
                        f"{tuple(x.shape)}")


def softmax_pallas_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, in ``_softmax_kernel``'s order."""
    _check(x)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def softmax_pallas(x: torch.Tensor) -> torch.Tensor:
    """Softmax of each row of a float32 ``x`` [R, C]; float32 [R, C]."""
    _check(x)
    if x.device.type == "cpu":
        return softmax_pallas_plain(x)
    if x.device.type != "cuda":
        raise ValueError("softmax_pallas: x must be on a CUDA device (or "
                         "on the CPU)")
    dev = x.device
    r, c = x.shape
    x = x.contiguous()
    out = torch.empty_like(x)
    p = rows.plan(r, c, x.data_ptr() % 16 == 0)
    fn = _build.function("softmax", "qgt_softmax",
                         [_build.P] * 2 + [_build.I] * 8 + [_build.P])
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(x), _build.ptr(out), r, c, *p,
                _build.stream(dev))
    _build.check("softmax", "qgt_softmax", rc)
    softmax_pallas.launches += 1
    return out


softmax_pallas.launches = 0


def softmax_ref(x) -> np.ndarray:
    x = np.asarray(x, np.float32)
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def softmax_causal_ref(x, pos, scale: float = 1.0) -> np.ndarray:
    x = np.asarray(x, np.float32) * np.float32(scale)
    out = np.zeros_like(x)
    pos = np.broadcast_to(np.asarray(pos), x.shape[:-1])
    n = x.shape[-1]
    for r in np.ndindex(x.shape[:-1]):
        valid = min(int(pos[r]) + 1, n)
        row = x[r][:valid]
        e = np.exp(row - row.max())
        out[r][:valid] = e / e.sum()
    return out


__all__ = ["softmax", "softmax_causal", "softmax_pallas",
           "softmax_pallas_plain", "softmax_ref", "softmax_causal_ref"]
