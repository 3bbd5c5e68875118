"""llama.cpp / ggml compatibility adapter, counterpart of
``quant_gemm_tpu/compat.py``.

* :class:`GGMLTensorView` carries ggml's tensor contract (``ne[0]`` = K
  innermost, ``ne[1]`` = rows; ggml block bytes or a float tensor), built
  from a GGUF file's entry (:func:`tensor_view_from_gguf`);
  :func:`gemm_from_ggml` runs it through ``registry.dispatch`` ("auto")
  or a named rung of ``registry.LADDER``, as the reference's
  ``gemm_*_from_ggml`` entry points select a kernel by name.
* The ``ggml_op_*`` drop-ins follow ggml's operator semantics (rms_norm
  normalizes only: llama.cpp applies the weight with a separate mul) on
  torch tensors, on their device.  Each is the JAX one's plain XLA
  arithmetic (``rms_norm`` inline, ``ops/softmax.py::softmax``, RoPE,
  SiLU, GELU): none reaches a Pallas kernel there, so none reaches a
  CUDA kernel here.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Optional

import numpy as np
import torch

from .formats.blocks import SPECS
from .formats.gguf_file import from_block_bytes
from .kernels import layout, registry
from .models.gguf_loader import _prep
from .ops.activations import gelu_quick as _gelu_quick, silu as _silu
from .ops.rope import rope as _rope
from .ops.softmax import softmax as _softmax


@dataclasses.dataclass
class GGMLTensorView:
    """A ggml-convention tensor: ``ne[0]`` innermost (K), ``ne[1]`` rows.
    ``data``: the ggml block bytes of a quantized type (numpy or a uint8
    tensor), a block container already decoded (a K-quant), or a float
    array / tensor (f32, f16)."""

    name: str
    qtype: str  # "q4_0" .. "q8_1", a K-quant, "f32", "f16"
    ne: tuple  # ggml dim order: (K, rows, ...)
    data: Any

    @property
    def k(self) -> int:
        return int(self.ne[0])

    @property
    def rows(self) -> int:
        return int(np.prod(self.ne[1:])) if len(self.ne) > 1 else 1

    def to_soa(self, device="cpu"):
        """The planar container on ``device`` (float tensors float32
        [rows, K]; a decoded container as it is)."""
        if self.qtype in ("f32", "f16"):
            return torch.as_tensor(np.array(self.data) if not isinstance(
                self.data, torch.Tensor) else self.data).to(
                    device, torch.float32).reshape(self.rows, self.k)
        if self.qtype not in SPECS:
            return self.data
        raw = (self.data if isinstance(self.data, torch.Tensor)
               else torch.from_numpy(np.array(self.data, np.uint8))
               ).to(device)
        spec = SPECS[self.qtype]
        return from_block_bytes(
            raw.reshape(self.rows, self.k // 32, spec.block_bytes),
            self.qtype)


def tensor_view_from_gguf(gf, name: str, device="cpu") -> GGMLTensorView:
    """A view over one GGUF tensor: its raw block bytes for a per-32
    type, else the tensor loaded onto ``device``."""
    info = gf.tensors[name]
    ne = tuple(reversed(info["shape"]))
    qt = info["qtype"]
    data = gf.raw(name) if qt in SPECS else gf.load(name, device)
    return GGMLTensorView(name, qt, ne, data)


def _prepare(w_soa):
    """A container (or an already prepared weight) -> the kernel weight,
    as the GGUF loader prepares it (K-quants in their served forms)."""
    if isinstance(w_soa, (layout.PreparedWeight, layout.PreparedK16)):
        return w_soa
    return _prep(w_soa)


def prepare_from_gguf(gf, name: str, device="cuda"):
    """A GGUF tensor -> the kernel weight on ``device``."""
    return _prepare(tensor_view_from_gguf(gf, name, device).to_soa(device))


def gemm_from_ggml(w: GGMLTensorView, act, kernel: str = "auto"):
    """The ``gemm_{w4a8,w4a16,fp32}_from_ggml`` entry point: ``act`` a
    float [M, K] tensor or a Q8_1 container, on the device the weight
    goes to; ``kernel`` "auto" (``registry.dispatch``) or a
    ``registry.LADDER`` name.  Float weights: a plain float32 matmul."""
    dev = (act.qs if hasattr(act, "qs") else act).device
    w_soa = w.to_soa(dev)
    if isinstance(w_soa, torch.Tensor):
        if hasattr(act, "qs"):
            raise TypeError("fp32 weights take float activations")
        return act.to(torch.float32) @ w_soa.T
    if kernel == "auto":
        return registry.dispatch(_prepare(w_soa), act)
    return registry.LADDER[kernel](w_soa, act)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def ggml_op_silu(x):
    return _silu(_f32(x))


def ggml_op_gelu(x):
    """ggml's GELU is the tanh ("quick") form."""
    return _gelu_quick(_f32(x))


def ggml_op_rms_norm(x, op_params=1e-5):
    """ggml rms_norm: normalize only (no weight).  ``op_params``: the eps
    as a float, or the raw 4-byte op_params blob ggml stores it in."""
    eps = (struct.unpack("<f", op_params[:4])[0]
           if isinstance(op_params, (bytes, bytearray)) else float(op_params))
    x = _f32(x)
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)


def ggml_op_soft_max(x, scale: float = 1.0):
    """ggml soft_max with its optional pre-softmax scale."""
    return _softmax(_f32(x) * scale)


def ggml_op_rope(x, pos, op_params: Optional[dict] = None):
    """ggml rope: ``op_params`` carries n_dims / mode / freq_base /
    freq_scale; mode 0 rotates interleaved pairs (original llama), mode 2
    (NEOX) split halves."""
    p = op_params or {}
    mode = int(p.get("mode", 0))
    x = _f32(x)
    pos = pos if isinstance(pos, torch.Tensor) else torch.as_tensor(
        np.asarray(pos))
    return _rope(x, pos.to(x.device),
                 base=float(p.get("freq_base", 10000.0)),
                 freq_scale=float(p.get("freq_scale", 1.0)),
                 interleaved=(mode & 2) == 0)


def ggml_op_add(a, b):
    return _f32(a) + _f32(b)


def ggml_op_mul(a, b):
    return _f32(a) * _f32(b)


GGML_OPS = {
    "silu": ggml_op_silu,
    "gelu": ggml_op_gelu,
    "rms_norm": ggml_op_rms_norm,
    "soft_max": ggml_op_soft_max,
    "rope": ggml_op_rope,
    "add": ggml_op_add,
    "mul": ggml_op_mul,
}

__all__ = ["GGMLTensorView", "tensor_view_from_gguf", "prepare_from_gguf",
           "gemm_from_ggml", "GGML_OPS"] + [f"ggml_op_{n}" for n in GGML_OPS]
