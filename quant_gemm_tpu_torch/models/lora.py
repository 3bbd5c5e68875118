"""GGUF LoRA adapters applied at run time over the quantized base weights.

Counterpart of ``quant_gemm_tpu/models/lora.py``: llama.cpp's ``--lora
adapter.gguf`` (tensors ``<base>.weight.lora_a`` [r, K] and
``<base>.weight.lora_b`` [N, r], ``adapter.lora.alpha`` in the metadata,
scale alpha / r).  The packed base weights stay as they are; each adapted
linear becomes a :class:`LoraLinear` whose product is

    y = W_q(x) + scale * (x @ A^T) @ B^T

the base GEMM through the kernels, the two low-rank products float32
``torch.matmul`` (TF32 off on a card), as JAX computes them in XLA
outside any kernel (``lora.py:66-73``).  Fused slots (``wqkv``, ``wgu``)
carry one delta per part, each added into its column slice.  A LoRA'd
``wqkv`` turns K2 off for the whole model and a LoRA'd ``wo``, ``wgu`` or
``w_down`` turns K8 off (``gemm_megalayer.supported`` / ``tail_supported``
take only a ``PreparedWeight``), as in JAX.  The deltas are tensors on the
model's device, so a captured step replays them too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import matmul_f32, resolve_device


class LoraDelta(NamedTuple):
    a: torch.Tensor  # [r, K]
    b: torch.Tensor  # [n_part, r]


class LoraLinear(NamedTuple):
    """A quantized linear ``inner`` and its low-rank deltas: a tuple of
    ``(column offset, scale, LoraDelta)``, the offset placing a part in a
    fused slot's output."""

    inner: object
    deltas: tuple


def apply_lora(w: LoraLinear, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Add every delta of ``w`` into its column slice of ``y`` [M, N] (the
    base product of ``x`` [M, K], updated in place and returned)."""
    for off, scale, d in w.deltas:
        n = d.b.shape[0]
        y[:, off:off + n] += scale * matmul_f32(matmul_f32(x, d.a), d.b)
    return y


class LoraAdapter(NamedTuple):
    alpha: float
    tensors: dict  # base tensor name -> LoraDelta

    def scale(self, r: int) -> float:
        return self.alpha / r


def load_lora(path, device="cuda") -> LoraAdapter:
    """Read a llama.cpp LoRA adapter GGUF (f16/f32 ``*.lora_a`` /
    ``*.lora_b`` pairs and ``adapter.lora.alpha``), the deltas float32 on
    ``device``."""
    from ..formats.gguf_file import GGUFFile

    dev = resolve_device(device)
    gf = path if isinstance(path, GGUFFile) else GGUFFile(path)
    md = gf.metadata
    if md.get("adapter.type", "lora") != "lora":
        raise ValueError(f"adapter.type={md.get('adapter.type')!r} != 'lora'")
    alpha = float(md.get("adapter.lora.alpha", 16.0))
    pairs: dict[str, dict] = {}
    for name in gf.tensors:
        for suffix, field in ((".lora_a", "a"), (".lora_b", "b")):
            if name.endswith(suffix):
                pairs.setdefault(name[: -len(suffix)], {})[field] = (
                    gf.load(name, dev).to(torch.float32))
    out = {}
    for base, ab in pairs.items():
        if "a" not in ab or "b" not in ab:
            raise ValueError(f"LoRA pair incomplete for {base}")
        out[base] = LoraDelta(ab["a"], ab["b"])
    return LoraAdapter(alpha, out)


def _slot_parts(cfg):
    """Each fused slot's parts: (llama.cpp base tensor name pattern,
    column offset in the slot's output)."""
    nq = cfg.n_heads * cfg.head_dim
    nkv = cfg.n_kv_heads * cfg.head_dim
    return {
        "wqkv": [("blk.{i}.attn_q.weight", 0),
                 ("blk.{i}.attn_k.weight", nq),
                 ("blk.{i}.attn_v.weight", nq + nkv)],
        "wo": [("blk.{i}.attn_output.weight", 0)],
        "wgu": [("blk.{i}.ffn_gate.weight", 0),
                ("blk.{i}.ffn_up.weight", cfg.d_ff)],
        "w_down": [("blk.{i}.ffn_down.weight", 0)],
    }


def attach_lora(qparams: dict, adapter: LoraAdapter, cfg) -> dict:
    """A new parameter dict whose adapted linears are :class:`LoraLinear`
    (the base weights shared, not copied), the deltas moved to the
    model's device.  An adapter tensor with no serving slot raises:
    dropping a delta would serve another model."""
    dev = qparams["embed"].device
    used = set()

    def delta(base):
        d = adapter.tensors[base]
        used.add(base)
        return (adapter.scale(d.a.shape[0]),
                LoraDelta(d.a.to(dev, torch.float32),
                          d.b.to(dev, torch.float32)))

    out = dict(qparams)
    out["layers"] = []
    for i, lyr in enumerate(qparams["layers"]):
        new = dict(lyr)
        for slot, parts in _slot_parts(cfg).items():
            deltas = tuple((off, *delta(fmt.format(i=i)))
                           for fmt, off in parts
                           if fmt.format(i=i) in adapter.tensors)
            if deltas:
                new[slot] = LoraLinear(lyr[slot], deltas)
        out["layers"].append(new)
    if "output.weight" in adapter.tensors:
        out["lm_head"] = LoraLinear(qparams["lm_head"],
                                    ((0, *delta("output.weight")),))
    unknown = set(adapter.tensors) - used
    if unknown:
        raise ValueError(
            f"LoRA adapter tensors with no serving slot: {sorted(unknown)} "
            "(token_embd LoRA is not supported)")
    return out


def export_lora(path, alpha: float, tensors: dict) -> None:
    """Write a llama.cpp-convention LoRA adapter GGUF.  ``tensors``: base
    tensor name -> (A [r, K], B [N, r]), tensors or arrays; float16
    tensors are written as f16, everything else as f32."""
    from ..formats.gguf_file import write_gguf

    def t(x):
        x = torch.as_tensor(x)
        return x if x.dtype == torch.float16 else x.to(torch.float32)

    blobs = {}
    for base, (a, b) in tensors.items():
        blobs[base + ".lora_a"] = t(a)
        blobs[base + ".lora_b"] = t(b)
    write_gguf(path, blobs, metadata={
        "general.type": "adapter",
        "adapter.type": "lora",
        "adapter.lora.alpha": float(alpha),
    })


__all__ = ["LoraAdapter", "LoraDelta", "LoraLinear", "apply_lora",
           "load_lora", "attach_lora", "export_lora"]
