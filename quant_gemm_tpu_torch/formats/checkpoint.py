"""Checkpoint save/load for packed quantized weights (``.npz``).

Counterpart of ``quant_gemm_tpu/formats/checkpoint.py``, with the same
file layout, so a file written by either package loads in the other:

* every leaf of a nested dict / list structure is stored under its
  ``/``-joined path (list items by index);
* a block container (``formats.blocks``) stores each field as
  ``{path}::{field}``, a plain array as ``{path}::``;
* ``__manifest__`` (a JSON string as uint8 bytes) maps every path to its
  ``qtype`` (None for a plain array) and field names.

:func:`load_npz` returns the flat ``{path: value}`` dict, as the JAX one
does, with torch tensors on ``device``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..utils import resolve_device
from .blocks import TENSOR_TYPES


def _flatten(tree, prefix=""):
    """Yield (key, container-or-array) with '/'-joined paths."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_npz(path, tree) -> None:
    """Save a (nested) structure of block containers / arrays / tensors
    to ``.npz``."""
    arrays: dict[str, np.ndarray] = {}
    manifest: dict[str, dict] = {}
    for key, node in _flatten(tree):
        if hasattr(node, "_fields") and hasattr(node, "spec"):
            manifest[key] = {"qtype": node.spec.name,
                             "fields": list(node._fields)}
            for f in node._fields:
                arrays[f"{key}::{f}"] = _numpy(getattr(node, f))
        else:
            manifest[key] = {"qtype": None}
            arrays[f"{key}::"] = _numpy(node)
    arrays["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_npz(path, device="cuda") -> dict:
    """Inverse of :func:`save_npz`: a flat ``{path: value}`` dict, each
    value a tensor or a block container of tensors on ``device``."""
    dev = resolve_device(device)
    data = np.load(path)
    manifest = json.loads(bytes(data["__manifest__"]).decode())

    def tensor(name):
        return torch.as_tensor(data[name], device=dev)

    out = {}
    for key, info in manifest.items():
        if info["qtype"] is None:
            out[key] = tensor(f"{key}::")
        else:
            cls = TENSOR_TYPES[info["qtype"]]
            out[key] = cls(**{f: tensor(f"{key}::{f}")
                              for f in info["fields"]})
    return out


__all__ = ["save_npz", "load_npz"]
