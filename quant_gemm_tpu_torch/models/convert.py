"""Carry quantized weights across from the JAX package.

:func:`qparams_from_jax` takes the output of the JAX package's
``llama.quantize_params`` with every array as numpy (for example
``jax.tree_util.tree_map(np.asarray, qparams)``, which keeps each
``PreparedWeight`` with numpy planes) and returns the port's parameters.
It reads only attributes and arrays, so it needs neither JAX nor the JAX
package.

The TPU layout of a q4_0 ``PreparedWeight`` is undone step by step:

* ``packed_t`` int8 ``[K/2 (padded), N (padded)]`` -> transpose, drop
  the N padding, undo the XOR 0x80 ("x8") byte encoding, drop the K
  padding: the planar row-major bytes of the SoA container;
* ``d_t`` ``[K/32 (padded per half), N (padded)]`` float32, or int16
  holding float16 bits -> transpose, drop the per-half K padding: f16;
* then the port's own ``layout.prepare``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.blocks import QK, Q4_0Tensor
from ..kernels import layout
from ..utils import resolve_device


def planar_from_jax(pw) -> Q4_0Tensor:
    """The planar Q4_0 container (numpy) behind a JAX q4_0
    ``PreparedWeight`` whose planes are numpy arrays."""
    if pw.qtype != "q4_0":
        raise NotImplementedError(f"only q4_0 weights are ported, not "
                                  f"{pw.qtype}")
    n, k = int(pw.n), int(pw.k)
    khalf, nbh = k // 2, k // 64
    packed_t = np.asarray(pw.packed_t)
    packed = (packed_t.view(np.uint8).T[:n, :khalf] ^ 0x80).astype(np.uint8)
    d_t = np.asarray(pw.d_t)
    d_all = (d_t.view(np.float16) if d_t.dtype == np.int16
             else d_t.astype(np.float16)).T[:n]
    nbh_p = d_all.shape[1] // 2  # each K half padded to nbh_p blocks
    d = np.concatenate([d_all[:, :nbh], d_all[:, nbh_p:nbh_p + nbh]], axis=1)
    assert d.shape == (n, k // QK)
    return Q4_0Tensor(np.ascontiguousarray(packed), np.ascontiguousarray(d))


def _prepared(pw, dev) -> layout.PreparedWeight:
    p = planar_from_jax(pw)
    return layout.prepare(Q4_0Tensor(torch.tensor(p.packed, device=dev),
                                     torch.tensor(p.d, device=dev)))


def qparams_from_jax(np_qparams: dict, device="cuda") -> dict:
    """Port parameters from the JAX ``quantize_params`` output (numpy)."""
    dev = resolve_device(device)

    def f32(x):  # a copy: arrays from JAX are read-only
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    embed = np.asarray(np_qparams["embed"])  # bf16 (ml_dtypes) in JAX
    out = {"embed": f32(embed.astype(np.float32)).to(torch.bfloat16),
           "final_norm": f32(np_qparams["final_norm"]), "layers": []}
    for lyr in np_qparams["layers"]:
        q = {k: f32(v) for k, v in lyr.items() if k.endswith("norm")}
        for name in ("wqkv", "wo", "wgu", "w_down"):
            q[name] = _prepared(lyr[name], dev)
        out["layers"].append(q)
    out["lm_head"] = _prepared(np_qparams["lm_head"], dev)
    return out


__all__ = ["planar_from_jax", "qparams_from_jax"]
