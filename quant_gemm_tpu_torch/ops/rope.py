"""Rotary position embeddings in plain PyTorch (the JAX package leaves
them to XLA).

``theta_i = pos * freq_scale / base^(2i / head_dim)``; the split layout
(llama, the default) rotates the pair ``(x[i], x[i + d/2])``, the
interleaved one ``(x[2i], x[2i+1])``, to ``(x0 c - x1 s, x0 s + x1 c)``.
The tables are computed in float64 with numpy and cast to float32, as the
JAX package does, so both packages hold the same tables bit for bit.
:func:`rope_ref` is the golden (a scalar loop in numpy, a copy of the JAX
package's).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import resolve_device

DEFAULT_BASE = 10000.0


def rope_cache(max_pos: int, head_dim: int, base: float = DEFAULT_BASE,
               freq_scale: float = 1.0, device="cuda", inv_freq=None):
    """cos/sin tables ``float32 [max_pos, head_dim/2]`` on ``device``.

    ``inv_freq``: optional per-dimension inverse frequencies [head_dim/2]
    (a tensor or array) that replace the ``base**(-2i/d)`` spectrum, such
    as a GGUF file's ``rope_freqs.weight`` divisors applied by the loader
    or :func:`llama3_inv_freq`; its float32 values are widened to float64
    for the phases, as in JAX."""
    dev = resolve_device(device)
    if inv_freq is None:
        inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float64)
                                   / head_dim))
    elif isinstance(inv_freq, torch.Tensor):
        inv_freq = inv_freq.detach().cpu().numpy()
    inv_freq = np.asarray(inv_freq, np.float64)
    t = np.arange(max_pos, dtype=np.float64)[:, None] * inv_freq[None, :] \
        * freq_scale
    return (torch.tensor(np.cos(t), dtype=torch.float32, device=dev),
            torch.tensor(np.sin(t), dtype=torch.float32, device=dev))


def llama3_inv_freq(head_dim: int, base: float, factor: float,
                    low_freq_factor: float, high_freq_factor: float,
                    original_max_pos: int) -> np.ndarray:
    """Llama-3.1 frequency-dependent RoPE scaling (HF ``rope_type=
    'llama3'``): long wavelengths divide by ``factor``, short ones stay,
    the band between interpolates; float32 [head_dim/2]."""
    inv_freq = 1.0 / (
        base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    wavelen = 2.0 * np.pi / inv_freq
    low_wl = original_max_pos / low_freq_factor
    high_wl = original_max_pos / high_freq_factor
    smooth = (original_max_pos / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor)
    interp = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    out = np.where(wavelen > low_wl, inv_freq / factor,
                   np.where(wavelen < high_wl, inv_freq, interp))
    return out.astype(np.float32)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, cache,
               interleaved: bool = False) -> torch.Tensor:
    """Rotate ``x[..., H, D]`` by positions ``pos[...]``.

    Positions past the table clamp to its last row, as a JAX gather does;
    only padded or inactive rows ever reach them."""
    cos_t, sin_t = cache
    pos = torch.as_tensor(pos, device=cos_t.device)
    pos = pos.clamp(0, cos_t.shape[0] - 1)
    cos = cos_t[pos][..., None, :]
    sin = sin_t[pos][..., None, :]
    d = x.shape[-1]
    x32 = x.to(torch.float32)
    if interleaved:
        x0, x1 = x32[..., 0::2], x32[..., 1::2]
        out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                          dim=-1).reshape(x.shape)
    else:
        x0, x1 = x32[..., : d // 2], x32[..., d // 2:]
        out = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, pos, base: float = DEFAULT_BASE,
         freq_scale: float = 1.0, interleaved: bool = False) -> torch.Tensor:
    """One-shot RoPE: tables up to ``max(pos)`` on ``x``'s device."""
    pos = torch.as_tensor(pos, device=x.device)
    cache = rope_cache(int(pos.max()) + 1, x.shape[-1], base, freq_scale,
                       device=x.device)
    return apply_rope(x, pos, cache, interleaved=interleaved)


def rope_ref(x, pos, base: float = DEFAULT_BASE, freq_scale: float = 1.0,
             interleaved: bool = False) -> np.ndarray:
    """Scalar-loop golden (numpy arrays), the phases in float64."""
    x = np.asarray(x, np.float32).copy()
    lead = x.shape[:-2]
    pos = np.broadcast_to(np.asarray(pos), lead)
    h, d = x.shape[-2], x.shape[-1]
    for r in np.ndindex(lead):
        p = float(pos[r])
        for hh in range(h):
            head = x[r + (hh,)]
            for i in range(d // 2):
                freq = 1.0 / (base ** (2.0 * i / d))
                th = p * freq * freq_scale
                c, s = np.cos(th), np.sin(th)
                if interleaved:
                    i0, i1 = 2 * i, 2 * i + 1
                else:
                    i0, i1 = i, i + d // 2
                x0, x1 = head[i0], head[i1]
                head[i0] = x0 * c - x1 * s
                head[i1] = x0 * s + x1 * c
    return x


__all__ = ["rope_cache", "llama3_inv_freq", "apply_rope", "rope",
           "rope_ref", "DEFAULT_BASE"]
