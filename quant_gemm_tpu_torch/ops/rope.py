"""Rotary position embeddings in plain PyTorch (split layout, llama).

``theta_i = pos * freq_scale / base^(2i / head_dim)``; the pair
``(x[i], x[i + d/2])`` rotates to ``(x0 c - x1 s, x0 s + x1 c)``.  The
tables are computed in float64 with numpy and cast to float32, as the JAX
package does, so both packages hold the same tables bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_BASE = 10000.0


def rope_cache(max_pos: int, head_dim: int, base: float = DEFAULT_BASE,
               freq_scale: float = 1.0, device="cpu", inv_freq=None):
    """cos/sin tables ``float32 [max_pos, head_dim/2]`` on ``device``.

    ``inv_freq``: optional per-dimension inverse frequencies [head_dim/2]
    (a tensor or array) that replace the ``base**(-2i/d)`` spectrum, such
    as a GGUF file's ``rope_freqs.weight`` divisors applied by the loader;
    its float32 values are widened to float64 for the phases, as in JAX."""
    if inv_freq is None:
        inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float64)
                                   / head_dim))
    elif isinstance(inv_freq, torch.Tensor):
        inv_freq = inv_freq.detach().cpu().numpy()
    inv_freq = np.asarray(inv_freq, np.float64)
    t = np.arange(max_pos, dtype=np.float64)[:, None] * inv_freq[None, :] \
        * freq_scale
    return (torch.tensor(np.cos(t), dtype=torch.float32, device=device),
            torch.tensor(np.sin(t), dtype=torch.float32, device=device))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, cache) -> torch.Tensor:
    """Rotate ``x[..., H, D]`` by positions ``pos[...]`` (split layout).

    Positions past the table clamp to its last row, as a JAX gather does;
    only padded or inactive rows ever reach them."""
    cos_t, sin_t = cache
    pos = pos.clamp(0, cos_t.shape[0] - 1)
    cos = cos_t[pos][..., None, :]
    sin = sin_t[pos][..., None, :]
    d = x.shape[-1]
    x32 = x.to(torch.float32)
    x0, x1 = x32[..., : d // 2], x32[..., d // 2:]
    out = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.to(x.dtype)


__all__ = ["rope_cache", "apply_rope", "DEFAULT_BASE"]
