"""Shared numeric helpers and device resolution for the PyTorch port.

Conventions are those of the JAX package (``docs/CONVENTIONS.md``):

* GEMM: ``C[M, N] = A[M, K] @ W[N, K]^T`` with M = tokens, N = output
  features, K = reduction.
* Rounding: round-half-to-even everywhere (``torch.round`` / ``np.rint``,
  the semantics of CUDA ``rintf`` / ``__float2int_rn``).
* Block scales are stored as IEEE float16 and upcast to float32 for math.
"""

from __future__ import annotations

import torch


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return cdiv(x, m) * m


#: Largest finite float16 value — the saturation bound for stored scales.
F16_MAX = 65504.0


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks for
    the CPU.  Raises instead of quietly running on the CPU when CUDA is
    requested on a machine without a usable GPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "quant_gemm_tpu_torch: device 'cuda' requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w^T`` in float32 with TF32 off on a card (the setting is
    restored after): the float32 products the JAX package leaves to XLA
    outside any kernel (``Precision.HIGHEST`` or the CPU's float32)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return x.to(torch.float32) @ w.to(torch.float32).T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


__all__ = ["cdiv", "round_up", "F16_MAX", "resolve_device", "matmul_f32"]
