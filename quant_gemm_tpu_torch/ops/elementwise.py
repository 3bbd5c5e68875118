"""Elementwise ops in plain PyTorch (the JAX package leaves them to XLA),
with their numpy goldens."""

from __future__ import annotations

import numpy as np
import torch


def add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x + y


def mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x * y


def scale(x: torch.Tensor, s: float) -> torch.Tensor:
    return x * s


def add_scale(x: torch.Tensor, y: torch.Tensor, s: float) -> torch.Tensor:
    """Residual update ``x + s * y``."""
    return x + s * y


def add_ref(x, y) -> np.ndarray:
    return np.asarray(x, np.float32) + np.asarray(y, np.float32)


def mul_ref(x, y) -> np.ndarray:
    return np.asarray(x, np.float32) * np.asarray(y, np.float32)


def scale_ref(x, s) -> np.ndarray:
    return np.asarray(x, np.float32) * np.float32(s)


def add_scale_ref(x, y, s) -> np.ndarray:
    return (np.asarray(x, np.float32)
            + np.float32(s) * np.asarray(y, np.float32))


__all__ = ["add", "mul", "scale", "add_scale", "add_ref", "mul_ref",
           "scale_ref", "add_scale_ref"]
