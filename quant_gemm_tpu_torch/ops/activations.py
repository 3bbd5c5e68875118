"""SiLU and GELU in plain PyTorch (the JAX package runs them through XLA).

* ``silu(x) = x * sigmoid(x)``; ``silu_mul(x, gate) = silu(x) * gate``, the
  llama FFN activation;
* ``gelu(x) = 0.5 x (1 + erf(x / sqrt(2)))``, the exact form;
* ``gelu_quick(x) = 0.5 x (1 + tanh(sqrt(2/pi) x (1 + 0.044715 x^2)))``,
  llama.cpp's tanh approximation.

The ``*_ref`` functions are the goldens (numpy, scalar ``math.erf`` for
GELU), copies of the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

GELU_COEF_A = 0.044715
SQRT_2_OVER_PI = 0.7978845608028654
# the JAX package's float32 1 / sqrt(2), rounded as it rounds it
_INV_SQRT2 = float(1.0 / np.sqrt(2.0).astype(np.float32))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def silu_mul(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    return silu(x) * gate


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * _INV_SQRT2))


def gelu_quick(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(
        SQRT_2_OVER_PI * x * (1.0 + GELU_COEF_A * x * x)))


_erf_vec = np.vectorize(math.erf)


def silu_ref(x) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return x / (1.0 + np.exp(-x))


def silu_mul_ref(x, gate) -> np.ndarray:
    return silu_ref(x) * np.asarray(gate, np.float32)


def gelu_ref(x) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return (0.5 * x * (1.0 + _erf_vec(x / math.sqrt(2.0)))).astype(np.float32)


def gelu_quick_ref(x) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return 0.5 * x * (1.0 + np.tanh(
        SQRT_2_OVER_PI * x * (1.0 + GELU_COEF_A * x * x)))


__all__ = ["silu", "silu_mul", "gelu", "gelu_quick", "silu_ref",
           "silu_mul_ref", "gelu_ref", "gelu_quick_ref", "GELU_COEF_A",
           "SQRT_2_OVER_PI"]
