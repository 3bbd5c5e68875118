"""Seeded data generation (numpy): uniform and normal, seed 42 by
default.  Copies of the JAX package's ``harness/datagen.py`` functions, so
that both packages draw the same inputs from a seed."""

from __future__ import annotations

import numpy as np

DEFAULT_SEED = 42


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def uniform(shape, low=-1.0, high=1.0, seed: int = DEFAULT_SEED) -> np.ndarray:
    return _rng(seed).uniform(low, high, size=shape).astype(np.float32)


def normal(shape, mean=0.0, std=0.5, seed: int = DEFAULT_SEED) -> np.ndarray:
    """Default std 0.5, the GEMM test data's distribution."""
    return (_rng(seed).standard_normal(size=shape) * std + mean).astype(
        np.float32)


__all__ = ["uniform", "normal", "DEFAULT_SEED"]
