"""llama.cpp 32-element block formats: the containers the port uses.

A copy of the JAX package's ``formats/blocks.py``, trimmed to the formats
the serving slice runs (q4_0 weights, q8_0, and q8_1 activations).  The
containers are struct-of-arrays with the same *planar* packing, so arrays
move between the two packages unchanged:

======  =====  ======================================================
format  bytes  contents per 32-element block (GGUF AoS)
======  =====  ======================================================
q4_0      18   d: f16, qs: 16 B  (nibble j = x[j], nibble j+16 high)
q8_0      34   d: f16, qs: 32 x int8
q8_1      36   ds: (d, s) f16x2, qs: 32 x int8
======  =====  ======================================================

* 4-bit ``packed``: ``uint8[..., K/2]``; byte ``c`` holds ``x[c]`` in the
  low nibble and ``x[c + K/2]`` in the high nibble (row-level split).
* scales ``d`` (and ``s``): ``float16[..., K/32]``.

The kernel-side layout is chosen separately (``kernels/layout.py``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

QK = 32  # block size shared by all formats


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static metadata for one block format."""

    name: str
    block_bytes: int  # serialized AoS bytes per 32-element block
    bits: int  # bits per quantized value (before scales)
    has_min: bool  # asymmetric formats store m = min
    has_sum: bool  # q8_1: stores s = d * sum(q)
    offset: int  # value subtracted at dequant (q4_0: 8, else 0)
    qmax: int  # max stored code

    @property
    def bytes_per_elem(self) -> float:
        return self.block_bytes / QK


Q4_0 = QuantSpec("q4_0", 18, 4, has_min=False, has_sum=False, offset=8, qmax=15)
Q8_0 = QuantSpec("q8_0", 34, 8, has_min=False, has_sum=False, offset=0, qmax=127)
Q8_1 = QuantSpec("q8_1", 36, 8, has_min=False, has_sum=True, offset=0, qmax=127)

SPECS = {s.name: s for s in (Q4_0, Q8_0, Q8_1)}


class Q4_0Tensor(NamedTuple):
    """Q4_0: symmetric 4-bit, d = amax/7, dequant x = (q - 8) * d."""

    packed: object  # uint8[..., K/2] planar
    d: object  # float16[..., K/32]

    spec = Q4_0

    @property
    def k(self) -> int:
        return self.packed.shape[-1] * 2


class Q8_0Tensor(NamedTuple):
    """Q8_0: symmetric 8-bit, d = amax/127, dequant x = q * d."""

    qs: object  # int8[..., K]
    d: object

    spec = Q8_0

    @property
    def k(self) -> int:
        return self.qs.shape[-1]


class Q8_1Tensor(NamedTuple):
    """Q8_1 (activations): like Q8_0 plus per-block s = f16(d * sum(q)),
    the llama.cpp-exact sum (not the sum of the float inputs)."""

    qs: object
    d: object
    s: object  # float16[..., K/32]

    spec = Q8_1

    @property
    def k(self) -> int:
        return self.qs.shape[-1]


TENSOR_TYPES = {"q4_0": Q4_0Tensor, "q8_0": Q8_0Tensor, "q8_1": Q8_1Tensor}

__all__ = ["QK", "QuantSpec", "Q4_0", "Q8_0", "Q8_1", "SPECS", "Q4_0Tensor",
           "Q8_0Tensor", "Q8_1Tensor", "TENSOR_TYPES"]
