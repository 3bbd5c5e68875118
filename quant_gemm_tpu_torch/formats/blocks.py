"""llama.cpp 32-element block formats: the containers the port uses.

A copy of the JAX package's ``formats/blocks.py``.  The containers are
struct-of-arrays with the same *planar* packing, so arrays move between
the two packages unchanged:

======  =====  ======================================================
format  bytes  contents per 32-element block (GGUF AoS)
======  =====  ======================================================
q4_0      18   d: f16, qs: 16 B  (nibble j = x[j], nibble j+16 high)
q4_1      20   d: f16, m: f16, qs: 16 B
q5_0      22   d: f16, qh: 4 B (5th bits), qs: 16 B
q5_1      24   d: f16, m: f16, qh: 4 B, qs: 16 B
q8_0      34   d: f16, qs: 32 x int8
q8_1      36   ds: (d, s) f16x2, qs: 32 x int8
======  =====  ======================================================

* 4/5-bit ``packed``: ``uint8[..., K/2]``; byte ``c`` holds ``x[c]`` (its
  low four bits) in the low nibble and ``x[c + K/2]`` in the high nibble
  (row-level split);
* q5 5th bits ``qh``: ``uint8[..., K/8]``, bit ``c % 8`` of byte ``c // 8``
  is the high bit of ``x[c]`` (natural order);
* scales ``d`` (and ``m``/``s``): ``float16[..., K/32]``.

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
    offset: int  # value subtracted at dequant (q4_0: 8, q5_0: 16, else 0)
    qmax: int  # max stored code

    @property
    def bytes_per_elem(self) -> float:
        return self.block_bytes / QK


Q4_0 = QuantSpec("q4_0", 18, 4, has_min=False, has_sum=False, offset=8, qmax=15)
Q4_1 = QuantSpec("q4_1", 20, 4, has_min=True, has_sum=False, offset=0, qmax=15)
Q5_0 = QuantSpec("q5_0", 22, 5, has_min=False, has_sum=False, offset=16, qmax=31)
Q5_1 = QuantSpec("q5_1", 24, 5, has_min=True, has_sum=False, offset=0, qmax=31)
Q8_0 = QuantSpec("q8_0", 34, 8, has_min=False, has_sum=False, offset=0, qmax=127)
Q8_1 = QuantSpec("q8_1", 36, 8, has_min=False, has_sum=True, offset=0, qmax=127)

SPECS = {s.name: s for s in (Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q8_1)}


class Q4_0Tensor(NamedTuple):
    """Q4_0: symmetric 4-bit, d = amax/7, dequant x = (q - 8) * d."""

    packed: object  # uint8[..., K/2] planar
    d: object  # float16[..., K/32]

    spec = Q4_0

    @property
    def k(self) -> int:
        return self.packed.shape[-1] * 2


class Q4_1Tensor(NamedTuple):
    """Q4_1: asymmetric 4-bit, d = (max-min)/15, dequant x = q * d + m."""

    packed: object
    d: object
    m: object  # float16[..., K/32]

    spec = Q4_1

    @property
    def k(self) -> int:
        return self.packed.shape[-1] * 2


class Q5_0Tensor(NamedTuple):
    """Q5_0: symmetric 5-bit, d = amax/15, dequant x = (q - 16) * d."""

    packed: object  # low 4 bits, planar
    qh: object  # uint8[..., K/8] planar 5th bits
    d: object

    spec = Q5_0

    @property
    def k(self) -> int:
        return self.packed.shape[-1] * 2


class Q5_1Tensor(NamedTuple):
    """Q5_1: asymmetric 5-bit, d = (max-min)/31, dequant x = q * d + m."""

    packed: object
    qh: object
    d: object
    m: object

    spec = Q5_1

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


WEIGHT_TENSOR_TYPES = {"q4_0": Q4_0Tensor, "q4_1": Q4_1Tensor,
                       "q5_0": Q5_0Tensor, "q5_1": Q5_1Tensor,
                       "q8_0": Q8_0Tensor}
TENSOR_TYPES = dict(WEIGHT_TENSOR_TYPES, q8_1=Q8_1Tensor)

__all__ = ["QK", "QuantSpec", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q8_1",
           "SPECS", "Q4_0Tensor", "Q4_1Tensor", "Q5_0Tensor", "Q5_1Tensor",
           "Q8_0Tensor", "Q8_1Tensor", "WEIGHT_TENSOR_TYPES", "TENSOR_TYPES"]
