"""The yardstick: bytes and operations of the serving work, and the peaks.

What every architecture's counts (``archs/<arch>.py``) share.  Work is
counted from a configuration's shapes and the traffic actually served
(prompt positions, batch contexts), never from which kernel ran it, so a
change of route or layout reads against the same bound.  Weights count at
llama.cpp's block bytes (the file's, not the program's device layout);
the linear maps count as W4A8 (int8 operations, Q8_1 activations of 36
bytes a 32-block), attention as bf16 operations over a bf16 cache.  A
bound is the larger of its bytes over the HBM rate and its operations
over the peak of their type, summed over the types.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit (the
numbers ``harness/profiling.py`` of the port uses).
"""

from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}

#: bytes of one block and the weights it holds (ggml-common.h)
BLOCK = {"q4_0": (18, 32), "q4_1": (20, 32), "q5_0": (22, 32),
         "q5_1": (24, 32), "q8_0": (34, 32), "q4_K": (144, 256),
         "q5_K": (176, 256), "q6_K": (210, 256), "f16": (2, 1),
         "f32": (4, 1)}
#: bytes of a Q8_1 activation element (32 int8 codes + f16 d and s)
Q8_1_BYTES = 36 / 32
F32 = 4
BF16 = 2


def tensor_bytes(qtype: str, n: int, k: int) -> float:
    nbytes, per = BLOCK[qtype]
    return n * k / per * nbytes


@dataclasses.dataclass
class Work:
    """Bytes and operations by type; ``+`` adds, :meth:`bound_s` is the
    least time the card could take."""

    nbytes: float = 0.0
    ops: dict = dataclasses.field(default_factory=dict)

    def __add__(self, other: "Work") -> "Work":
        ops = dict(self.ops)
        for k, v in other.ops.items():
            ops[k] = ops.get(k, 0.0) + v
        return Work(self.nbytes + other.nbytes, ops)

    def bound_s(self) -> float:
        t_ops = sum(v / PEAK_OPS[k] for k, v in self.ops.items())
        return max(self.nbytes / HBM_BYTES_PER_S, t_ops)


def gemm(qtype: str, m: int, n: int, k: int, io: bool) -> Work:
    """One W4A8 linear map of ``m`` rows; ``io``: count its Q8_1 input and
    float32 output (a kernel's view) besides its weight."""
    b = tensor_bytes(qtype, n, k)
    if io:
        b += m * k * Q8_1_BYTES + m * n * F32
    return Work(b, {"int8": 2.0 * m * n * k})


__all__ = ["HBM_BYTES_PER_S", "PEAK_OPS", "BLOCK", "Q8_1_BYTES", "F32",
           "BF16", "tensor_bytes", "Work", "gemm"]
