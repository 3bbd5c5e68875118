"""The yardstick: bytes and operations of the serving work, and the peaks.

Everything here is counted from a configuration's shapes and the traffic
actually served (prompt positions, batch contexts), never from which
kernel ran it, so a change of route or layout reads against the same
bound.  Weights count at llama.cpp's block bytes (the file's, not the
program's device layout); the linear maps count as W4A8 (int8 operations,
Q8_1 activations of 36 bytes a 32-block), attention as bf16 operations
over a bf16 cache.  A bound is the larger of its bytes over the HBM rate
and its operations over the peak of their type, summed over the types.

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


@dataclasses.dataclass(frozen=True)
class Shapes:
    """What the arithmetic needs of a configuration."""

    dim: int
    n_layers: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    window: int  # 0: full attention
    layer_type: str  # the block type of every layer linear
    head_type: str  # the output head's (or the tied embedding's)
    qkv_bias: bool

    @property
    def linears(self) -> list:
        """[(N, K)] of one layer's linear maps: wqkv, wo, wgu, w_down."""
        nq, nkv = self.n_heads * self.head_dim, self.n_kv * self.head_dim
        return [(nq + 2 * nkv, self.dim), (self.dim, nq),
                (2 * self.d_ff, self.dim), (self.dim, self.d_ff)]

    def small_bytes(self) -> float:
        """Every layer's two float32 norms and QKV bias."""
        per = 2 * self.dim + (self.linears[0][0] if self.qkv_bias else 0)
        return self.n_layers * per * F32

    def attended(self, position: int) -> int:
        """Cached tokens the query at ``position`` (0-based) attends, itself
        included."""
        n = position + 1
        return min(n, self.window) if self.window else n

    def kv_token_bytes(self) -> float:
        """bf16 k and v of one token over every layer."""
        return self.n_layers * 2 * self.n_kv * self.head_dim * BF16

    def attn_ops(self, attended: int) -> float:
        """bf16 operations of one query over ``attended`` tokens, every
        layer: q.k and p.v, 2 operations a multiply-add."""
        return self.n_layers * self.n_heads * 4 * self.head_dim * attended


def shapes(config: dict) -> Shapes:
    """:class:`Shapes` of a configuration file's contents."""
    p, s = config["published"], config["served"]
    heads = int(p["num_attention_heads"])
    return Shapes(dim=int(p["hidden_size"]),
                  n_layers=int(p["num_hidden_layers"]), n_heads=heads,
                  n_kv=int(p["num_key_value_heads"]),
                  head_dim=int(p.get("head_dim")
                               or p["hidden_size"] // heads),
                  d_ff=int(p["intermediate_size"]),
                  vocab=int(p["vocab_size"]), window=int(s["window"]),
                  layer_type=s["tensor_types"]["layers"],
                  head_type=s["tensor_types"]["output"],
                  qkv_bias=bool(s["qkv_bias"]))


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


def _gemm(sh: Shapes, qtype: str, m: int, n: int, k: int,
          io: bool) -> Work:
    """One W4A8 linear map of ``m`` rows; ``io``: count its Q8_1 input and
    float32 output (a kernel's view) besides its weight."""
    b = tensor_bytes(qtype, n, k)
    if io:
        b += m * k * Q8_1_BYTES + m * n * F32
    return Work(b, {"int8": 2.0 * m * n * k})


def gemms(sh: Shapes, m: int, head_rows: int, io: bool = True) -> Work:
    """The linear maps of one forward call over ``m`` rows: every layer's,
    and the head over ``head_rows`` rows (none: the head is not run)."""
    w = Work()
    for _ in range(sh.n_layers):
        for n, k in sh.linears:
            w = w + _gemm(sh, sh.layer_type, m, n, k, io)
    if head_rows:
        w = w + _gemm(sh, sh.head_type, head_rows, sh.vocab, sh.dim, io)
    return w


def decode_step(sh: Shapes, contexts: list) -> Work:
    """One decode step of the slots at ``contexts`` (each the tokens its
    query attends, itself included, the window applied): the weights read
    once, every slot's cache read, the new token's k and v written, the
    embedding rows and the logits; W4A8 linear maps and bf16 attention."""
    m = len(contexts)
    w = gemms(sh, m, m, io=False)
    w.nbytes += sh.small_bytes() + sh.dim * F32
    w.nbytes += sum(contexts) * sh.kv_token_bytes() + m * sh.kv_token_bytes()
    w.nbytes += m * sh.dim * BF16 + m * sh.vocab * F32
    w.ops["bf16"] = w.ops.get("bf16", 0.0) + sum(sh.attn_ops(c)
                                                  for c in contexts)
    return w


def prefill_chunk(sh: Shapes, start: int, n: int, last: bool) -> Work:
    """One prefill chunk of ``n`` prompt tokens at positions ``start ..
    start + n - 1`` of one request: the weights read once, the cache rows
    the chunk attends read once and its own written, the embedding rows,
    and, for the request's last chunk, the head over the one row whose
    logits are used."""
    w = gemms(sh, n, 1 if last else 0, io=False)
    w.nbytes += sh.small_bytes()
    if last:
        w.nbytes += sh.dim * F32 + sh.vocab * F32
    first = start - sh.attended(start) + 1  # oldest position attended
    w.nbytes += (start + n - first) * sh.kv_token_bytes()
    w.nbytes += n * sh.kv_token_bytes() + n * sh.dim * BF16
    w.ops["bf16"] = w.ops.get("bf16", 0.0) + sum(
        sh.attn_ops(sh.attended(p)) for p in range(start, start + n))
    return w


def decode_gemms(sh: Shapes, m: int) -> Work:
    """The linear maps and head of one decode step of ``m`` slots, each
    with its Q8_1 input and float32 output (the kernels' bound)."""
    return gemms(sh, m, m, io=True)


def chunk_gemms(sh: Shapes, n: int, last: bool) -> Work:
    """The linear maps of a prefill chunk of ``n`` tokens, and the head
    over the one row whose logits are used (its last chunk only), with
    their inputs and outputs."""
    return gemms(sh, n, 1 if last else 0, io=True)


__all__ = ["HBM_BYTES_PER_S", "PEAK_OPS", "BLOCK", "Q8_1_BYTES",
           "tensor_bytes", "Shapes", "shapes", "Work", "gemms",
           "decode_step", "prefill_chunk", "decode_gemms", "chunk_gemms"]
