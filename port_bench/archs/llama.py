"""The llama block (Llama, Mistral, Qwen2): its set-up, work counts and
reference, behind the interface that every ``archs/<arch>.py`` keeps
(``harness.py`` states it).

Pre-norm decoder layers of grouped-query attention (RoPE, optional QKV
biases, optional sliding window) and a SwiGLU MLP, served by the
program's ``models/llama.py`` through ``models/serve.py``'s ``Server``.
The weights are llama.cpp blocks drawn on the card from the seed and
handed over as the program's GGUF loader does (``weights.py``); the
reference is ``reference/model.py`` over the same blocks in float32.

The work counts follow ``work.py``'s rules: four linear maps a layer
(wqkv, wo, wgu, w_down) at the layers' block type, the head at its own,
attention over a bf16 cache of k and v heads.
"""

from __future__ import annotations

import dataclasses
import functools

from port_bench import weights
from port_bench.reference import model as ref
from port_bench.work import BF16, F32, Work, gemm


def llama_config(config: dict):
    """The program's ``LlamaConfig`` of a configuration file."""
    from quant_gemm_tpu_torch.models import llama

    p, s = config["published"], config["served"]
    heads = int(p["num_attention_heads"])
    hd = int(p.get("head_dim") or p["hidden_size"] // heads)
    return llama.LlamaConfig(
        vocab=int(p["vocab_size"]), dim=int(p["hidden_size"]),
        n_layers=int(p["num_hidden_layers"]), n_heads=heads,
        n_kv_heads=int(p["num_key_value_heads"]),
        d_ff=int(p["intermediate_size"]),
        max_seq=int(p["max_position_embeddings"]),
        rope_base=float(p["rope_theta"]), eps=float(p["rms_norm_eps"]),
        window=int(s["window"]), ring=bool(s["ring"]),
        ring_chunk=int(s.get("ring_chunk", 256)),
        head_dim_override=(hd if hd != int(p["hidden_size"]) // heads
                           else 0))


def program(config: dict, seed: int, device) -> tuple:
    """(the weights' ``weights.Model``, the program's params, its
    ``LlamaConfig``)."""
    model = weights.Model(config, seed, device)
    return model, weights.program_params(model), llama_config(config)


def server(params: dict, program_config, served: dict, device):
    """The program's ``Server`` over ``params``, as its entry points
    build it."""
    from quant_gemm_tpu_torch.models import serve

    return serve.Server(params, program_config,
                        n_slots=int(served["n_slots"]),
                        prefill_bucket=int(served["prefill_bucket"]),
                        cache_qtype=served["cache_qtype"], device=device)


@dataclasses.dataclass(frozen=True)
class Shapes:
    """What the arithmetic needs of a configuration, and its work
    counts."""

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

    def gemms(self, m: int, head_rows: int, io: bool = True) -> Work:
        """The linear maps of one forward call over ``m`` rows: every
        layer's, and the head over ``head_rows`` rows (none: the head is
        not run)."""
        w = Work()
        for _ in range(self.n_layers):
            for n, k in self.linears:
                w = w + gemm(self.layer_type, m, n, k, io)
        if head_rows:
            w = w + gemm(self.head_type, head_rows, self.vocab, self.dim, io)
        return w

    def decode_step(self, contexts: list) -> Work:
        """One decode step of the slots at ``contexts`` (each the tokens its
        query attends, itself included, the window applied): the weights
        read once, every slot's cache read, the new token's k and v
        written, the embedding rows and the logits; W4A8 linear maps and
        bf16 attention."""
        m = len(contexts)
        w = self.gemms(m, m, io=False)
        w.nbytes += self.small_bytes() + self.dim * F32
        w.nbytes += sum(contexts) * self.kv_token_bytes() \
            + m * self.kv_token_bytes()
        w.nbytes += m * self.dim * BF16 + m * self.vocab * F32
        w.ops["bf16"] = w.ops.get("bf16", 0.0) + sum(self.attn_ops(c)
                                                      for c in contexts)
        return w

    def prefill_chunk(self, start: int, n: int, last: bool) -> Work:
        """One prefill chunk of ``n`` prompt tokens at positions ``start ..
        start + n - 1`` of one request: the weights read once, the cache
        rows the chunk attends read once and its own written, the
        embedding rows, and, for the request's last chunk, the head over
        the one row whose logits are used."""
        w = self.gemms(n, 1 if last else 0, io=False)
        w.nbytes += self.small_bytes()
        if last:
            w.nbytes += self.dim * F32 + self.vocab * F32
        first = start - self.attended(start) + 1  # oldest position attended
        w.nbytes += (start + n - first) * self.kv_token_bytes()
        w.nbytes += n * self.kv_token_bytes() + n * self.dim * BF16
        w.ops["bf16"] = w.ops.get("bf16", 0.0) + sum(
            self.attn_ops(self.attended(p)) for p in range(start, start + n))
        return w

    def decode_gemms(self, m: int) -> Work:
        """The linear maps and head of one decode step of ``m`` slots, each
        with its Q8_1 input and float32 output (the kernels' bound)."""
        return self.gemms(m, m, io=True)

    def chunk_gemms(self, n: int, last: bool) -> Work:
        """The linear maps of a prefill chunk of ``n`` tokens, and the head
        over the one row whose logits are used (its last chunk only), with
        their inputs and outputs."""
        return self.gemms(n, 1 if last else 0, io=True)


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


def reference_arch(config: dict) -> ref.Arch:
    sh = shapes(config)
    p = config["published"]
    return ref.Arch(dim=sh.dim, n_layers=sh.n_layers, n_heads=sh.n_heads,
                    n_kv=sh.n_kv, head_dim=sh.head_dim, d_ff=sh.d_ff,
                    vocab=sh.vocab, eps=float(p["rms_norm_eps"]),
                    rope_theta=float(p["rope_theta"]), window=sh.window,
                    qkv_bias=sh.qkv_bias)


def reference(config: dict, model: weights.Model):
    """``logits(seqs, rows, bits=None)``: ``reference.model.logits`` over
    ``model``'s blocks in float32."""
    return functools.partial(ref.logits, reference_arch(config),
                             weights.ReferenceWeights(model))


__all__ = ["llama_config", "program", "server", "Shapes", "shapes",
           "reference_arch", "reference"]
