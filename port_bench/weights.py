"""A model's weights as llama.cpp blocks, drawn on the card from the seed.

Each tensor of a GGUF file of the configuration's mix (llama.cpp's tensor
names) is drawn with a ``torch.Generator`` of its own, seeded from the
run's seed and the tensor's name, in a few large calls: random code bytes
and f16 block scales of random sign whose size gives each linear map an
output about as large as its input (``weights.scale`` of the
configuration; the head ``weights.head_scale`` times that, the q and k
projections ``weights.qk_scale`` times it, 1 by default), norms in [0.8,
1.2), QKV biases normal with ``weights.bias_std``.  So the same seed
gives the same bytes, and the comparison can draw a tensor again instead
of holding a copy.

:func:`program_params` hands the blocks to the program as its GGUF loader
does (``models/gguf_loader.py``): decoded to the program's containers,
``wqkv`` and ``wgu`` as the concatenation of their parts' rows, each
weight through the program's layout step (``layout.prepare`` for per-32
blocks, ``layout.prepare_k16`` for q6_K), the embedding dequantized to
bf16, a tied head served from ``token_embd``.  :class:`ReferenceWeights`
gives the plain reference the same blocks in float32, dequantized by
``reference/blocks.py``.
"""

from __future__ import annotations

import hashlib
import math

import torch

from .reference import blocks as ref_blocks

#: rms of a q4_0 code minus 8 (uniform 0..15) and of a q6_K code minus 32
#: times an int8 scale (both uniform): the factors that make a tensor's
#: weights about ``scale / sqrt(K)`` in rms
_Q4_0_RMS = math.sqrt((16 ** 2 - 1) / 12 + 0.25)
_Q6_K_RMS = math.sqrt((64 ** 2 - 1) / 12 + 0.25) * math.sqrt(
    (256 ** 2 - 1) / 12 + 0.25)


def generator(seed: int, name: str, device) -> torch.Generator:
    """The ``torch.Generator`` that draws the tensor ``name`` under
    ``seed``: the same seed and name give the same bytes."""
    h = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(h[:8], "little") & 0x7FFFFFFFFFFFFFFF)


def _scales(n, nb, k, scale, rms, g, device) -> torch.Tensor:
    """f16 block scales ``[N, nb]`` of random sign and size ``scale / (rms
    sqrt(K))`` times a factor uniform in [0.5, 1.5), as bytes [N, nb, 2]."""
    d = (torch.rand(n, nb, generator=g, device=device) + 0.5) \
        * (scale / (rms * math.sqrt(k)))
    sign = torch.randint(0, 2, (n, nb), generator=g, device=device) * 2 - 1
    d16 = (d * sign).to(torch.float16).contiguous()
    return d16.view(torch.uint8).reshape(n, nb, 2)


def draw(qtype: str, n: int, k: int, scale: float, g, device) -> torch.Tensor:
    """``uint8 [N, K / per, block bytes]``: the rows' llama.cpp blocks."""
    if qtype == "q4_0":
        nb = k // 32
        d = _scales(n, nb, k, scale, _Q4_0_RMS, g, device)
        qs = torch.randint(0, 256, (n, nb, 16), generator=g, device=device,
                           dtype=torch.uint8)
        return torch.cat([d, qs], dim=-1)
    if qtype == "q6_K":
        nb = k // 256
        body = torch.randint(0, 256, (n, nb, 208), generator=g,
                             device=device, dtype=torch.uint8)
        d = _scales(n, nb, k, scale, _Q6_K_RMS, g, device)
        return torch.cat([body, d], dim=-1)
    raise NotImplementedError(f"drawing {qtype} blocks")


class Model:
    """The tensors of one configuration under one seed: ``tensor(name)``
    draws a GGUF tensor's bytes again on ``device`` (block tensors as
    ``uint8 [N, K / per, block bytes]``, float32 ones as float32)."""

    def __init__(self, config: dict, seed: int, device):
        p, s = config["published"], config["served"]
        self.config = config
        self.seed = int(seed)
        self.device = device
        self.dim = int(p["hidden_size"])
        heads = int(p["num_attention_heads"])
        self.head_dim = int(p.get("head_dim") or self.dim // heads)
        self.nq = heads * self.head_dim
        self.nkv = int(p["num_key_value_heads"]) * self.head_dim
        self.d_ff = int(p["intermediate_size"])
        self.vocab = int(p["vocab_size"])
        self.n_layers = int(p["num_hidden_layers"])
        self.types = s["tensor_types"]
        self.tied = bool(p.get("tie_word_embeddings", False))
        self.qkv_bias = bool(s["qkv_bias"])
        self.w = config["weights"]

    def shape(self, name: str) -> tuple:
        """(N, K) of a linear, (N,) of a vector."""
        leaf = name.split(".", 2)[-1] if name.startswith("blk.") else name
        return {"attn_q.weight": (self.nq, self.dim),
                "attn_k.weight": (self.nkv, self.dim),
                "attn_v.weight": (self.nkv, self.dim),
                "attn_output.weight": (self.dim, self.nq),
                "ffn_gate.weight": (self.d_ff, self.dim),
                "ffn_up.weight": (self.d_ff, self.dim),
                "ffn_down.weight": (self.dim, self.d_ff),
                "attn_q.bias": (self.nq,), "attn_k.bias": (self.nkv,),
                "attn_v.bias": (self.nkv,),
                "attn_norm.weight": (self.dim,),
                "ffn_norm.weight": (self.dim,),
                "output_norm.weight": (self.dim,),
                "token_embd.weight": (self.vocab, self.dim),
                "output.weight": (self.vocab, self.dim)}[leaf]

    def qtype(self, name: str) -> str:
        if name == "token_embd.weight":
            return self.types["output" if self.tied else "token_embd"]
        if name == "output.weight":
            return self.types["output"]
        if name.endswith(".bias") or "norm" in name:
            return "f32"
        return self.types["layers"]

    def tensor(self, name: str) -> torch.Tensor:
        g = generator(self.seed, name, self.device)
        shape = self.shape(name)
        if len(shape) == 1:
            if name.endswith(".bias"):
                return torch.randn(shape, generator=g, device=self.device) \
                    * float(self.w["bias_std"])
            return 0.8 + 0.4 * torch.rand(shape, generator=g,
                                          device=self.device)
        n, k = shape
        scale = float(self.w["scale"])
        if name.endswith(("attn_q.weight", "attn_k.weight")):
            scale *= float(self.w.get("qk_scale", 1.0))
        if name in ("output.weight", "token_embd.weight"):
            scale *= float(self.w["head_scale"])
        return draw(self.qtype(name), n, k, scale, g, self.device)

    def head_name(self) -> str:
        return "token_embd.weight" if self.tied else "output.weight"


def program_params(model: Model) -> dict:
    """The program's serving parameters from the blocks, as its GGUF loader
    builds them."""
    from quant_gemm_tpu_torch.formats import kquants
    from quant_gemm_tpu_torch.formats import quant as tq
    from quant_gemm_tpu_torch.formats.gguf_file import from_block_bytes
    from quant_gemm_tpu_torch.kernels import layout

    def container(name, raw):
        qt = model.qtype(name)
        return kquants.from_bytes_q6_k(raw) if qt == "q6_K" \
            else from_block_bytes(raw, qt)

    def prepared(names):
        raws = [model.tensor(nm) for nm in names]
        qt = model.qtype(names[0])
        raw = torch.cat(raws, dim=0) if len(raws) > 1 else raws[0]
        del raws
        t = container(names[0], raw)
        return layout.prepare_k16(t) if qt == "q6_K" else layout.prepare(t)

    emb = container("token_embd.weight", model.tensor("token_embd.weight"))
    embed = (kquants.dequantize_q6_k(emb) if model.qtype("token_embd.weight")
             == "q6_K" else tq.dequantize(emb)).to(torch.bfloat16)
    del emb
    out = {"embed": embed,
           "final_norm": model.tensor("output_norm.weight"), "layers": []}
    for i in range(model.n_layers):
        b = f"blk.{i}."
        lyr = {"attn_norm": model.tensor(b + "attn_norm.weight"),
               "mlp_norm": model.tensor(b + "ffn_norm.weight")}
        if model.qkv_bias:
            lyr["bqkv"] = torch.cat([model.tensor(b + f"attn_{t}.bias")
                                     for t in "qkv"])
        lyr["wqkv"] = prepared([b + f"attn_{t}.weight" for t in "qkv"])
        lyr["wo"] = prepared([b + "attn_output.weight"])
        lyr["wgu"] = prepared([b + "ffn_gate.weight", b + "ffn_up.weight"])
        lyr["w_down"] = prepared([b + "ffn_down.weight"])
        out["layers"].append(lyr)
    out["lm_head"] = prepared([model.head_name()])
    return out


class ReferenceWeights:
    """The same blocks in float32 for ``reference.model.logits``,
    dequantized by the reference's own decoders, one layer at a time."""

    def __init__(self, model: Model):
        self.m = model

    def _f32(self, name: str) -> torch.Tensor:
        t = self.m.tensor(name)
        qt = self.m.qtype(name)
        return t if qt == "f32" else ref_blocks.DEQUANT[qt](t)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        raw = self.m.tensor("token_embd.weight")
        rows = raw[ids.to(raw.device)]
        return ref_blocks.DEQUANT[self.m.qtype("token_embd.weight")](rows)

    def layer(self, i: int) -> dict:
        b = f"blk.{i}."
        w = {"attn_norm": self._f32(b + "attn_norm.weight"),
             "mlp_norm": self._f32(b + "ffn_norm.weight")}
        for key, name in (("wq", "attn_q.weight"), ("wk", "attn_k.weight"),
                          ("wv", "attn_v.weight"),
                          ("wo", "attn_output.weight"),
                          ("w_gate", "ffn_gate.weight"),
                          ("w_up", "ffn_up.weight"),
                          ("w_down", "ffn_down.weight")):
            w[key] = self._f32(b + name)
        if self.m.qkv_bias:
            for t in "qkv":
                w[f"b{t}"] = self._f32(b + f"attn_{t}.bias")
        return w

    def final_norm(self) -> torch.Tensor:
        return self._f32("output_norm.weight")

    def head(self) -> torch.Tensor:
        return self._f32(self.m.head_name())


__all__ = ["generator", "draw", "Model", "program_params",
           "ReferenceWeights"]
