"""Load a llama.cpp GGUF checkpoint into the port's serving parameters.

Counterpart of ``quant_gemm_tpu/models/gguf_loader.py::load_llama`` and
``config_from_metadata``: a file with llama.cpp's tensor names
(``token_embd.weight``, ``blk.{i}.attn_q.weight``, ..., ``output.weight``)
and ``<arch>.*`` metadata loads into the parameters
:func:`~.llama.forward` and :class:`~.serve.Server` take.  Every tensor's
bytes are moved to the target device and decoded there:

* per-32 weights (q4_0, q4_1, q5_0, q5_1, q8_0), q4_K and q5_K
  weights in their effective q4_1 / q5_1 form (``kquants.to_effective``,
  ``to_effective_q5_k``), iq4_nl weights as q8_0 and iq4_xs weights in
  their effective form (``kquants.EffectiveQ80``, K1/K4/K6's ``iq4_xs``)
  become ``layout.PreparedWeight`` (K1/K4, and K2/K6 where their rules
  take them); q6_K, q3_K and q2_K weights become ``layout.PreparedK16``
  (K7); a float tensor in a weight slot is quantized to q4_0, as in JAX.
  So llama.cpp's Q4_0, Q8_0, Q5_0, Q4_1, Q5_1, Q4_K_M, Q5_K_M, IQ4_NL and
  IQ4_XS files load;
* q/k/v and gate/up are fused into ``wqkv`` / ``wgu`` when their parts
  share a format (block quantization is row-local, so the concatenation
  is bit-identical), and kept as a :class:`~.llama.SplitLinear` when they
  do not (a Q4_K_M file's q6_K ``attn_v``);
* the embedding, in any of these formats, is dequantized to bf16; a file
  without ``output.weight``
  (tied embeddings) serves ``lm_head`` from ``token_embd``;
* ``rope_freqs.weight`` becomes ``params["rope_inv_freq"]`` (llama.cpp's
  per-dimension divisors of the base spectrum);
* the qwen2 family's ``blk.{i}.attn_{q,k,v}.bias`` become the layer's
  float32 ``bqkv`` (their concatenation), as in JAX.

:func:`export_gguf` writes float parameters as a quantized GGUF with the
same names, byte-identical to the JAX ``export_gguf``'s file.  A q8_0
(or iq4_nl, or iq4_xs) model decodes without K2, whose JAX kernel takes
none of them either.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import kquants
from ..formats import quant as tq
from ..formats.blocks import WEIGHT_TENSOR_TYPES
from ..formats.gguf_file import GGUFFile, write_gguf
from ..kernels import layout
from ..utils import resolve_device
from . import llama

# llama.cpp tensor-name convention
_EMBED = "token_embd.weight"
_OUT_NORM = "output_norm.weight"
_OUTPUT = "output.weight"
_BLK = {
    "attn_norm": "blk.{i}.attn_norm.weight",
    "wq": "blk.{i}.attn_q.weight",
    "wk": "blk.{i}.attn_k.weight",
    "wv": "blk.{i}.attn_v.weight",
    "wo": "blk.{i}.attn_output.weight",
    "mlp_norm": "blk.{i}.ffn_norm.weight",
    "w_gate": "blk.{i}.ffn_gate.weight",
    "w_up": "blk.{i}.ffn_up.weight",
    "w_down": "blk.{i}.ffn_down.weight",
}

# llama-architecture family: the same graph, config keys prefixed by
# general.architecture
SUPPORTED_ARCHS = ("llama", "qwen2", "mistral")


def config_from_metadata(md: dict) -> llama.LlamaConfig:
    """A :class:`~.llama.LlamaConfig` from ``<arch>.*`` GGUF metadata."""
    arch = md.get("general.architecture", "llama")
    if arch not in SUPPORTED_ARCHS:
        raise ValueError(
            f"general.architecture={arch!r} is not a supported llama-family "
            f"architecture (known: {SUPPORTED_ARCHS})")

    def get(key, default=None):
        v = md.get(f"{arch}.{key}", default)
        if v is None:
            raise KeyError(f"GGUF metadata missing {arch}.{key}")
        return v

    n_heads = int(get("attention.head_count"))
    return llama.LlamaConfig(
        vocab=int(get("vocab_size",
                      md.get("tokenizer.ggml.tokens_count", 32000))),
        dim=int(get("embedding_length")),
        n_layers=int(get("block_count")),
        n_heads=n_heads,
        n_kv_heads=int(get("attention.head_count_kv", n_heads)),
        d_ff=int(get("feed_forward_length")),
        max_seq=int(get("context_length", 2048)),
        rope_base=float(get("rope.freq_base", 10000.0)),
        eps=float(get("attention.layer_norm_rms_epsilon", 1e-5)),
        window=int(get("attention.sliding_window", 0)),
        rope_scale=_rope_scale_from_metadata(md, arch),
        head_dim_override=int(get("attention.key_length", 0)),
    )


def _rope_scale_from_metadata(md: dict, arch: str = "llama") -> float:
    """llama.cpp's LINEAR rope scaling divides positions by ``factor``;
    other scaling types (yarn, ...) are refused rather than served with
    every token mispositioned."""
    factor = float(md.get(f"{arch}.rope.scaling.factor", 1.0))
    stype = md.get(f"{arch}.rope.scaling.type", "linear")
    if factor in (0.0, 1.0):
        return 1.0
    if stype != "linear":
        raise ValueError(
            f"unsupported rope scaling type {stype!r} (factor {factor}); "
            "only linear scaling is implemented")
    return 1.0 / factor


def _concat(parts):
    """Concatenate containers of one format on the out-feature axis, or
    None when their formats differ (the caller keeps a SplitLinear)."""
    t0 = parts[0]
    if any(type(p) is not type(t0) for p in parts):
        return None
    if isinstance(t0, torch.Tensor):
        return torch.cat(parts, dim=0)
    return type(t0)(*(torch.cat(f, dim=0) for f in zip(*parts)))


_PER32 = tuple(WEIGHT_TENSOR_TYPES.values()) + (kquants.EffectiveQ80,)


def _prep(t):
    """A loaded tensor in a weight slot -> the port's kernel weight."""
    if isinstance(t, torch.Tensor):  # float tensor in a quantized slot
        return layout.prepare(tq.quantize_q4_0(t.to(torch.float32)))
    if isinstance(t, kquants.Q4_KTensor):
        return layout.prepare(kquants.to_effective(t))
    if isinstance(t, kquants.Q5_KTensor):
        return layout.prepare(kquants.to_effective_q5_k(t))
    if isinstance(t, kquants.K16_TENSORS):
        return layout.prepare_k16(t)
    if not isinstance(t, _PER32):
        raise NotImplementedError(
            f"{type(t).__name__} weights are not served (q4_0, q4_1, q5_0, "
            "q5_1, q8_0, q4_K, q5_K, q6_K, q3_K, q2_K, iq4_nl, iq4_xs are)")
    return layout.prepare(t)


def _dequantize(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32)
    if isinstance(t, kquants.EffectiveQ80):
        return kquants.dequantize_iq4(t)
    if isinstance(t, _PER32):
        return tq.dequantize(t)
    return kquants.DEQUANT[type(t)](t)


def load_llama(path, device="cuda") -> tuple[dict, llama.LlamaConfig]:
    """A GGUF file (path or open :class:`GGUFFile`) -> (params, config),
    the parameters on ``device``."""
    dev = resolve_device(device)
    if isinstance(path, GGUFFile):
        return _load(path, dev)
    with GGUFFile(path) as gf:
        return _load(gf, dev)


def _load(gf: GGUFFile, dev: torch.device):
    cfg = config_from_metadata(gf.metadata)

    def load(name):
        return gf.load(name, dev)

    def f32(name):
        return load(name).to(torch.float32)

    out = {"embed": _dequantize(load(_EMBED)).to(torch.bfloat16),
           "final_norm": f32(_OUT_NORM), "layers": []}
    for i in range(cfg.n_layers):
        names = {k: v.format(i=i) for k, v in _BLK.items()}
        lyr = {"attn_norm": f32(names["attn_norm"]),
               "mlp_norm": f32(names["mlp_norm"])}
        bias = [f"blk.{i}.attn_{t}.bias" for t in "qkv"]
        if all(n in gf.tensors for n in bias):  # the qwen2 family
            lyr["bqkv"] = torch.cat([f32(n).reshape(-1) for n in bias])
        for slot, keys in (("wqkv", ("wq", "wk", "wv")),
                           ("wgu", ("w_gate", "w_up"))):
            parts = [load(names[k]) for k in keys]
            fused = _concat(parts)
            lyr[slot] = (llama.SplitLinear(tuple(_prep(p) for p in parts))
                         if fused is None else _prep(fused))
        lyr["wo"] = _prep(load(names["wo"]))
        lyr["w_down"] = _prep(load(names["w_down"]))
        out["layers"].append(lyr)
    # tied word embeddings: llama.cpp falls back to token_embd
    out["lm_head"] = _prep(load(_OUTPUT if _OUTPUT in gf.tensors else _EMBED))
    if "rope_freqs.weight" in gf.tensors:
        # llama.cpp's per-dimension DIVISORS of the base spectrum (ggml
        # rope_ext: theta = theta_base / freq_factor)
        factors = gf.load("rope_freqs.weight", "cpu").to(torch.float32)
        base_inv = 1.0 / (cfg.rope_base ** (
            np.arange(0, cfg.head_dim, 2, dtype=np.float64) / cfg.head_dim))
        out["rope_inv_freq"] = torch.tensor(
            base_inv.astype(np.float32) / factors.numpy().reshape(-1),
            device=dev)
    return out, cfg


def export_gguf(path, params: dict, cfg: llama.LlamaConfig,
                qtype: str = "q4_0",
                tokenizer_metadata: dict | None = None) -> None:
    """Write float parameters (the :func:`~.llama.init_params` layout,
    numpy or CPU tensors) as a quantized GGUF: the JAX ``export_gguf``,
    byte for byte.  The linears quantize to ``qtype`` (a per-32 format,
    through the port's quantizers, bit-equal to the JAX package's),
    the embedding and norms stay float32, qwen2-family ``bq``/``bk``/
    ``bv`` go in as float32 ``attn_{q,k,v}.bias``; llama.cpp names and
    ``llama.*`` metadata, plus ``tokenizer_metadata`` (``tokenizer.ggml.
    *`` keys), so that the file loads here, in JAX and in llama.cpp."""
    quantize = tq.QUANTIZE[qtype]

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    tensors: dict = {_EMBED: f32(params["embed"]),
                     _OUT_NORM: f32(params["final_norm"]),
                     _OUTPUT: quantize(f32(params["lm_head"]))}
    for i, lyr in enumerate(params["layers"]):
        names = {k: v.format(i=i) for k, v in _BLK.items()}
        for norm in ("attn_norm", "mlp_norm"):
            tensors[names[norm]] = f32(lyr[norm])
        for lin in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            tensors[names[lin]] = quantize(f32(lyr[lin]))
        for bn in ("bq", "bk", "bv"):
            if bn in lyr:
                tensors[f"blk.{i}.attn_{bn[1]}.bias"] = f32(lyr[bn])
    metadata = {
        "general.architecture": "llama",
        "general.name": "quant_gemm_tpu export",
        "llama.embedding_length": cfg.dim,
        "llama.block_count": cfg.n_layers,
        "llama.attention.head_count": cfg.n_heads,
        "llama.attention.head_count_kv": cfg.n_kv_heads,
        "llama.feed_forward_length": cfg.d_ff,
        "llama.context_length": cfg.max_seq,
        "llama.vocab_size": cfg.vocab,
        "llama.rope.freq_base": cfg.rope_base,
        "llama.attention.layer_norm_rms_epsilon": cfg.eps,
    }
    if cfg.window:
        metadata["llama.attention.sliding_window"] = cfg.window
    if cfg.head_dim_override:
        metadata["llama.attention.key_length"] = cfg.head_dim_override
        metadata["llama.attention.value_length"] = cfg.head_dim_override
    if cfg.rope_scale != 1.0:
        metadata["llama.rope.scaling.type"] = "linear"
        metadata["llama.rope.scaling.factor"] = 1.0 / cfg.rope_scale
    if "rope_inv_freq" in params:
        # llama.cpp's divisor table: theta = theta_base / factor
        inv = np.asarray(params["rope_inv_freq"], np.float32)
        base_inv = 1.0 / (cfg.rope_base ** (
            np.arange(0, cfg.head_dim, 2, dtype=np.float64) / cfg.head_dim))
        tensors["rope_freqs.weight"] = torch.from_numpy(
            (base_inv.astype(np.float32) / inv).astype(np.float32))
    if tokenizer_metadata:
        metadata.update(tokenizer_metadata)
    write_gguf(path, tensors, metadata)


__all__ = ["load_llama", "export_gguf", "config_from_metadata",
           "SUPPORTED_ARCHS"]
