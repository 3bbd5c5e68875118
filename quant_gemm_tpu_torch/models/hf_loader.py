"""Load HuggingFace Llama checkpoints (``config.json`` + ``*.safetensors``).

Counterpart of ``quant_gemm_tpu/models/hf_loader.py``: an HF
``LlamaForCausalLM`` (or qwen2) directory quantizes straight into the
kernel layout on the device.  The safetensors parser and writer are
self-contained copies of the JAX package's (an 8-byte little-endian
header length, a JSON header of name -> {dtype, shape, data_offsets},
then the raw buffer); the writer also takes bf16 torch tensors.  HF and
this runtime both use the split (rotate-half) RoPE, so q/k map by name
with no permutation.
"""

from __future__ import annotations

import json
import pathlib
import struct

import numpy as np
import torch

from ..ops.rope import llama3_inv_freq
from ..utils import resolve_device
from . import llama

_DTYPES = {"F32": np.float32, "F16": np.float16, "I32": np.int32,
           "I8": np.int8, "U8": np.uint8}


def _bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    return (raw.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


class SafetensorsFile:
    """A parsed .safetensors file: ``names`` and per-tensor loads (numpy;
    BF16 widened to float32 exactly)."""

    def __init__(self, path):
        self.path = path
        with open(path, "rb") as f:
            (hlen,) = struct.unpack("<Q", f.read(8))
            self.header = json.loads(f.read(hlen).decode("utf-8"))
            self._data_start = 8 + hlen
        self.header.pop("__metadata__", None)

    @property
    def names(self):
        return sorted(self.header)

    def load(self, name: str) -> np.ndarray:
        info = self.header[name]
        dt, shape = info["dtype"], info["shape"]
        o0, o1 = info["data_offsets"]
        with open(self.path, "rb") as f:
            f.seek(self._data_start + o0)
            raw = np.frombuffer(f.read(o1 - o0), np.uint8)
        if dt == "BF16":
            return _bf16_to_f32(raw.view(np.uint16)).reshape(shape)
        np_dt = _DTYPES.get(dt)
        if np_dt is None:
            raise ValueError(f"unsupported safetensors dtype {dt}")
        return raw.view(np_dt).reshape(shape)


def _blob(arr):
    """(safetensors dtype, shape, bytes) of a float32 / float16 array or
    a float32 / float16 / bf16 tensor."""
    if isinstance(arr, torch.Tensor):
        dt = {torch.float32: "F32", torch.float16: "F16",
              torch.bfloat16: "BF16"}[arr.dtype]
        raw = arr.detach().contiguous().cpu()
        if dt == "BF16":
            raw = raw.view(torch.int16)
        return dt, list(arr.shape), raw.numpy().tobytes()
    arr = np.asarray(arr)
    dt = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16"}[arr.dtype]
    return dt, list(arr.shape), arr.tobytes()


def write_safetensors(path, tensors: dict, metadata=None) -> None:
    """Minimal writer: {name: float32 / float16 array, or a float32 /
    float16 / bf16 tensor}."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    blobs = []
    off = 0
    for name, arr in tensors.items():
        dt, shape, b = _blob(arr)
        header[name] = {"dtype": dt, "shape": shape,
                        "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    hjson = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)


# HF LlamaForCausalLM tensor names -> the runtime's
_HF_BLK = {
    "attn_norm": "model.layers.{i}.input_layernorm.weight",
    "wq": "model.layers.{i}.self_attn.q_proj.weight",
    "wk": "model.layers.{i}.self_attn.k_proj.weight",
    "wv": "model.layers.{i}.self_attn.v_proj.weight",
    "wo": "model.layers.{i}.self_attn.o_proj.weight",
    "mlp_norm": "model.layers.{i}.post_attention_layernorm.weight",
    "w_gate": "model.layers.{i}.mlp.gate_proj.weight",
    "w_up": "model.layers.{i}.mlp.up_proj.weight",
    "w_down": "model.layers.{i}.mlp.down_proj.weight",
}


def _rope_type(cfg_json: dict):
    rs = cfg_json.get("rope_scaling") or {}
    return rs, (rs.get("rope_type", rs.get("type", "linear")) if rs
                else None)


def config_from_hf(cfg_json: dict) -> llama.LlamaConfig:
    """HF config.json -> :class:`~.llama.LlamaConfig`.  ``rope_scaling``
    "linear" maps to ``rope_scale``; "llama3" (frequency-dependent,
    Llama-3.1 and later) is the loader's: it attaches per-dimension
    inverse frequencies to the parameters; other types (yarn, ...)
    raise."""
    rs, stype = _rope_type(cfg_json)
    rope_scale = 1.0
    if stype == "linear":
        rope_scale = 1.0 / float(rs.get("factor", 1.0))
    elif stype not in (None, "llama3"):
        raise ValueError(f"unsupported rope scaling {rs!r}")
    return llama.LlamaConfig(
        vocab=int(cfg_json["vocab_size"]),
        dim=int(cfg_json["hidden_size"]),
        n_layers=int(cfg_json["num_hidden_layers"]),
        n_heads=int(cfg_json["num_attention_heads"]),
        n_kv_heads=int(cfg_json.get("num_key_value_heads",
                                    cfg_json["num_attention_heads"])),
        d_ff=int(cfg_json["intermediate_size"]),
        max_seq=int(cfg_json.get("max_position_embeddings", 2048)),
        rope_base=float(cfg_json.get("rope_theta", 10000.0)),
        eps=float(cfg_json.get("rms_norm_eps", 1e-5)),
        window=int(cfg_json.get("sliding_window") or 0),
        rope_scale=rope_scale,
        head_dim_override=int(cfg_json.get("head_dim") or 0),
    )


def load_hf_llama(model_dir, qtype: str = "q4_0", device="cuda"):
    """An HF Llama directory -> (parameters for ``llama.forward`` on
    ``device``, config).  Reads config.json and every ``*.safetensors``
    shard; the linears quantize to ``qtype`` through
    :func:`~.llama.quantize_params` on the device (QKV and gate/up fused);
    a checkpoint without ``lm_head.weight`` ties it to the embedding; the
    qwen2 family's q/k/v biases are carried; llama3 RoPE scaling attaches
    ``rope_inv_freq`` (:func:`~..ops.rope.llama3_inv_freq`).  The config
    keeps ``max_position_embeddings`` as ``max_seq``: a caller serving a
    long-context model passes a smaller one (``cfg._replace(max_seq=)``),
    the KV cache's length."""
    dev = resolve_device(device)
    model_dir = pathlib.Path(model_dir)
    cfg_json = json.loads((model_dir / "config.json").read_text())
    cfg = config_from_hf(cfg_json)
    shards = sorted(model_dir.glob("*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"no .safetensors under {model_dir}")
    where: dict[str, SafetensorsFile] = {}
    for sh in shards:
        f = SafetensorsFile(sh)
        for n in f.names:
            where[n] = f

    def get(name):
        return np.asarray(where[name].load(name), np.float32)

    def layer(i):
        lyr = {k: get(v.format(i=i)) for k, v in _HF_BLK.items()}
        bn = f"model.layers.{i}.self_attn.{{}}_proj.bias"
        if bn.format("q") in where:  # the qwen2 family's QKV biases
            for t in ("q", "k", "v"):
                lyr[f"b{t}"] = get(bn.format(t))
        return lyr

    embed = get("model.embed_tokens.weight")
    params = {
        "embed": embed,
        "final_norm": get("model.norm.weight"),
        # tied embeddings: the head is the embedding
        "lm_head": (get("lm_head.weight") if "lm_head.weight" in where
                    else embed),
        "layers": [layer(i) for i in range(cfg.n_layers)],
    }
    qparams = llama.quantize_params(params, qtype, device=dev)
    rs, stype = _rope_type(cfg_json)
    if stype == "llama3":
        qparams["rope_inv_freq"] = torch.as_tensor(llama3_inv_freq(
            cfg.head_dim, cfg.rope_base, float(rs["factor"]),
            float(rs["low_freq_factor"]), float(rs["high_freq_factor"]),
            int(rs["original_max_position_embeddings"])), device=dev)
    return qparams, cfg


__all__ = ["SafetensorsFile", "write_safetensors", "config_from_hf",
           "load_hf_llama"]
