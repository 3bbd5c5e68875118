"""The port's HuggingFace safetensors loader against the JAX package's, on
the CPU, with small checkpoints written from a seed (dim 128, 2 layers).

Exact throughout: the port's parser reads what JAX's writer wrote and JAX's
parser what the port's writer wrote (bf16 included), bit for bit;
``config_from_hf`` gives JAX's config (linear and llama3 ``rope_scaling``,
other types refused); ``load_hf_llama``'s codes, scales, norms, biases and
RoPE frequencies equal JAX's loaded model carried across
(``convert.qparams_from_jax``) and the port's ``quantize_params`` of the
same floats, for an untied llama3 checkpoint, a tied one, and a qwen2 one
with q/k/v biases.
"""

import json

import jax
import numpy as np
import pytest
import torch

from quant_gemm_tpu.models import hf_loader as jhf
from quant_gemm_tpu.models import llama as jl
from quant_gemm_tpu_torch.models import convert
from quant_gemm_tpu_torch.models import hf_loader as thf
from quant_gemm_tpu_torch.models import llama as tl

CFG = jl.LlamaConfig(vocab=64, dim=128, n_layers=2, n_heads=2,
                     n_kv_heads=2, d_ff=256, max_seq=32)
HF_CONFIG = {"vocab_size": 64, "hidden_size": 128, "num_hidden_layers": 2,
             "num_attention_heads": 2, "num_key_value_heads": 2,
             "intermediate_size": 256, "max_position_embeddings": 32,
             "rope_theta": 500000.0, "rms_norm_eps": 1e-5}
LLAMA3 = {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 8}
_NAMES = {"attn_norm": "input_layernorm.weight",
          "wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
          "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
          "mlp_norm": "post_attention_layernorm.weight",
          "w_gate": "mlp.gate_proj.weight", "w_up": "mlp.up_proj.weight",
          "w_down": "mlp.down_proj.weight"}


def test_safetensors_cross_read(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 8)).astype(np.float32)
    b = rng.standard_normal((3,)).astype(np.float16)
    jhf.write_safetensors(tmp_path / "j.safetensors", {"a": a, "b": b})
    f = thf.SafetensorsFile(tmp_path / "j.safetensors")
    assert f.names == ["a", "b"]
    np.testing.assert_array_equal(f.load("a"), a)
    np.testing.assert_array_equal(f.load("b"), b)
    c = torch.from_numpy(a).to(torch.bfloat16)
    thf.write_safetensors(tmp_path / "t.safetensors", {"c": c, "a": a},
                          {"format": "pt"})
    g = jhf.SafetensorsFile(tmp_path / "t.safetensors")
    assert g.header["c"]["dtype"] == "BF16"
    np.testing.assert_array_equal(g.load("c"), c.float().numpy())
    np.testing.assert_array_equal(g.load("a"), a)


@pytest.mark.parametrize("scaling", [None, {"type": "linear", "factor": 4.0},
                                     LLAMA3])
def test_config_from_hf_matches_jax(scaling):
    cj = dict(HF_CONFIG, rope_scaling=scaling)
    got, want = thf.config_from_hf(cj), jhf.config_from_hf(cj)
    assert got._asdict() == want._asdict()
    with pytest.raises(ValueError, match="rope scaling"):
        thf.config_from_hf(dict(HF_CONFIG, rope_scaling={"type": "yarn"}))


def _checkpoint(path, *, tied, bias, scaling, shards=2):
    """An HF directory from init_params (seed 50), in ``shards`` files."""
    params = jl.init_params(CFG, seed=50)
    rng = np.random.default_rng(51)
    if tied:
        params["lm_head"] = params["embed"]
    t = {"model.embed_tokens.weight": params["embed"],
         "model.norm.weight": params["final_norm"]}
    if not tied:
        t["lm_head.weight"] = params["lm_head"]
    for i, lyr in enumerate(params["layers"]):
        for k, v in _NAMES.items():
            t[f"model.layers.{i}.{v}"] = lyr[k]
        for p in ("q", "k", "v") if bias else ():
            n = (CFG.n_heads if p == "q" else CFG.n_kv_heads) * CFG.head_dim
            lyr["b" + p] = rng.standard_normal(n).astype(np.float32)
            t[f"model.layers.{i}.self_attn.{p}_proj.bias"] = lyr["b" + p]
    names = sorted(t)
    path.mkdir()
    for s in range(shards):
        jhf.write_safetensors(path / f"model-{s:05d}.safetensors",
                              {n: t[n] for n in names[s::shards]})
    (path / "config.json").write_text(json.dumps(dict(
        HF_CONFIG, rope_scaling=scaling, tie_word_embeddings=tied)))
    return params


def _same(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
        return
    assert (a.qtype, a.n, a.k) == (b.qtype, b.n, b.k)
    for x, y in zip(a[3:], b[3:]):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("tied, bias, scaling", [
    (False, False, LLAMA3), (True, False, LLAMA3),
    (True, True, None)], ids=["llama3", "llama3-tied", "qwen2-tied"])
def test_load_hf_llama_matches_jax(tmp_path, tied, bias, scaling):
    params = _checkpoint(tmp_path / "m", tied=tied, bias=bias,
                         scaling=scaling)
    qt, cfg_t = thf.load_hf_llama(tmp_path / "m", "q4_0", device="cpu")
    qj, cfg_j = jhf.load_hf_llama(tmp_path / "m", "q4_0")
    assert cfg_t._asdict() == cfg_j._asdict()
    qc = convert.qparams_from_jax(jax.tree_util.tree_map(np.asarray, qj),
                                  device="cpu")
    if scaling is None:
        assert "rope_inv_freq" not in qt and "rope_inv_freq" not in qc
    else:
        assert torch.equal(qt["rope_inv_freq"], qc["rope_inv_freq"])
        cos, _ = tl.rope_for(cfg_t, qt, device="cpu")
        assert not torch.equal(cos, tl.rope_for(cfg_t, device="cpu")[0])
    native = tl.quantize_params(params, "q4_0", device="cpu")
    for other in (qc, native):
        _same(qt["embed"], other["embed"])
        _same(qt["lm_head"], other["lm_head"])
        for a, b in zip(qt["layers"], other["layers"]):
            assert set(a) == set(b)
            assert ("bqkv" in a) == bias
            for k in b:
                _same(a[k], b[k])
