"""The port's GGUF reader, writer and loader against the JAX package, on
the CPU, with ``tests/golden/tiny_llama_q4km.gguf`` (a Q4_K_M file written
by an independent generator: q4_K weights, q6_K ``attn_v`` in layer 1 and
``output``, f32 norms, a ``rope_freqs.weight`` divisor table).

Tolerances: the container, table and loaded weights are bit-equal (the
loader moves and re-lays bits; ``to_effective`` and ``scp`` are exact
products).  Logits, each side quantizing its own activations: ``max|delta|
<= 2e-2 * max|logits|`` and NMSE <= 2e-4, the bounds of the free run in
``tests/test_torch_model.py`` (XLA's and PyTorch's float32 rounding can
move a Q8_1 code across a .5 tie).  The pinned greedy transcript of
``tests/test_gguf_interop.py``: each pinned token is the port's argmax, or
within twice that logit tolerance of it (the near-tie rule of the server
tests), and where every step is the argmax the port's own transcript
equals it.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_gemm_tpu.formats import gguf_file as jgf
from quant_gemm_tpu.formats import kquants as jk
from quant_gemm_tpu.formats import numpy_ref as jnr
from quant_gemm_tpu.models import gguf_loader as jgl
from quant_gemm_tpu.models import llama as jl
from quant_gemm_tpu_torch.formats import gguf_file as tgf
from quant_gemm_tpu_torch.formats import kquants as tk
from quant_gemm_tpu_torch.formats import quant as tq
from quant_gemm_tpu_torch.formats.blocks import Q4_0Tensor, Q8_0Tensor
from quant_gemm_tpu_torch.kernels import layout
from quant_gemm_tpu_torch.models import convert
from quant_gemm_tpu_torch.models import gguf_loader as tgl
from quant_gemm_tpu_torch.models import llama as tl
from quant_gemm_tpu_torch.models import serve as ts

FIXTURE = pathlib.Path(__file__).parent / "golden" / "tiny_llama_q4km.gguf"
PROMPT_IDS = [0, 262, 312, 311, 292]  # tests/test_gguf_interop.py
GREEDY_CONT = [252, 44, 79, 306, 79, 306]
LOGIT_TOL = 2e-2
NMSE_TOL = 2e-4


@pytest.fixture(scope="module")
def both():
    """(JAX params, JAX cfg, port params, port cfg) of the fixture."""
    jp, jcfg = jgl.load_llama(str(FIXTURE))
    tp, tcfg = tgl.load_llama(FIXTURE, device="cpu")
    return jp, jcfg, tp, tcfg


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_container_matches_jax():
    j, t = jgf.GGUFFile(str(FIXTURE)), tgf.GGUFFile(FIXTURE)
    assert t.metadata == j.metadata
    assert t.tensors == j.tensors
    assert t._data_start == j._data_start
    for name in ("blk.1.attn_v.weight", "token_embd.weight",
                 "rope_freqs.weight"):
        np.testing.assert_array_equal(t.raw(name), j.raw(name))
    norm = t.load("output_norm.weight", "cpu")
    np.testing.assert_array_equal(norm.numpy(), j.load("output_norm.weight"))
    t.close()


def _write_all_types(rng):
    """One tensor of every ported type, built with the JAX encoders."""
    x = rng.normal(0, 0.05, (8, 512)).astype(np.float32)
    return {"f32": x, "f16": x.astype(np.float16),
            "q4_0": jnr.quantize_q4_0(x), "q8_0": jnr.quantize_q8_0(x),
            "q4_K": jk.quantize_q4_k(x), "q6_K": jk.quantize_q6_k(x),
            "q2_K": jk.quantize_q2_k(x), "q3_K": jk.quantize_q3_k(x)}


def _to_torch(t):
    if isinstance(t, np.ndarray):
        return torch.from_numpy(t)
    cls = {"Q4_0Tensor": Q4_0Tensor, "Q8_0Tensor": Q8_0Tensor}.get(
        type(t).__name__) or getattr(tk, type(t).__name__)
    return cls(*(torch.from_numpy(np.ascontiguousarray(np.asarray(f)))
                 for f in t))


def test_write_and_read_every_type_both_ways(tmp_path):
    """A file the port writes is byte-identical to the JAX writer's, and
    each package reads the other's tensors to the same bits."""
    src = _write_all_types(np.random.default_rng(1))
    md = {"general.architecture": "llama", "llama.block_count": 2,
          "general.name": "types", "tokenizer.ggml.scores": [0, 0.5, -1.0],
          "tokenizer.ggml.tokens": ["a", "b"]}
    pj, pt = tmp_path / "jax.gguf", tmp_path / "port.gguf"
    jgf.write_gguf(str(pj), src, md)
    tgf.write_gguf(pt, {k: _to_torch(v) for k, v in src.items()}, md)
    assert pt.read_bytes() == pj.read_bytes()
    tf, jf = tgf.GGUFFile(pj), jgf.GGUFFile(str(pt))
    assert tf.metadata == jf.metadata and tf.tensors == jf.tensors
    for name in src:
        got, want = tf.load(name, "cpu"), jf.load(name)
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got.numpy(), want)
            continue
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_unported_type_raises_with_its_name(tmp_path):
    """An iq4_nl tensor written by the JAX writer loads (slice 14) as the
    JAX reader loads it, a Q8_0Tensor of codebook values; a q8_1 tensor,
    the one ggml type of the table the port does not read, raises with
    its type's name."""
    x = np.random.default_rng(2).normal(0, 1, (4, 256)).astype(np.float32)
    path = tmp_path / "iq4nl.gguf"
    raw = jk.quantize_iq4_nl(x).tobytes()
    q81 = np.zeros(4 * 256 // 32 * 36, np.uint8).tobytes()
    jgf.write_gguf(str(path), {"w": jgf.RawTensor("iq4_nl", (4, 256), raw),
                               "a": jgf.RawTensor("q8_1", (4, 256), q81)})
    gf = tgf.GGUFFile(path)
    assert gf.tensors["w"]["qtype"] == "iq4_nl"
    got, want = gf.load("w", "cpu"), jgf.GGUFFile(str(path)).load("w")
    assert isinstance(got, Q8_0Tensor)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    with pytest.raises(NotImplementedError, match="q8_1"):
        gf.load("a", "cpu")


def test_config_from_metadata_matches_jax():
    md = tgf.GGUFFile(FIXTURE).metadata
    assert tuple(tgl.config_from_metadata(md)) == \
        tuple(jgl.config_from_metadata(md))
    scaled = {**md, "llama.rope.scaling.factor": 4.0}
    assert tgl.config_from_metadata(scaled).rope_scale == 0.25
    with pytest.raises(ValueError, match="yarn"):
        tgl.config_from_metadata({**scaled,
                                  "llama.rope.scaling.type": "yarn"})


def test_mixed_format_qkv_loads_unfused(both):
    """The JAX structure: layer 0 (all q4_K) fused, layer 1's q6_K attn_v
    keeps its wqkv a SplitLinear, the q6_K lm_head served per-16, the
    rope_freqs spectrum attached."""
    jp, _, tp, _ = both
    l0, l1 = tp["layers"]
    assert isinstance(jp["layers"][1]["wqkv"], jl.SplitLinear)
    assert isinstance(l1["wqkv"], tl.SplitLinear)
    assert [p.qtype for p in l1["wqkv"].parts] == ["q4_k", "q4_k", "q6_k"]
    assert not isinstance(l0["wqkv"], tl.SplitLinear)
    assert l0["wqkv"].qtype == "q4_k" and l0["wqkv"].m is not None
    assert isinstance(tp["lm_head"], layout.PreparedK16)
    assert tp["lm_head"].qtype == "q6_k" and tp["lm_head"].mp is None
    np.testing.assert_array_equal(tp["rope_inv_freq"].numpy(),
                                  np.asarray(jp["rope_inv_freq"]))


def _same(a, b):
    if isinstance(a, tl.SplitLinear):
        return all(_same(x, y) for x, y in zip(a.parts, b.parts))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return type(a) is type(b) and all(
        (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
        for x, y in zip(a, b))


def test_load_equals_qparams_from_jax(both):
    """The port's loader and the JAX loader's weights carried across by
    ``qparams_from_jax`` are the same bits."""
    jp, _, tp, _ = both
    tc = convert.qparams_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    for key in ("embed", "final_norm", "lm_head", "rope_inv_freq"):
        assert _same(tc[key], tp[key]), key
    for lc, lt in zip(tc["layers"], tp["layers"]):
        assert lc.keys() == lt.keys()
        for key in lc:
            assert _same(lc[key], lt[key]), key


def _assert_logits_close(got, want):
    got, want = _np(got), np.asarray(want)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    assert ((got - want) ** 2).sum() <= NMSE_TOL * (want ** 2).sum()


def test_forward_matches_jax(both):
    """Prefill of the pinned prompt, then three decode steps, on a batch of
    two (the second slot a different prompt)."""
    jp, jcfg, tp, tcfg = both
    toks = np.array([PROMPT_IDS, [0, 5, 6, 7, 8]], np.int32)
    lj, cj = jl.jit_forward(jp, jcfg, jnp.asarray(toks),
                            jl.KVCache.init(jcfg, 2))
    lt, ct = tl.forward(tp, tcfg, torch.from_numpy(toks),
                        tl.KVCache.init(tcfg, 2, device="cpu"))
    _assert_logits_close(lt, lj)
    for step in range(3):
        nt = np.array([[GREEDY_CONT[step]], [9 + step]], np.int32)
        lj, cj = jl.jit_forward(jp, jcfg, jnp.asarray(nt), cj)
        lt, ct = tl.forward(tp, tcfg, torch.from_numpy(nt), ct)
        _assert_logits_close(lt, lj)


def _along(tp, tcfg, prompt, toks):
    """Next-token logits at every step of ``toks`` teacher-forced after
    ``prompt``."""
    cache = tl.KVCache.init(tcfg, 1, device="cpu")
    steps = []
    for feed in [prompt] + [[t] for t in toks[:-1]]:
        logits, cache = tl.forward(tp, tcfg, torch.tensor([feed]), cache)
        steps.append(logits[0, -1])
    return torch.stack(steps)


def test_server_reproduces_the_pinned_transcript(both):
    """The port's Server (its rope tables from the file's rope_freqs) on
    the fixture: the pinned transcript under the near-tie rule."""
    _, _, tp, tcfg = both
    srv = ts.Server(tp, tcfg, n_slots=2, device="cpu")
    rid = srv.submit(PROMPT_IDS, max_new=len(GREEDY_CONT))
    srv.submit([0, 5, 6, 7, 8, 9, 10], max_new=4)
    own = srv.run_until_done()[rid]
    along = _along(tp, tcfg, PROMPT_IDS, GREEDY_CONT)
    picked = along[torch.arange(len(GREEDY_CONT)), torch.tensor(GREEDY_CONT)]
    slack = along.amax(-1) - picked
    assert (slack <= 2 * LOGIT_TOL * along.abs().amax(-1)).all()
    if not slack.any():
        assert own == GREEDY_CONT


def test_rope_tables_follow_the_file(both):
    """rope_for reads params["rope_inv_freq"] as the JAX rope_for does;
    without it the tables differ."""
    jp, jcfg, tp, tcfg = both
    cos_t, sin_t = tl.rope_for(tcfg, tp, "cpu")
    cos_j, sin_j = jl.rope_for(jcfg, jp)
    np.testing.assert_array_equal(cos_t.numpy(), np.asarray(cos_j))
    np.testing.assert_array_equal(sin_t.numpy(), np.asarray(sin_j))
    assert not torch.equal(tl.rope_for(tcfg, None, "cpu")[1], sin_t)


def test_tied_embeddings_and_unported_pieces(tmp_path):
    """A file without output.weight serves lm_head from token_embd, as
    JAX does; QKV biases (qwen2, slice 14) load into ``bqkv`` as JAX loads
    them; q8_0 weights are served."""
    gf = jgf.GGUFFile(str(FIXTURE))
    tensors = {n: gf.load(n) for n in gf.tensors if n != "output.weight"}
    path = tmp_path / "tied.gguf"
    jgf.write_gguf(str(path), tensors, dict(gf.metadata))
    jp, _ = jgl.load_llama(str(path))
    tp, _ = tgl.load_llama(path, device="cpu")
    want = convert.qparams_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")["lm_head"]
    assert tp["lm_head"].qtype == "q4_k" and _same(tp["lm_head"], want)
    bias = dict(tensors)
    for t in "qkv":
        n = 256 if t == "q" else 128
        bias[f"blk.0.attn_{t}.bias"] = np.zeros(n, np.float32)
    bias["blk.1.attn_k.bias"] = np.ones(128, np.float32)  # layer 1: k only
    jgf.write_gguf(str(path), bias, dict(gf.metadata))
    jb, _ = jgl.load_llama(str(path))
    tb, _ = tgl.load_llama(path, device="cpu")
    np.testing.assert_array_equal(tb["layers"][0]["bqkv"].numpy(),
                                  np.asarray(jb["layers"][0]["bqkv"]))
    assert tb["layers"][0]["bqkv"].shape == (512,)
    # a layer without all three biases has none, in both loaders
    assert "bqkv" not in tb["layers"][1] and "bqkv" not in jb["layers"][1]
    # a q8_0 weight is served (slice 7): K1/K4's q8_0 form
    x8 = torch.from_numpy(np.random.default_rng(8).normal(
        0, 0.1, (4, 64)).astype(np.float32))
    w8 = tgl._prep(tq.quantize_q8_0(x8))
    assert w8.qtype == "q8_0"
    torch.testing.assert_close(layout.dequantize(w8),
                               tq.dequantize(tq.quantize_q8_0(x8)),
                               rtol=0, atol=0)
