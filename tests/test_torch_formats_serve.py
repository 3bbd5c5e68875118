"""Serving every per-32 format and q5_K: the port against the JAX package,
on the CPU, at ``tests/test_torch_model.py``'s small Llama (dim 512, two
layers, GQA 8 over 2) and K <= 1024.

Tolerances:

* GGUF bytes and containers (q4_1, q5_0, q5_1, q8_0, q5_K), the q5_k
  layout, ``quantize_params`` in every format and the loaded weights of
  a Q5_K_M-mix file: bit-equal (exact integer / IEEE-f16 results and
  exact f32 products);
* K2 ``norm_qkv`` (plain version) against JAX's ``norm_qkv`` in interpret
  mode: ``2e-3 * max|C|``, K2's rule (a Q8_1 code can move across a .5
  tie between XLA's and PyTorch's float32 normalisation);
* K6 (plain) against JAX's ``gemm_exact_fused`` and K1 on q5_k against
  ``ref/gemm.py::gemm_wxa8``: ``1e-5 * max|C|`` (float32 summation
  order); K6 also bit-equal to quantize + K1;
* K4 ``fused_quant`` (plain, float32 operands) against JAX's
  ``pallas_fused_quant`` in its float32 mode: NMSE <= 1e-10 (the fake
  quantization is bit-equal; only the float32 summation order differs);
  the ladder rung against the W4A8 golden: NMSE < 1e-4, as
  ``tests/test_kernels.py::test_fused_quant_matches_separate_quant``;
* logits, each side quantizing its own activations: ``max|delta| <= 2e-2
  * max|logits|`` and NMSE <= 2e-4, the free-run bounds of
  ``tests/test_torch_model.py``;
* greedy Server transcripts: JAX's token is the port's argmax at every
  step, or within twice the logit tolerance of it (the near-tie rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_gemm_tpu.formats import blocks as jblocks
from quant_gemm_tpu.formats import gguf_file as jgf
from quant_gemm_tpu.formats import kquants as jk
from quant_gemm_tpu.formats import numpy_ref as jnr
from quant_gemm_tpu.kernels import gemm_megalayer as jmega
from quant_gemm_tpu.kernels import registry as jreg
from quant_gemm_tpu.kernels.gemm_exact import (gemm_exact_fused as
                                               j_gemm_exact_fused)
from quant_gemm_tpu.kernels.gemm_pallas import prepare as j_prepare
from quant_gemm_tpu.models import gguf_loader as jgl
from quant_gemm_tpu.models import llama as jl
from quant_gemm_tpu.models import serve as js
from quant_gemm_tpu.ref import gemm as jref
from quant_gemm_tpu_torch.formats import gguf_file as tgf
from quant_gemm_tpu_torch.formats import kquants as tk
from quant_gemm_tpu_torch.formats import quant as tq
from quant_gemm_tpu_torch.formats.blocks import WEIGHT_TENSOR_TYPES
from quant_gemm_tpu_torch.kernels import gemm_megalayer, layout, registry
from quant_gemm_tpu_torch.kernels.gemm_dequant import (fake_quant_q8,
                                                       gemm_dequant)
from quant_gemm_tpu_torch.kernels.gemm_exact import (gemm_exact,
                                                     gemm_exact_fused,
                                                     gemm_exact_plain)
from quant_gemm_tpu_torch.kernels.gemm_megalayer import norm_qkv
from quant_gemm_tpu_torch.models import convert
from quant_gemm_tpu_torch.models import gguf_loader as tgl
from quant_gemm_tpu_torch.models import llama as tl
from quant_gemm_tpu_torch.models import serve as ts

JCFG = jl.LlamaConfig(vocab=256, dim=512, n_layers=2, n_heads=8,
                      n_kv_heads=2, d_ff=1024, max_seq=128)
TCFG = tl.LlamaConfig(**JCFG._asdict())
LOGIT_TOL = 2e-2
NMSE_TOL = 2e-4
EPS = 1e-5
PER32 = ["q4_1", "q5_0", "q5_1", "q8_0"]
SERVED = PER32 + ["q5_k"]  # the formats this file serves end to end
K2_NEW = ["q4_1", "q4_k", "q5_0", "q5_1", "q5_k"]
# llama.cpp's Q5_K_M mix on two layers (llama_tensor_get_type, no
# importance matrix): attn_v and ffn_down q6_K in the use_more_bits
# layers (i < n/8, i >= 7n/8, (i - n/8) % 3 == 2: layer 1 here), output
# q6_K, every other linear and the embedding q5_K
MORE_BITS = [i for i in range(JCFG.n_layers) if i < JCFG.n_layers // 8
             or i >= 7 * JCFG.n_layers // 8
             or (i - JCFG.n_layers // 8) % 3 == 2]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_container(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))


def _torch(container, cls):
    return cls(*(torch.from_numpy(np.ascontiguousarray(np.asarray(f)))
                 for f in container))


def _assert_logits_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    assert ((got - want) ** 2).sum() <= NMSE_TOL * (want ** 2).sum()


def _same_weight(a, b):
    """Two port weight slots hold the same bits."""
    if isinstance(a, tl.SplitLinear):
        assert isinstance(b, tl.SplitLinear)
        for pa, pb in zip(a.parts, b.parts):
            _same_weight(pa, pb)
        return
    assert type(a) is type(b) and a.qtype == b.qtype
    assert (a.n, a.k) == (b.n, b.k)
    for x, y in zip(a[3:], b[3:]):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y)


def _same_params(a, b):
    for key in ("embed", "final_norm"):
        assert torch.equal(a[key], b[key])
    _same_weight(a["lm_head"], b["lm_head"])
    for la, lb in zip(a["layers"], b["layers"]):
        assert la.keys() == lb.keys()
        for name in la:
            if name.endswith("norm"):
                assert torch.equal(la[name], lb[name])
            else:
                _same_weight(la[name], lb[name])


# -- (a) GGUF bytes ---------------------------------------------------------


def _q5_k_m_tensors(seed=0):
    """A 2-layer Q5_K_M-mix checkpoint at JCFG's widths (JAX containers)
    and its metadata."""
    rng = np.random.default_rng(seed)

    def lin(n, k, qtype="q5_K"):
        w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
        return jk.quantize_q6_k(w) if qtype == "q6_K" else \
            jk.quantize_q5_k(w)

    c = JCFG
    hd = c.dim // c.n_heads
    emb = (rng.standard_normal((c.vocab, c.dim)) * 0.02).astype(np.float32)
    ones = np.ones(c.dim, np.float32)
    tensors = {"token_embd.weight": jk.quantize_q5_k(emb),
               "output_norm.weight": ones}
    for i in range(c.n_layers):
        big = "q6_K" if i in MORE_BITS else "q5_K"
        b = f"blk.{i}."
        tensors.update({
            b + "attn_norm.weight": ones,
            b + "attn_q.weight": lin(c.n_heads * hd, c.dim),
            b + "attn_k.weight": lin(c.n_kv_heads * hd, c.dim),
            b + "attn_v.weight": lin(c.n_kv_heads * hd, c.dim, big),
            b + "attn_output.weight": lin(c.dim, c.n_heads * hd),
            b + "ffn_norm.weight": ones,
            b + "ffn_gate.weight": lin(c.d_ff, c.dim),
            b + "ffn_up.weight": lin(c.d_ff, c.dim),
            b + "ffn_down.weight": lin(c.dim, c.d_ff, big),
        })
    tensors["output.weight"] = lin(c.vocab, c.dim, "q6_K")
    md = {"general.architecture": "llama",
          "general.file_type": 17,  # LLAMA_FTYPE_MOSTLY_Q5_K_M
          "llama.vocab_size": c.vocab, "llama.embedding_length": c.dim,
          "llama.block_count": c.n_layers,
          "llama.feed_forward_length": c.d_ff,
          "llama.attention.head_count": c.n_heads,
          "llama.attention.head_count_kv": c.n_kv_heads,
          "llama.context_length": c.max_seq,
          "llama.rope.freq_base": c.rope_base,
          "llama.attention.layer_norm_rms_epsilon": c.eps}
    return tensors, md


@pytest.fixture(scope="module")
def q5_k_m_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("q5km") / "tiny-q5_k_m.gguf"
    tensors, md = _q5_k_m_tensors()
    jgf.write_gguf(str(path), tensors, md)
    return path


def test_gguf_round_trip_per32_and_q5_k(tmp_path):
    """JAX's writer -> the port's reader gives JAX's containers; the
    port's writer -> the same bytes, which JAX's reader reads back."""
    x = np.random.default_rng(1).normal(0, 1, (8, 512)).astype(np.float32)
    x[0, :32] = 0.0
    src = {q: jnr.QUANTIZE[q](x) for q in PER32}
    src["q5_K"] = jk.quantize_q5_k(x, search=False)
    pj, pt = tmp_path / "j.gguf", tmp_path / "t.gguf"
    jgf.write_gguf(str(pj), src, {"general.name": "per-32 and q5_K"})
    tf = tgf.GGUFFile(pj)
    got = {n: tf.load(n, "cpu") for n in src}
    for name, want in src.items():
        assert tf.tensors[name]["qtype"] == (name if name in PER32
                                             else "q5_K")
        _same_container(got[name], want)
    assert isinstance(got["q5_1"], WEIGHT_TENSOR_TYPES["q5_1"])
    assert isinstance(got["q5_K"], tk.Q5_KTensor)
    tgf.write_gguf(pt, got, dict(tf.metadata))
    assert pt.read_bytes() == pj.read_bytes()
    back = jgf.GGUFFile(str(pt))
    for name, want in src.items():
        _same_container(back.load(name), want)


def test_gguf_q5_k_m_file_round_trip(q5_k_m_file, tmp_path):
    """Every tensor of the Q5_K_M-mix file reads bit-equal to JAX's
    reader, and the port writes the file back byte for byte."""
    tf, jf = tgf.GGUFFile(q5_k_m_file), jgf.GGUFFile(str(q5_k_m_file))
    assert tf.metadata == jf.metadata and tf.tensors == jf.tensors
    kinds = {info["qtype"] for info in tf.tensors.values()}
    assert kinds == {"f32", "q5_K", "q6_K"}
    loaded = {n: tf.load(n, "cpu") for n in tf.tensors}
    for name, t in loaded.items():
        want = jf.load(name)
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(t.numpy(), want)
        else:
            _same_container(t, want)
    out = tmp_path / "back.gguf"
    tgf.write_gguf(out, loaded, dict(tf.metadata))
    assert out.read_bytes() == q5_k_m_file.read_bytes()


# -- (b) the q5_k layout ----------------------------------------------------


def test_prepare_q5_k_matches_jax_layout():
    """``layout.prepare`` of a q5_K tensor's effective form equals the
    port's reading of JAX's prepared q5_k weight (K = 768: JAX pads K)."""
    w = np.random.default_rng(2).normal(0, 0.05, (96, 768)).astype(
        np.float32)
    jq5 = jk.quantize_q5_k(w)
    jw = jax.tree_util.tree_map(np.asarray,
                                j_prepare(jk.to_effective_q5_k(jq5)))
    p = convert.planar_from_jax(jw)
    assert isinstance(p, tk.EffectiveQ51)
    want = layout.prepare(_torch(p, tk.EffectiveQ51))
    got = layout.prepare(tk.to_effective_q5_k(_torch(jq5, tk.Q5_KTensor)))
    assert got.qtype == "q5_k" and got.d.dtype == torch.float32
    _same_weight(got, want)
    np.testing.assert_array_equal(layout.dequantize(got).numpy(),
                                  jk.dequantize_q5_k(jq5))


# -- (c)-(e) the kernels' plain versions against the JAX kernels -----------


def _weights(qtype, n, k, seed):
    """(JAX prepared weight, port weight, JAX container) of one random
    [n, k] weight in ``qtype`` (q4_k / q5_k in their effective form)."""
    w = np.random.default_rng(seed).normal(0, 0.05, (n, k)).astype(
        np.float32)
    if qtype in ("q4_k", "q5_k"):
        enc, eff = {"q4_k": (jk.quantize_q4_k, jk.to_effective),
                    "q5_k": (jk.quantize_q5_k, jk.to_effective_q5_k)}[qtype]
        jc = eff(enc(w))
        cls = {"q4_k": tk.EffectiveQ41, "q5_k": tk.EffectiveQ51}[qtype]
    else:
        jc = jnr.QUANTIZE[qtype](w)
        cls = WEIGHT_TENSOR_TYPES[qtype]
    return j_prepare(jc), layout.prepare(_torch(jc, cls)), jc


@pytest.mark.parametrize("qtype", K2_NEW)
def test_norm_qkv_new_forms_match_jax(qtype):
    """The plain K2 in each new form against JAX's ``norm_qkv`` in
    interpret mode (K = 512, the smallest it takes)."""
    k, m = 512, 5
    jw, pw, _ = _weights(qtype, 256, k, 12)
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    nw = rng.normal(1, 0.1, k).astype(np.float32)
    got = norm_qkv(pw, torch.from_numpy(x), torch.from_numpy(nw), EPS)
    want = np.asarray(jmega.norm_qkv(jw, jnp.asarray(x), jnp.asarray(nw),
                                     EPS))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-3 * np.abs(want).max())


@pytest.mark.parametrize("qtype", ["q4_1", "q8_0"])
def test_gemm_exact_fused_new_forms_match_jax(qtype):
    """The plain K6 in q4_1 and q8_0 (JAX's ``_kernel_w8_fused``) against
    JAX's ``gemm_exact_fused``, degenerate blocks included; bit-equal to
    quantize + K1."""
    k, m = 1024, 8
    jw, pw, _ = _weights(qtype, 384, k, 14)
    x = np.random.default_rng(15).standard_normal((m, k)).astype(np.float32)
    x[0, :32], x[-1, 32:64] = 0.0, 7e8
    got = gemm_exact_fused(pw, torch.from_numpy(x))
    want = np.asarray(j_gemm_exact_fused(jw, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    torch.testing.assert_close(
        got, gemm_exact(pw, tq.quantize_q8_1(torch.from_numpy(x))),
        rtol=0, atol=0)


def test_gemm_exact_q5_k_matches_golden():
    """The plain K1 on q5_k against ``gemm_wxa8`` on the effective form
    (the float64-summed golden)."""
    _, pw, jc = _weights("q5_k", 384, 1024, 16)
    x = np.random.default_rng(17).standard_normal((8, 1024)).astype(
        np.float32)
    a8 = jnr.quantize_q8_1(x)
    got = gemm_exact_plain(pw, tq.quantize_q8_1(torch.from_numpy(x)))
    # the golden reads the effective form as q5_1 blocks with f32 planes
    want = jref.gemm_wxa8(jblocks.Q5_1Tensor(jc.packed, jc.qh, jc.d, jc.m),
                          a8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _nmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return ((got - want) ** 2).sum() / (want ** 2).sum()


@pytest.mark.parametrize("qtype", ["q4_0", "q5_1", "q8_0", "q5_k"])
def test_gemm_dequant_fused_quant_matches_jax(qtype):
    """The plain K4 ``fused_quant`` against JAX's ``pallas_fused_quant``,
    both with float32 operands; the fake quantization itself equals JAX's
    ``_fake_quant_q8`` bit for bit."""
    from quant_gemm_tpu.kernels.gemm_pallas import _fake_quant_q8

    k, m = 1024, 16
    jw, pw, _ = _weights(qtype, 256, k, 18)
    x = np.random.default_rng(19).standard_normal((m, k)).astype(np.float32)
    x[0, :32], x[3, 64:96] = 0.0, 7e8
    np.testing.assert_array_equal(
        fake_quant_q8(torch.from_numpy(x)).numpy(),
        np.asarray(_fake_quant_q8(jnp.asarray(x))))
    got = gemm_dequant(pw, torch.from_numpy(x), fused_quant=True,
                       a_dtype=torch.float32)
    want = jreg.KERNELS["pallas_fused_quant"](jw, jnp.asarray(x),
                                              mxu_dtype=jnp.float32)
    assert _nmse(got.numpy(), want) <= 1e-10


def test_pallas_fused_quant_rung_vs_golden():
    """The ladder rung, as ``tests/test_kernels.py::
    test_fused_quant_matches_separate_quant`` holds JAX's: within NMSE
    1e-4 of the W4A8 golden on the Q8_1 activation."""
    rng = np.random.default_rng(20)
    a = rng.standard_normal((8, 1024)).astype(np.float32)
    w = rng.normal(0, 0.05, (256, 1024)).astype(np.float32)
    w_q = jnr.quantize_q4_0(w)
    gold = jref.gemm_w4a8(w_q, jnr.quantize_q8_1(a))
    for a_dtype in (torch.float32, torch.bfloat16):
        out = registry.LADDER["pallas_fused_quant"](
            tq.quantize_q4_0(torch.from_numpy(w)), torch.from_numpy(a),
            a_dtype=a_dtype)
        assert _nmse(out.numpy(), gold) < 1e-4


# -- (f)-(j) the model, the loader and the Server --------------------------


@pytest.fixture(scope="module")
def params():
    return jl.init_params(JCFG, seed=3)


@pytest.fixture(scope="module")
def jax_q(params):
    """JAX's ``quantize_params`` per qtype, made once."""
    cache = {}

    def get(qtype):
        if qtype not in cache:
            cache[qtype] = jl.quantize_params(params, qtype)
        return cache[qtype]
    return get


def _from_jax(qj):
    return convert.qparams_from_jax(jax.tree_util.tree_map(np.asarray, qj),
                                    device="cpu")


@pytest.mark.parametrize("qtype", tl.QPARAM_QTYPES)
def test_quantize_params_bit_equal_to_jax(params, jax_q, qtype):
    """``quantize_params(qtype)`` holds the bits of JAX's, read through
    ``qparams_from_jax``, in every format JAX's takes."""
    _same_params(tl.quantize_params(params, qtype, device="cpu"),
                 _from_jax(jax_q(qtype)))


@pytest.mark.parametrize("qtype", SERVED)
def test_forward_matches_jax(jax_q, qtype):
    """A 16-token prefill of two slots (K4 on every linear) through JAX's
    weights carried across.  Decode is held to JAX by the Server test
    (q8_0), the Q5_K_M file's (q5_k) and the plain K2 against JAX's in
    every new form; a JAX decode step compiles its interpret-mode kernels
    for some 10 s a format."""
    qj = jax_q(qtype)
    qt = _from_jax(qj)
    tokens = np.random.default_rng(21).integers(0, 256, (2, 16)).astype(
        np.int32)
    lj, _ = jl.jit_forward(qj, JCFG, jnp.asarray(tokens),
                           jl.KVCache.init(JCFG, 2))
    lt, _ = tl.forward(qt, TCFG, torch.from_numpy(tokens),
                       tl.KVCache.init(TCFG, 2, device="cpu"))
    _assert_logits_close(lt, lj)


def _logits_along(qt, prompt, toks, chunk=48):
    """The port's next-token logits at every step of the greedy
    transcript ``toks`` of ``prompt``, one request alone."""
    cache = tl.KVCache.init(TCFG, 1, device="cpu")
    for off in range(0, len(prompt), chunk):
        logits, cache = tl.forward(qt, TCFG,
                                   torch.tensor([prompt[off:off + chunk]]),
                                   cache)
    steps = [logits[0, -1]]
    for tok in toks[:-1]:
        logits, cache = tl.forward(qt, TCFG, torch.tensor([[tok]]), cache)
        steps.append(logits[0, -1])
    return torch.stack(steps)


# one JAX Server (its prefill and decode compiles take some 17 s): q8_0,
# the form without K2; the qh plane's decode is held by the plain K2
# against JAX's (q5_0, q5_1, q5_k) and the Q5_K_M file's decode step
SERVER_QTYPES = ["q8_0"]


@pytest.mark.parametrize("qtype", SERVER_QTYPES)
def test_server_matches_jax_server(jax_q, qtype):
    """Two interleaved greedy requests through both Servers (32-token
    prompts, so JAX compiles one prefill and one decode program): each
    JAX token is the port's argmax along its own transcript or a
    near-tie, and the port's transcript equals its own solo decode."""
    qj = jax_q(qtype)
    qt = _from_jax(qj)
    rng = np.random.default_rng(22)
    prompts = [[int(x) for x in rng.integers(0, 256, 32)] for _ in range(2)]
    news = (6, 8)
    srv_j = js.Server(qj, JCFG, n_slots=2, max_prefill_chunk=32,
                      prefill_bucket=16, cache_prompt=False)
    srv_t = ts.Server(qt, TCFG, n_slots=2, max_prefill_chunk=32,
                      prefill_bucket=16, cache_prompt=False, device="cpu")
    for srv in (srv_j, srv_t):
        for p, n in zip(prompts, news):
            srv.submit(p, max_new=n)
    out_j, out_t = srv_j.run_until_done(), srv_t.run_until_done()
    for rid, (p, n) in enumerate(zip(prompts, news)):
        assert len(out_t[rid]) == len(out_j[rid]) == n
        own = _logits_along(qt, p, out_t[rid])
        assert own.argmax(-1).tolist() == out_t[rid]
        along = _logits_along(qt, p, out_j[rid])
        picked = along[torch.arange(n), torch.tensor(out_j[rid])]
        slack = along.amax(-1) - picked
        assert (slack <= 2 * LOGIT_TOL * along.abs().amax(-1)).all()
        if not slack.any():
            assert out_t[rid] == out_j[rid]


def test_load_q5_k_m_matches_jax(q5_k_m_file):
    """``load_llama`` on the Q5_K_M-mix file: the weights JAX's loader
    makes, bit for bit (q5_k effective planes, q6_K per-16 weights, a
    SplitLinear ``wqkv`` in the more-bits layer), and JAX's logits for a
    prefill and a decode step."""
    jp, jcfg = jgl.load_llama(str(q5_k_m_file))
    tp, tcfg = tgl.load_llama(q5_k_m_file, device="cpu")
    assert tuple(tcfg) == tuple(jcfg)
    _same_params(tp, _from_jax(jp))
    assert tp["layers"][0]["wqkv"].qtype == "q5_k"
    assert all(isinstance(tp["layers"][i]["wqkv"], tl.SplitLinear)
               for i in MORE_BITS)
    assert tp["lm_head"].qtype == "q6_k"
    rng = np.random.default_rng(23)
    tokens = rng.integers(0, 256, (2, 16)).astype(np.int32)
    lj, cj = jl.jit_forward(jp, jcfg, jnp.asarray(tokens),
                            jl.KVCache.init(jcfg, 2))
    lt, ct = tl.forward(tp, tcfg, torch.from_numpy(tokens),
                        tl.KVCache.init(tcfg, 2, device="cpu"))
    _assert_logits_close(lt, lj)
    nt = rng.integers(0, 256, (2, 1)).astype(np.int32)
    lj, _ = jl.jit_forward(jp, jcfg, jnp.asarray(nt), cj)
    lt, _ = tl.forward(tp, tcfg, torch.from_numpy(nt), ct)
    _assert_logits_close(lt, lj)


@pytest.mark.parametrize("qtype", ["q4_0", "q4_1", "q5_0", "q4_k", "q8_0"])
def test_begin_takes_k2_as_jax(jax_q, qtype):
    """``begin()`` takes K2 on a uniform q4/q5 model and not on q8_0 or a
    model with a ``SplitLinear`` wqkv, as JAX's ``qkv_supported`` rules."""
    qj = jax_q(qtype)
    qt = _from_jax(qj)
    nt = torch.zeros(2, 1, dtype=torch.int32)
    cache = tl.KVCache.init(TCFG, 2, device="cpu")
    want = all(jmega.qkv_supported(ly, JCFG, 2) for ly in qj["layers"])
    assert want == (qtype != "q8_0")
    assert tl.begin(qt, TCFG, nt, cache)[1].use_mega == want
    split = dict(qt, layers=[dict(qt["layers"][0]), *qt["layers"][1:]])
    w = split["layers"][0]["wqkv"]
    nq = JCFG.dim  # the q rows, then k and v
    split["layers"][0]["wqkv"] = tl.SplitLinear(tuple(
        layout.PreparedWeight(w.qtype, hi - lo, w.k,
                              *(t[lo:hi] if t is not None else None
                                for t in w[3:]))
        for lo, hi in ((0, nq), (nq, w.n))))
    assert not gemm_megalayer.supported(split["layers"][0]["wqkv"],
                                        TCFG.dim, 2)
    assert not tl.begin(split, TCFG, nt, cache)[1].use_mega
