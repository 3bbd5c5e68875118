"""The qwen2 family in the port (QKV biases, tied embeddings) against the
JAX package, on the CPU: GGUF files as ``tests/test_qwen2.py::_qwen2_gguf``
writes them, ``quantize_params`` with biases, the bias on every route of
the forward, ``embed`` and ``export_gguf``.

Tolerances: the loaded parameters, the biases and the exported files are
bit-equal.  Logits, each side quantizing its own activations: ``max|delta|
<= 2e-2 * max|logits|`` and NMSE <= 2e-4 (``tests/test_torch_model.py``'s
bounds: XLA's and PyTorch's float32 rounding can move a Q8_1 code across
a .5 tie).  The routes of the port (K2, quantize + K1, K6, SplitLinear
parts) are bit-equal to each other on the CPU, whose plain versions are
the unfused chains.  Embeddings: 1e-5 (the same forward, L2-normalised).
Greedy transcripts: JAX's tokens are the port's argmax at every step or
within twice the logit tolerance of it (the near-tie rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_qwen2 as jq2
from quant_gemm_tpu.models import gguf_loader as jgl
from quant_gemm_tpu.models import llama as jl
from quant_gemm_tpu_torch.kernels import registry
from quant_gemm_tpu_torch.models import convert
from quant_gemm_tpu_torch.models import gguf_loader as tgl
from quant_gemm_tpu_torch.models import llama as tl
from quant_gemm_tpu_torch.models import serve as ts

LOGIT_TOL = 2e-2
NMSE_TOL = 2e-4
TCFG = tl.LlamaConfig(**jq2.CFG._asdict())
# K2 takes dim % 512 == 0: the same family at dim 512
JCFG512 = jq2.CFG._replace(dim=512, n_heads=8, n_kv_heads=2, d_ff=512,
                           max_seq=96)
TCFG512 = tl.LlamaConfig(**JCFG512._asdict())


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    assert ((got - want) ** 2).sum() <= NMSE_TOL * (want ** 2).sum()


def _biased(cfg, seed):
    params = jl.init_params(cfg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for lyr in params["layers"]:
        for b, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                     ("bv", cfg.n_kv_heads)):
            lyr[b] = rng.normal(size=n * cfg.head_dim).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def qwen_file(tmp_path_factory):
    params = jq2._biased_params()
    path = tmp_path_factory.mktemp("qwen2") / "qwen2.gguf"
    jq2._qwen2_gguf(path, params)
    jp, jcfg = jgl.load_llama(path)
    tp, tcfg = tgl.load_llama(path, device="cpu")
    return params, path, jp, jcfg, tp, tcfg


def test_qwen2_file_loads_equal_in_both_loaders(qwen_file):
    params, _, jp, jcfg, tp, tcfg = qwen_file
    assert tuple(tcfg) == tuple(jcfg)
    nq = jcfg.n_heads * jcfg.head_dim
    for i, (lj, lt) in enumerate(zip(jp["layers"], tp["layers"])):
        assert lt["bqkv"].dtype == torch.float32
        np.testing.assert_array_equal(lt["bqkv"].numpy(),
                                      np.asarray(lj["bqkv"]))
        np.testing.assert_array_equal(lt["bqkv"][:nq].numpy(),
                                      params["layers"][i]["bq"])
    conv = convert.qparams_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
    for lc, lt in zip(conv["layers"], tp["layers"]):
        assert set(lc) == set(lt)
        assert torch.equal(lc["bqkv"], lt["bqkv"])
        for name in ("wqkv", "wo", "wgu", "w_down"):
            for a, b in zip(lc[name][3:], lt[name][3:]):
                assert (a is None) == (b is None)
                if a is not None:
                    assert torch.equal(a, b)
    assert tp["lm_head"].qtype == "q8_0" or tp["lm_head"].n == jcfg.vocab


@pytest.mark.parametrize("tied", [True, False])
def test_qwen2_file_logits_match_jax(tied, tmp_path):
    params = jq2._biased_params(seed=5)
    path = tmp_path / "q.gguf"
    jq2._qwen2_gguf(path, params, tied=tied)
    jp, jcfg = jgl.load_llama(path)
    tp, tcfg = tgl.load_llama(path, device="cpu")
    toks = [[3, 9, 17, 30, 1, 2, 60, 11]]
    jc = jl.KVCache.init(jcfg, 1)
    want, jc = jl.jit_forward(jp, jcfg, jnp.asarray(toks, jnp.int32), jc)
    tc = tl.KVCache.init(tcfg, 1, device="cpu")
    got, tc = tl.forward(tp, tcfg, torch.tensor(toks), tc)
    _close(got.numpy(), want)
    # a decode step on top (the bias in the T = 1 route)
    nxt = [[int(np.asarray(want)[0, -1].argmax())]]
    want, _ = jl.jit_forward(jp, jcfg, jnp.asarray(nxt, jnp.int32), jc)
    got, _ = tl.forward(tp, tcfg, torch.tensor(nxt), tc)
    _close(got.numpy(), want)
    # the bias applies: dropping it moves the logits
    nobias = {**tp, "layers": [{k: v for k, v in ly.items() if k != "bqkv"}
                               for ly in tp["layers"]]}
    out_nb, _ = tl.forward(nobias, tcfg, torch.tensor(toks),
                           tl.KVCache.init(tcfg, 1, device="cpu"))
    assert float((out_nb - tl.forward(tp, tcfg, torch.tensor(toks),
                                      tl.KVCache.init(tcfg, 1,
                                                      device="cpu"))[0])
                 .abs().max()) > 1e-3


@pytest.fixture(scope="module")
def biased512():
    params = _biased(JCFG512, seed=21)
    return params, jl.quantize_params(params, "q4_0"), \
        tl.quantize_params(params, "q4_0", device="cpu")


def test_quantize_params_carries_bias_as_jax(biased512):
    params, jp, tp = biased512
    for lj, lt, lp in zip(jp["layers"], tp["layers"], params["layers"]):
        np.testing.assert_array_equal(lt["bqkv"].numpy(),
                                      np.asarray(lj["bqkv"]))
        np.testing.assert_array_equal(
            lt["bqkv"].numpy(), np.concatenate([lp["bq"], lp["bk"],
                                                lp["bv"]]))


def test_bias_on_every_decode_route(biased512, monkeypatch):
    """At dim 512 decode takes K2 (``norm_qkv``) then the bias; the
    quantize + K1 route, K6 (FUSED_DECODE) and a SplitLinear wqkv give
    the same bits on the CPU; all match JAX's forward (which takes its
    K2 there too)."""
    _, jp, tp = biased512
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, JCFG512.vocab, (2, 16))
    nxt = rng.integers(0, JCFG512.vocab, (2, 1))

    def port(qp, **flags):
        for k, v in flags.items():
            monkeypatch.setattr(registry, k, v)
        cache = tl.KVCache.init(TCFG512, 2, device="cpu")
        tl.forward(qp, TCFG512, torch.as_tensor(prompt), cache)
        step = tl.begin(qp, TCFG512, torch.as_tensor(nxt), cache)[1]
        out = tl.forward(qp, TCFG512, torch.as_tensor(nxt), cache)[0]
        monkeypatch.setattr(registry, "FUSED_DECODE", False)
        return out, step.use_mega

    k2, used = port(tp)
    assert used  # every layer's wqkv takes K2
    split = {**tp, "layers": [{**ly, "wqkv": tl.SplitLinear((ly["wqkv"],))}
                              for ly in tp["layers"]]}
    k1, used = port(split)
    assert not used
    k6, _ = port(split, FUSED_DECODE=True)
    assert torch.equal(k2, k1) and torch.equal(k1, k6)

    c = jl.KVCache.init(JCFG512, 2)
    _, c = jl.jit_forward(jp, JCFG512, jnp.asarray(prompt, jnp.int32), c)
    _close(k2.numpy(),
           jl.jit_forward(jp, JCFG512, jnp.asarray(nxt, jnp.int32), c)[0])


def test_bias_in_prefill_routes_match_jax(biased512):
    """Prefill: K4 (M > 12) and K5 (T >= 64) with the bias, and the dense
    attention below 64, against JAX."""
    _, jp, tp = biased512
    rng = np.random.default_rng(4)
    for t in (16, 64):
        toks = rng.integers(0, JCFG512.vocab, (1, t))
        want, _ = jl.jit_forward(jp, JCFG512, jnp.asarray(toks, jnp.int32),
                                 jl.KVCache.init(JCFG512, 1))
        got, _ = tl.forward(tp, TCFG512, torch.as_tensor(toks),
                            tl.KVCache.init(TCFG512, 1, device="cpu"))
        _close(got.numpy(), want)


@pytest.mark.parametrize("pooling", ["mean", "last", "none"])
def test_embed_matches_jax(qwen_file, pooling):
    _, _, jp, jcfg, tp, tcfg = qwen_file
    toks = [[3, 9, 17, 30, 0, 0, 0, 0], [5, 6, 7, 8, 9, 10, 11, 12]]
    lengths = [4, 8]
    want = np.asarray(jl.embed(jp, jcfg, jnp.asarray(toks, jnp.int32),
                               lengths=jnp.asarray(lengths),
                               pooling=pooling))
    got = tl.embed(tp, tcfg, torch.tensor(toks), lengths=lengths,
                   pooling=pooling).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if pooling != "none":
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   rtol=1e-5)
    with pytest.raises(ValueError, match="pooling"):
        tl.embed(tp, tcfg, torch.tensor(toks), pooling="max")


@pytest.mark.parametrize("case", ["bias_q4_0", "plain_q8_0_tokenizer",
                                  "window_scaled"])
def test_export_gguf_byte_equal_to_jax(case, tmp_path):
    cfg = jq2.CFG
    params = jq2._biased_params(seed=11)
    qtype, md = "q4_0", None
    if case == "plain_q8_0_tokenizer":
        params = jl.init_params(cfg, seed=12)
        qtype = "q8_0"
        md = {"tokenizer.ggml.model": "llama",
              "tokenizer.ggml.tokens": ["<unk>", "<s>", "</s>", "a"],
              "tokenizer.ggml.scores": [0.0, 0.0, 0.0, -1.5],
              "tokenizer.ggml.token_type": [2, 3, 3, 1],
              "tokenizer.ggml.bos_token_id": 1}
    elif case == "window_scaled":
        cfg = cfg._replace(window=16, rope_scale=0.5)
        params = {**params, "rope_inv_freq": np.linspace(
            1.0, 0.01, cfg.head_dim // 2).astype(np.float32)}
    pj, pt = tmp_path / "j.gguf", tmp_path / "t.gguf"
    jgl.export_gguf(pj, params, cfg, qtype=qtype, tokenizer_metadata=md)
    tgl.export_gguf(pt, params, tl.LlamaConfig(**cfg._asdict()),
                    qtype=qtype, tokenizer_metadata=md)
    assert pt.read_bytes() == pj.read_bytes()
    tp, tcfg = tgl.load_llama(pt, device="cpu")
    assert tuple(tcfg) == tuple(jgl.load_llama(pj)[1])
    if "bq" in params["layers"][0]:
        np.testing.assert_array_equal(
            tp["layers"][1]["bqkv"][:cfg.n_heads * cfg.head_dim].numpy(),
            params["layers"][1]["bq"])


def test_greedy_transcript_matches_jax_near_tie(qwen_file):
    """The Server on the qwen2 file (eager on the CPU) against JAX's
    greedy decode, token by token under the near-tie rule."""
    _, _, jp, jcfg, tp, tcfg = qwen_file
    prompt = [3, 9, 17, 30, 12, 1]
    n = 8
    c = jl.KVCache.init(jcfg, 1)
    logits, c = jl.jit_forward(jp, jcfg, jnp.asarray([prompt], jnp.int32), c)
    jtoks = []
    for _ in range(n):
        jtoks.append(int(np.asarray(logits)[0, -1].argmax()))
        logits, c = jl.jit_forward(jp, jcfg,
                                   jnp.asarray([[jtoks[-1]]], jnp.int32), c)
    srv = ts.Server(tp, tcfg, n_slots=2, device="cpu")
    rid = srv.submit(prompt, max_new=n)
    own = srv.run_until_done()[rid]
    cache = tl.KVCache.init(tcfg, 1, device="cpu")
    lg, cache = tl.forward(tp, tcfg, torch.tensor([prompt]), cache)
    along = [lg[0, -1]]
    for tok in jtoks[:-1]:
        lg, cache = tl.forward(tp, tcfg, torch.tensor([[tok]]), cache)
        along.append(lg[0, -1])
    along = torch.stack(along)
    picked = along[torch.arange(n), torch.tensor(jtoks)]
    slack = along.amax(-1) - picked
    assert (slack <= 2 * LOGIT_TOL * along.abs().amax(-1)).all()
    if not slack.any():
        assert own == jtoks
