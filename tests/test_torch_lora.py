"""Run-time LoRA adapters in the port against the JAX package, on the CPU,
at the small Llama of JAX's ``tests/test_lora.py`` (dim 256, 2 layers,
rank 8, alpha 16, deltas on q, v, gate, down and the output head).

Tolerances: the adapter GGUF written by either package reads back the
same floats in both (exact); the LoRA'd forward against JAX's LoRA'd
forward by the q8_1 rule of ``tests/test_torch_model.py`` (``max|delta|
<= 2e-2 * max|logits|``, NMSE <= 2e-4: both sides quantize their own
activations, and a Q8_1 code may flip at a .5 tie); JAX's LoRA'd
parameters carried across (``convert.qparams_from_jax``) serve the
port's own attach bit for bit; against the merged float reference (the
deltas merged into the float weights, through ``forward_float``) the gap
is the base model's quantization gap, as JAX's test holds it (NMSE <
1.3 x the base gap + 1e-4).  Exact: a delta lands in its column slice of a
fused slot; a LoRA'd ``wqkv`` turns K2 off and a LoRA'd ``wo`` / ``wgu``
/ ``w_down`` turns K8 off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_gemm_tpu.models import llama as jl
from quant_gemm_tpu.models import lora as jlora
from quant_gemm_tpu_torch.kernels import gemm_megalayer
from quant_gemm_tpu_torch.models import convert
from quant_gemm_tpu_torch.models import llama as tl
from quant_gemm_tpu_torch.models import lora as tlora

JCFG = jl.LlamaConfig(vocab=64, dim=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=256, max_seq=32)
TCFG = tl.LlamaConfig(**JCFG._asdict())
RANK, ALPHA = 8, 16.0
LOGIT_TOL = 2e-2
NMSE_TOL = 2e-4


def _adapter_tensors(cfg, seed=5):
    """JAX's test adapter: A/B for q, v, gate, down of every layer and the
    output head, scaled small like real finetunes."""
    rng = np.random.default_rng(seed)
    nq = cfg.n_heads * cfg.head_dim
    nkv = cfg.n_kv_heads * cfg.head_dim

    def ab(n, k):
        return (rng.normal(size=(RANK, k)).astype(np.float32) * 0.05,
                rng.normal(size=(n, RANK)).astype(np.float32) * 0.05)

    out = {}
    for i in range(cfg.n_layers):
        out[f"blk.{i}.attn_q.weight"] = ab(nq, cfg.dim)
        out[f"blk.{i}.attn_v.weight"] = ab(nkv, cfg.dim)
        out[f"blk.{i}.ffn_gate.weight"] = ab(cfg.d_ff, cfg.dim)
        out[f"blk.{i}.ffn_down.weight"] = ab(cfg.dim, cfg.d_ff)
    out["output.weight"] = ab(cfg.vocab, cfg.dim)
    return out


def _merged(params, tensors, scale):
    """The deltas merged into the float weights (JAX test_lora.py)."""
    merged = dict(params, layers=[dict(ly) for ly in params["layers"]])
    name_of = {"attn_q": "wq", "attn_v": "wv", "ffn_gate": "w_gate",
               "ffn_down": "w_down"}
    for base, (a, b) in tensors.items():
        if base == "output.weight":
            merged["lm_head"] = params["lm_head"] + scale * (b @ a)
            continue
        _, i, part, _ = base.split(".")
        lyr = merged["layers"][int(i)]
        lyr[name_of[part]] = lyr[name_of[part]] + scale * (b @ a)
    return merged


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    params = jl.init_params(JCFG, seed=4)
    tensors = _adapter_tensors(JCFG)
    d = tmp_path_factory.mktemp("lora")
    jlora.export_lora(d / "jax.gguf", ALPHA, tensors)
    tlora.export_lora(d / "port.gguf", ALPHA, tensors)
    qj = jl.quantize_params(params, "q4_0")
    qt = tl.quantize_params(params, "q4_0", device="cpu")
    return params, tensors, d, qj, qt


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_adapter_gguf_roundtrip_matches_jax(setup, writer):
    _, tensors, d, _, _ = setup
    path = d / f"{writer}.gguf"
    ja, ta = jlora.load_lora(path), tlora.load_lora(path, device="cpu")
    assert ta.alpha == ja.alpha == ALPHA
    assert set(ta.tensors) == set(ja.tensors) == set(tensors)
    for name, (a, b) in tensors.items():
        assert torch.equal(ta.tensors[name].a, torch.from_numpy(a))
        assert torch.equal(ta.tensors[name].b, torch.from_numpy(b))
        np.testing.assert_array_equal(ja.tensors[name].a, a)


def test_f16_tensors_export_as_f16(setup, tmp_path):
    from quant_gemm_tpu.formats.gguf_file import GGUFFile

    _, tensors, _, _, _ = setup
    a, b = tensors["blk.0.attn_q.weight"]
    half = {"blk.0.attn_q.weight": (torch.from_numpy(a).half(),
                                    torch.from_numpy(b).half())}
    tlora.export_lora(tmp_path / "h.gguf", ALPHA, half)
    gf = GGUFFile(tmp_path / "h.gguf")
    assert gf.tensors["blk.0.attn_q.weight.lora_a"]["qtype"] == "f16"
    ja = jlora.load_lora(tmp_path / "h.gguf")
    np.testing.assert_array_equal(ja.tensors["blk.0.attn_q.weight"].a,
                                  a.astype(np.float16).astype(np.float32))


def _forwards(qj_lora, qt_lora, toks):
    lj, cj = jl.jit_forward(qj_lora, JCFG, jnp.asarray(toks),
                            jl.KVCache.init(JCFG, toks.shape[0]))
    lt, ct = tl.forward(qt_lora, TCFG, torch.from_numpy(toks),
                        tl.KVCache.init(TCFG, toks.shape[0], device="cpu"))
    return np.asarray(lj), lt


def test_lora_forward_matches_jax_and_carries_across(setup):
    """A prefill and a decode step of the LoRA'd model against JAX's; the
    JAX LoRA'd parameters carried across serve the port's attach's bits;
    the base parameters are untouched."""
    _, _, d, qj, qt = setup
    qj_l = jlora.attach_lora(qj, jlora.load_lora(d / "jax.gguf"), JCFG)
    qt_l = tlora.attach_lora(qt, tlora.load_lora(d / "jax.gguf",
                                                 device="cpu"), TCFG)
    assert isinstance(qt_l["layers"][0]["wqkv"], tlora.LoraLinear)
    assert isinstance(qt_l["lm_head"], tlora.LoraLinear)
    assert not isinstance(qt["layers"][0]["wqkv"], tlora.LoraLinear)
    toks = np.random.default_rng(1).integers(0, 64, (2, 6)).astype(np.int32)
    lj, lt = _forwards(qj_l, qt_l, toks)
    assert np.abs(lt.numpy() - lj).max() <= LOGIT_TOL * np.abs(lj).max()
    assert ((lt.numpy() - lj) ** 2).sum() <= NMSE_TOL * (lj ** 2).sum()
    qc = convert.qparams_from_jax(jax.tree_util.tree_map(np.asarray, qj_l),
                                  device="cpu")
    wq = qc["layers"][1]["wqkv"]
    assert isinstance(wq, tlora.LoraLinear)
    assert [(o, s) for o, s, _ in wq.deltas] == [
        (o, s) for o, s, _ in qt_l["layers"][1]["wqkv"].deltas]
    c1 = tl.KVCache.init(TCFG, 2, device="cpu")
    assert torch.equal(tl.forward(qc, TCFG, torch.from_numpy(toks), c1)[0],
                       lt)


def test_lora_forward_matches_merged_reference(setup):
    """Quantized base + deltas against the float weights with the deltas
    merged, through ``forward_float``: the gap is the base model's pure
    quantization gap (the delta path is float32)."""
    params, tensors, d, _, qt = setup
    adapter = tlora.load_lora(d / "port.gguf", device="cpu")
    qt_l = tlora.attach_lora(qt, adapter, TCFG)
    toks = torch.tensor([[3, 9, 17, 30]])

    def run(qp, float_=False):
        cache = tl.KVCache.init(TCFG, 1, device="cpu")
        if float_:
            return tl.forward_float(qp, TCFG, toks, cache)[0].numpy()
        return tl.forward(qp, TCFG, toks, cache)[0].numpy()

    def nmse(a, b):
        return ((a - b) ** 2).sum() / (b ** 2).sum()

    out, base = run(qt_l), run(qt)
    m = nmse(out, run(_merged(params, tensors, adapter.scale(RANK)), True))
    m0 = nmse(base, run(params, True))
    assert m < 1.3 * m0 + 1e-4 and m < 0.1, (m, m0)
    assert np.abs(out - base).max() > 1e-3


def test_fused_slot_column_offsets(setup):
    """A v-only delta leaves the q and k columns of ``wqkv`` bit for bit;
    the slot offsets are JAX's."""
    _, _, _, _, qt = setup
    assert tlora._slot_parts(TCFG) == jlora._slot_parts(JCFG)
    rng = np.random.default_rng(8)
    nq, nkv = TCFG.n_heads * TCFG.head_dim, TCFG.n_kv_heads * TCFG.head_dim
    a = torch.from_numpy(rng.normal(size=(RANK, TCFG.dim)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(nkv, RANK)).astype(np.float32))
    qv = tlora.attach_lora(qt, tlora.LoraAdapter(ALPHA, {
        "blk.0.attn_v.weight": tlora.LoraDelta(a, b)}), TCFG)
    x = torch.from_numpy(rng.normal(size=(2, TCFG.dim)).astype(np.float32))
    y0 = tl._linear(qt["layers"][0]["wqkv"], x, tl.registry.KERNELS)
    y1 = tl._linear(qv["layers"][0]["wqkv"], x, tl.registry.KERNELS)
    assert torch.equal(y0[:, :nq + nkv], y1[:, :nq + nkv])
    assert (y0[:, nq + nkv:] - y1[:, nq + nkv:]).abs().max() > 1e-4
    with pytest.raises(ValueError, match="no serving slot"):
        tlora.attach_lora(qt, tlora.LoraAdapter(ALPHA, {
            "blk.0.bogus.weight": tlora.LoraDelta(a, b)}), TCFG)


@pytest.mark.parametrize("slot", ["wqkv", "wo", "wgu", "w_down"])
def test_lora_turns_the_fused_routes_off(slot, monkeypatch):
    """At dim 512 (K2's and K8's width) a LoRA'd ``wqkv`` turns K2 off for
    the whole model and a LoRA'd ``wo``, ``wgu`` or ``w_down`` turns K8
    off, as in JAX; a decode step then still runs."""
    cfg = tl.LlamaConfig(vocab=64, dim=512, n_layers=2, n_heads=8,
                         n_kv_heads=2, d_ff=512, max_seq=32)
    qp = tl.init_qparams(cfg, seed=2, device="cpu")
    monkeypatch.setattr(gemm_megalayer, "ENABLE_TAIL", True)
    assert tl.routes(qp, cfg, 2, 1) == (True, True)
    part = {"wqkv": "attn_q", "wo": "attn_output", "wgu": "ffn_up",
            "w_down": "ffn_down"}[slot]
    w = qp["layers"][1][slot]
    g = torch.Generator().manual_seed(0)
    adapter = tlora.LoraAdapter(ALPHA, {f"blk.1.{part}.weight": tlora.LoraDelta(
        torch.randn(4, w.k, generator=g) * 0.01,
        torch.randn(cfg.d_ff if part == "ffn_up" else w.n, 4, generator=g)
        * 0.01)})
    ql = tlora.attach_lora(qp, adapter, cfg)
    assert tl.routes(ql, cfg, 2, 1) == ((False, True) if slot == "wqkv"
                                        else (True, False))
    logits, _ = tl.forward(ql, cfg, torch.tensor([[1], [2]]),
                           tl.KVCache.init(cfg, 2, device="cpu"))
    assert bool(torch.isfinite(logits).all())


FIXTURE = (__import__("pathlib").Path(__file__).parent / "golden"
           / "tiny_llama_q4km.gguf")


def test_generate_cli_and_engine_serve_the_adapter(tmp_path, capsys):
    """``generate.py --lora`` and ``server.py build_engine(lora_path=)``
    on the fixture GGUF with an adapter on its q/v/gate/down: the tokens
    of a Server over ``attach_lora``'s parameters, and not the base
    model's."""
    from quant_gemm_tpu_torch.models import gguf_loader, serve
    from quant_gemm_tpu_torch.scripts import generate
    from quant_gemm_tpu_torch.scripts import server as srv

    qp, cfg = gguf_loader.load_llama(FIXTURE, device="cpu")
    rng = np.random.default_rng(3)
    nkv = cfg.n_kv_heads * cfg.head_dim
    tensors = {}
    for i in range(cfg.n_layers):
        for part, n, k in (("attn_q", cfg.n_heads * cfg.head_dim, cfg.dim),
                           ("attn_v", nkv, cfg.dim),
                           ("ffn_gate", cfg.d_ff, cfg.dim),
                           ("ffn_down", cfg.dim, cfg.d_ff)):
            tensors[f"blk.{i}.{part}.weight"] = (
                rng.normal(size=(RANK, k)).astype(np.float32) * 0.3,
                rng.normal(size=(n, RANK)).astype(np.float32) * 0.3)
    path = tmp_path / "adapter.gguf"
    tlora.export_lora(path, ALPHA, tensors)
    ids = [0, 262, 312, 311, 292]

    def served(params):
        s = serve.Server(params, cfg, n_slots=1, device="cpu")
        rid = s.submit(ids, max_new=6)
        return s.run_until_done()[rid]

    want = served(tlora.attach_lora(qp, tlora.load_lora(path, device="cpu"),
                                    cfg))
    assert want != served(qp)
    generate.main(["-m", str(FIXTURE), "--ids", ",".join(map(str, ids)),
                   "-n", "6", "--lora", str(path), "--device", "cpu"])
    assert capsys.readouterr().out.strip() == ",".join(map(str, want))
    engine = srv.build_engine(FIXTURE, n_slots=1, lora_path=path,
                              device="cpu")
    try:
        assert isinstance(engine.server.qparams["layers"][0]["wqkv"],
                          tlora.LoraLinear)
        rid = engine.server.submit(ids, max_new=6)
        assert engine.server.run_until_done()[rid] == want
    finally:
        engine.shutdown()
