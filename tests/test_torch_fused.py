"""The decode fusions of the port against the JAX package, on the CPU:
K6 ``gemm_exact_fused`` and K8 ``attn_tail``, the switches that reach
them (``registry.FUSED_DECODE``, ``gemm_megalayer.ENABLE_TAIL``) and
the decode step they change.

Inputs are made with numpy from a seed; the JAX kernels run in interpret
mode, as the JAX tests run them, and the port's wrappers run their plain
versions on CPU tensors.  Tolerances:

* K6: ``rtol=1e-5, atol=1e-5 * max|C|`` against JAX ``gemm_exact_fused``
  (K1's rule: the same float32 block terms summed in another order); the
  port's plain version is quantize + plain K1 exactly, degenerate blocks
  included, and its Q8_1 codes of those blocks equal JAX's;
* K8: ``2e-3 * max|out - x|`` on the layer update against JAX
  ``attn_tail`` (K2's rule: a last-ulp difference in RMSNorm or SiLU can
  move a Q8_1 code across a .5 tie), and bit-equal to the port's unfused
  chain;
* the decode step with either switch or both: bit-equal to the step with
  both off (on the CPU every fused path computes the unfused chain), and
  against JAX's decode with the same switches within the logit tolerance
  of ``test_torch_model.py`` (``2e-2 * max|logits|``, NMSE 2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_gemm_tpu.formats import jax_quant as jq
from quant_gemm_tpu.formats import kquants as jk
from quant_gemm_tpu.formats import numpy_ref as jnr
from quant_gemm_tpu.kernels import gemm_megalayer as jmega
from quant_gemm_tpu.kernels import registry as jreg
from quant_gemm_tpu.kernels.gemm_exact import (
    gemm_exact_fused as j_gemm_exact_fused)
from quant_gemm_tpu.kernels.gemm_pallas import prepare as j_prepare
from quant_gemm_tpu.models import llama as jl
from quant_gemm_tpu_torch.formats import kquants as tk
from quant_gemm_tpu_torch.formats import quant as tq
from quant_gemm_tpu_torch.kernels import gemm_megalayer, layout, registry
from quant_gemm_tpu_torch.kernels.gemm_exact import (gemm_exact_fused,
                                                     gemm_exact_plain)
from quant_gemm_tpu_torch.kernels.gemm_megalayer import attn_tail
from quant_gemm_tpu_torch.models import llama as tl
from quant_gemm_tpu_torch.ops.activations import silu_mul
from quant_gemm_tpu_torch.ops.rms_norm import rms_norm

N, K, EPS = 512, 1024, 1e-5
DIM, DFF = 512, 1024
JCFG = jl.LlamaConfig(vocab=256, dim=DIM, n_layers=2, n_heads=8,
                      n_kv_heads=2, d_ff=DFF, max_seq=128)
TCFG = tl.LlamaConfig(**JCFG._asdict())
LOGIT_TOL = 2e-2
NMSE_TOL = 2e-4


def _close_rel(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


def _act(m, seed, k=K, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    """q4_0 and q4_K (effective form) weights [N, K] for both packages."""
    rng = np.random.default_rng(51)
    w = rng.normal(0, 0.05, (N, K)).astype(np.float32)
    q40 = jnr.quantize_q4_0(w)
    jq4k = jk.quantize_q4_k(w)
    tq4k = tk.Q4_KTensor(*(torch.from_numpy(np.ascontiguousarray(
        np.asarray(f))) for f in jq4k))
    return {"q4_0": (j_prepare(q40), layout.prepare(tq.quantize_q4_0(
                torch.from_numpy(w)))),
            "q4_k": (j_prepare(jk.to_effective(jq4k)),
                     layout.prepare(tk.to_effective(tq4k)))}


@pytest.mark.parametrize("m", [1, 5, 8])
@pytest.mark.parametrize("qtype", ["q4_0", "q4_k"])
def test_gemm_exact_fused_matches_jax(weights, qtype, m):
    jw, pw = weights[qtype]
    assert pw.qtype == qtype
    x = _act(m, 52 + m)
    got = gemm_exact_fused(pw, torch.from_numpy(x))
    _close_rel(got.numpy(), j_gemm_exact_fused(jw, jnp.asarray(x)), 1e-5)
    torch.testing.assert_close(
        got, gemm_exact_plain(pw, tq.quantize_q8_1(torch.from_numpy(x))),
        rtol=0, atol=0)


def test_gemm_exact_fused_degenerate_blocks(weights):
    """tests/test_kernels.py::test_fused_exact_degenerate_blocks's input:
    a zero block (d = 0, codes 0) and blocks whose amax / 127 saturates
    f16.  The port's codes equal JAX's; its result is quantize + plain K1
    bit for bit, finite, and within K1's tolerance of JAX's kernel."""
    jw, pw = weights["q4_0"]
    x = np.random.default_rng(3).normal(0, 1, (4, K)).astype(np.float32)
    x[0, 0:32] = 0.0
    x[1, 32:64] = 7e8
    x[2, 64:96] = -7e8
    a_t = tq.quantize_q8_1(torch.from_numpy(x))
    a_j = jq.quantize_q8_1(jnp.asarray(x))
    for t, j in zip(a_t, a_j):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    got = gemm_exact_fused(pw, torch.from_numpy(x))
    torch.testing.assert_close(got, gemm_exact_plain(pw, a_t), rtol=0,
                               atol=0)
    assert torch.isfinite(got).all()
    _close_rel(got.numpy(), j_gemm_exact_fused(jw, jnp.asarray(x)), 1e-5)


def test_fused_wrappers_cpu_plain_and_refuse_other_devices(weights,
                                                           tail_weights):
    """On CPU tensors K6 and K8 run their plain versions and count no
    launch; a tensor on neither the CPU nor a CUDA device is refused, not
    run through the plain version."""
    _, pw = weights["q4_0"]
    _, pws = tail_weights
    x = torch.from_numpy(_act(2, 58))
    xt = torch.from_numpy(_act(2, 59, k=DIM))
    before = (gemm_exact_fused.launches, attn_tail.launches)
    gemm_exact_fused(pw, x)
    attn_tail(xt, xt, torch.ones(DIM), pws["wo"], pws["wgu"],
              pws["w_down"], EPS, DFF)
    assert (gemm_exact_fused.launches, attn_tail.launches) == before

    def meta(w):
        return layout.PreparedWeight(*(t.to("meta") if isinstance(
            t, torch.Tensor) else t for t in w))

    with pytest.raises(ValueError):
        gemm_exact_fused(meta(pw), x.to("meta"))
    with pytest.raises(ValueError):
        attn_tail(xt.to("meta"), xt.to("meta"), torch.ones(DIM,
                                                           device="meta"),
                  *(meta(pws[n]) for n in ("wo", "wgu", "w_down")), EPS, DFF)
    with pytest.raises(NotImplementedError):
        attn_tail(xt, xt, torch.ones(DIM), weights["q4_k"][1], pws["wgu"],
                  pws["w_down"], EPS, DFF)


def _lin(rng, n, k):
    return (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)


@pytest.fixture(scope="module")
def tail_weights():
    rng = np.random.default_rng(53)
    ws = {"wo": _lin(rng, DIM, DIM), "wgu": _lin(rng, 2 * DFF, DIM),
          "w_down": _lin(rng, DIM, DFF)}
    return ({k: j_prepare(jnr.quantize_q4_0(v)) for k, v in ws.items()},
            {k: layout.prepare(tq.quantize_q4_0(torch.from_numpy(v)))
             for k, v in ws.items()})


@pytest.mark.parametrize("m", [8, 5, 1])
def test_attn_tail_matches_jax(tail_weights, m):
    jws, pws = tail_weights
    rng = np.random.default_rng(54 + m)
    attn = rng.standard_normal((m, DIM)).astype(np.float32)
    x = (rng.standard_normal((m, DIM)) * 3).astype(np.float32)
    nw = rng.normal(1, 0.1, DIM).astype(np.float32)
    got = attn_tail(torch.from_numpy(attn), torch.from_numpy(x),
                    torch.from_numpy(nw), pws["wo"], pws["wgu"],
                    pws["w_down"], EPS, DFF)
    want = np.asarray(jmega.attn_tail(
        jnp.asarray(attn), jnp.asarray(x), jnp.asarray(nw), jws["wo"],
        jws["wgu"], jws["w_down"], EPS, DFF))
    np.testing.assert_allclose(got.numpy() - x, want - x, rtol=0,
                               atol=2e-3 * np.abs(want - x).max())
    # the plain version is exactly the unfused chain of models/llama.py
    xt = torch.from_numpy(x)
    xm = xt + registry.dispatch(pws["wo"], torch.from_numpy(attn),
                                quantize_act=True, ops=registry.PLAIN)
    h = rms_norm(xm, torch.from_numpy(nw), EPS)
    gu = registry.dispatch(pws["wgu"], h, quantize_act=True,
                           ops=registry.PLAIN)
    ff = silu_mul(gu[:, :DFF], gu[:, DFF:])
    want_t = xm + registry.dispatch(pws["w_down"], ff, quantize_act=True,
                                    ops=registry.PLAIN)
    torch.testing.assert_close(got, want_t, rtol=0, atol=0)


class _Recorder:
    """An Ops whose entries record which kernels ran (each runs its
    plain version on these CPU tensors)."""

    def __init__(self, base=registry.KERNELS):
        self.calls = []
        self.base = base

    def ops(self):
        def rec(name, fn):
            def f(*a, **kw):
                self.calls.append(name)
                return fn(*a, **kw)
            return f
        b = self.base
        return registry.Ops(*(rec(n, getattr(b, n)) for n in b._fields))

    def count(self, name):
        return self.calls.count(name)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("m, qtype", [(1, "q4_0"), (12, "q4_0"),
                                      (13, "q4_0"), (8, "q4_k"),
                                      (8, "q6_K")])
def test_dispatch_routes_with_fused_decode(weights, monkeypatch, fused, m,
                                           qtype):
    """FUSED_DECODE sends a float activation of M <= 12 with quantize_act
    on a per-32 weight to K6; M > 12 keeps K4, per-16 weights keep
    quantize + K7, and a Q8_1 activation keeps K1.  Both settings give the
    same result bit for bit."""
    if qtype == "q6_K":
        w = layout.prepare_k16(tk.random_blocks(
            "q6_K", 64, K, 0.05, torch.Generator().manual_seed(0)))
    else:
        w = weights[qtype][1]
    x = torch.from_numpy(_act(m, 55))
    monkeypatch.setattr(registry, "FUSED_DECODE", fused)
    rec = _Recorder()
    got = registry.dispatch(w, x, quantize_act=True, ops=rec.ops())
    if qtype == "q6_K":
        route = "gemm_exact_k16"
    elif m > registry.DECODE_M_MAX:
        route = "gemm_dequant"
    else:
        route = "gemm_exact_fused" if fused else "gemm_exact"
    assert rec.calls == [route]
    monkeypatch.setattr(registry, "FUSED_DECODE", not fused)
    torch.testing.assert_close(
        got, registry.dispatch(w, x, quantize_act=True), rtol=0, atol=0)
    if qtype != "q6_K" and m <= registry.DECODE_M_MAX:
        rec = _Recorder()
        registry.dispatch(w, tq.quantize_q8_1(x), ops=rec.ops())
        assert rec.calls == ["gemm_exact"]


@pytest.fixture(scope="module")
def qparams():
    return tl.quantize_params(tl.init_params(TCFG, seed=3), device="cpu")


def test_tail_supported_follows_its_switch(qparams, monkeypatch):
    """ENABLE_TAIL (off by default, as in JAX) gates K8; the rules refuse
    M > 8, dim or d_ff % 512 != 0 and (K8) q4_k weights; K2's
    ``supported`` takes no switch, and takes q4_k as JAX's does."""
    lyr = qparams["layers"][0]
    assert not gemm_megalayer.ENABLE_TAIL  # the JAX default
    assert gemm_megalayer.supported(lyr["wqkv"], DIM, 8)
    assert not gemm_megalayer.supported(lyr["wqkv"], DIM, 9)
    assert not gemm_megalayer.tail_supported(lyr, TCFG, 8)
    monkeypatch.setattr(gemm_megalayer, "ENABLE_TAIL", True)
    assert gemm_megalayer.tail_supported(lyr, TCFG, 8)
    assert gemm_megalayer.tail_supported(lyr, TCFG, 1)
    assert not gemm_megalayer.tail_supported(lyr, TCFG, 9)
    assert gemm_megalayer.supported(lyr["wqkv"], DIM, 8)
    # dim % 512 != 0 (a model of dim 256), d_ff % 512 != 0, q4_k weights
    small = tl.LlamaConfig(vocab=64, dim=256, n_layers=1, n_heads=4,
                           n_kv_heads=2, d_ff=512)
    qs = tl.quantize_params(tl.init_params(small, seed=1), device="cpu")
    assert not gemm_megalayer.tail_supported(qs["layers"][0], small, 8)
    assert not gemm_megalayer.supported(qs["layers"][0]["wqkv"], 256, 8)
    odd = TCFG._replace(d_ff=768)
    assert not gemm_megalayer.tail_supported(lyr, odd, 8)
    q4k = {**lyr, "wgu": layout.PreparedWeight("q4_k", *lyr["wgu"][1:4],
                                               lyr["wgu"].d.float(),
                                               torch.zeros_like(
                                                   lyr["wgu"].d.float()))}
    assert not gemm_megalayer.tail_supported(q4k, TCFG, 8)
    assert gemm_megalayer.supported(q4k["wgu"], DIM, 8)


def _prefilled(qp, rng):
    cache = tl.KVCache.init(TCFG, 2, device="cpu")
    tokens = rng.integers(0, 256, (2, 24)).astype(np.int32)
    tl.forward(qp, TCFG, torch.from_numpy(tokens), cache)
    return tokens, cache


@pytest.mark.parametrize("fused, tail", [(True, False), (False, True),
                                         (True, True)])
def test_decode_with_switches_bit_equal(qparams, monkeypatch, fused, tail):
    """A 2-layer decode step with either switch or both equals the step
    with both off, bit for bit; the fused step's kernels are K8 once per
    layer (tail), K6 for the rest of the per-32 GEMMs (fused) and K1 for
    none of them."""
    rng = np.random.default_rng(56)
    _, cache = _prefilled(qparams, rng)
    nt = torch.from_numpy(rng.integers(0, 256, (2, 1)).astype(np.int32))
    base = tl.forward(qparams, TCFG, nt, cache.clone())[0]
    monkeypatch.setattr(registry, "FUSED_DECODE", fused)
    monkeypatch.setattr(gemm_megalayer, "ENABLE_TAIL", tail)
    rec = _Recorder()
    got = tl.forward(qparams, TCFG, nt, cache.clone(), ops=rec.ops())[0]
    torch.testing.assert_close(got, base, rtol=0, atol=0)
    layers = TCFG.n_layers
    per_layer = 0 if tail else 3  # wo, wgu, w_down outside K8
    assert rec.count("attn_tail") == (layers if tail else 0)
    assert rec.count("norm_qkv") == rec.count("flash_decode") == layers
    gemms = 1 + per_layer * layers  # and the lm_head
    assert rec.count("gemm_exact_fused") == (gemms if fused else 0)
    assert rec.count("gemm_exact") == (0 if fused else gemms)


def test_fused_decode_matches_jax(qparams, monkeypatch):
    """JAX's decode with FUSED_DECODE and ENABLE_TAIL on (a jit traced
    with them set) against the port's with the same switches, from caches
    both prefilled by their own package."""
    params = jl.init_params(JCFG, seed=3)
    qj = jl.quantize_params(params)
    rng = np.random.default_rng(57)
    tokens, ct = _prefilled(qparams, rng)
    _, cj = jl.jit_forward(qj, JCFG, jnp.asarray(tokens),
                           jl.KVCache.init(JCFG, 2))
    nt = rng.integers(0, 256, (2, 1)).astype(np.int32)
    for mod, name in ((jreg, "FUSED_DECODE"), (jmega, "ENABLE_TAIL"),
                      (registry, "FUSED_DECODE"),
                      (gemm_megalayer, "ENABLE_TAIL")):
        monkeypatch.setattr(mod, name, True)
    traced = []  # the JAX kernels the trace reached

    def spy(mod, name):
        fn = getattr(mod, name)

        def f(*a, **kw):
            traced.append(name)
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, f)

    spy(jmega, "attn_tail")
    spy(jreg, "_gemm_exact_fused")
    fused_forward = jax.jit(jl.forward, static_argnames=("cfg",))
    lj, _ = fused_forward(qj, JCFG, jnp.asarray(nt), cj)
    assert traced.count("attn_tail") == JCFG.n_layers
    assert traced.count("_gemm_exact_fused") == 1  # the lm_head
    rec = _Recorder()
    lt, _ = tl.forward(qparams, TCFG, torch.from_numpy(nt), ct,
                       ops=rec.ops())
    assert rec.count("attn_tail") == TCFG.n_layers
    got, want = lt.numpy(), np.asarray(lj)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    assert ((got - want) ** 2).sum() <= NMSE_TOL * (want ** 2).sum()


# -- K2's switch (gemm_megalayer.ENABLE_QKV) ---------------------------------


@pytest.mark.parametrize("enabled, qkv", [(True, True), (True, False),
                                          (False, True)])
def test_qkv_supported_follows_jax_switches(qparams, monkeypatch, enabled,
                                            qkv):
    """``qkv_supported`` and ``layer_supported`` give JAX's verdicts with
    the same switches on the same layer (M 8 and 9), K8 on and off.  JAX's
    ``ENABLED`` (both fusions) has no port switch: off, it is the port's
    ``ENABLE_QKV`` and ``ENABLE_TAIL`` both off."""
    params = jl.init_params(JCFG, seed=3)
    jlyr = jl.quantize_params(params)["layers"][0]
    tlyr = qparams["layers"][0]
    assert jmega.ENABLED and gemm_megalayer.ENABLE_QKV  # JAX's defaults
    monkeypatch.setattr(jmega, "ENABLED", enabled)
    monkeypatch.setattr(jmega, "ENABLE_QKV", qkv)
    monkeypatch.setattr(gemm_megalayer, "ENABLE_QKV", qkv and enabled)
    for tail in (False, True):
        monkeypatch.setattr(jmega, "ENABLE_TAIL", tail)
        monkeypatch.setattr(gemm_megalayer, "ENABLE_TAIL", tail and enabled)
        for m in (8, 9):
            assert (gemm_megalayer.qkv_supported(tlyr, TCFG, m)
                    == jmega.qkv_supported(jlyr, JCFG, m)
                    == (enabled and qkv and m <= 8))
            assert (gemm_megalayer.layer_supported(tlyr, TCFG, m)
                    == jmega.layer_supported(jlyr, JCFG, m))


def test_qkv_bypass_line_once_per_qtype_and_dim(monkeypatch, capsys):
    """A wqkv K2 cannot take (q8_0) prints JAX's bypass line to stderr
    once per (qtype, dim); switched off, nothing is printed."""
    monkeypatch.setattr(gemm_megalayer, "_BYPASS_LOGGED", set())
    w = layout.prepare(tq.quantize_q8_0(torch.from_numpy(_act(64, 60, DIM))))
    lyr = {"wqkv": w}
    assert not gemm_megalayer.qkv_supported(lyr, TCFG, 8)
    assert not gemm_megalayer.qkv_supported(lyr, TCFG, 4)
    err = capsys.readouterr().err
    assert err.count("megalayer: norm_qkv bypassed (wqkv qtype=q8_0, "
                     f"dim={DIM})") == 1
    monkeypatch.setattr(gemm_megalayer, "_BYPASS_LOGGED", set())
    monkeypatch.setattr(gemm_megalayer, "ENABLE_QKV", False)
    assert not gemm_megalayer.qkv_supported(lyr, TCFG, 8)
    assert capsys.readouterr().err == ""


def test_decode_without_k2_is_the_unfused_chain(qparams, monkeypatch):
    """With ENABLE_QKV off a decode step takes no K2: RMSNorm, one Q8_1
    quantize and K1 on wqkv in every layer, and its logits equal the
    default step's bit for bit (on the CPU K2's plain version is that
    chain)."""
    rng = np.random.default_rng(58)
    _, cache = _prefilled(qparams, rng)
    nt = torch.from_numpy(rng.integers(0, 256, (2, 1)).astype(np.int32))
    rec = _Recorder()
    base = tl.forward(qparams, TCFG, nt, cache.clone(), ops=rec.ops())[0]
    assert rec.count("norm_qkv") == TCFG.n_layers
    monkeypatch.setattr(gemm_megalayer, "ENABLE_QKV", False)
    assert tl.routes(qparams, TCFG, 2, 1) == (False, False)
    rec = _Recorder()
    got = tl.forward(qparams, TCFG, nt, cache.clone(), ops=rec.ops())[0]
    torch.testing.assert_close(got, base, rtol=0, atol=0)
    assert rec.count("norm_qkv") == 0
    assert rec.count("gemm_exact") == 1 + 4 * TCFG.n_layers


def test_decode_without_k2_matches_jax(qparams, monkeypatch):
    """JAX's decode with its ENABLE_QKV off (a jit traced so, no
    ``norm_qkv`` reached) against the port's with the same switch."""
    params = jl.init_params(JCFG, seed=3)
    qj = jl.quantize_params(params)
    rng = np.random.default_rng(59)
    tokens, ct = _prefilled(qparams, rng)
    _, cj = jl.jit_forward(qj, JCFG, jnp.asarray(tokens),
                           jl.KVCache.init(JCFG, 2))
    nt = rng.integers(0, 256, (2, 1)).astype(np.int32)
    monkeypatch.setattr(jmega, "ENABLE_QKV", False)
    monkeypatch.setattr(gemm_megalayer, "ENABLE_QKV", False)
    traced = []
    fn = jmega.norm_qkv

    def spy(*a, **kw):
        traced.append("norm_qkv")
        return fn(*a, **kw)

    monkeypatch.setattr(jmega, "norm_qkv", spy)
    lj, _ = jax.jit(jl.forward, static_argnames=("cfg",))(
        qj, JCFG, jnp.asarray(nt), cj)
    assert traced == []
    rec = _Recorder()
    lt, _ = tl.forward(qparams, TCFG, torch.from_numpy(nt), ct,
                       ops=rec.ops())
    assert rec.count("norm_qkv") == 0
    got, want = lt.numpy(), np.asarray(lj)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    assert ((got - want) ** 2).sum() <= NMSE_TOL * (want ** 2).sum()


def test_graph_key_names_k2_switches(monkeypatch):
    from quant_gemm_tpu_torch.models import serve

    base = serve.graph_key("decode", 256)
    monkeypatch.setattr(gemm_megalayer, "ENABLE_QKV", False)
    no_qkv = serve.graph_key("decode", 256)
    monkeypatch.setattr(gemm_megalayer, "ENABLE_TAIL", True)
    k8_only = serve.graph_key("decode", 256)
    monkeypatch.setattr(gemm_megalayer, "ENABLE_QKV", True)
    both = serve.graph_key("decode", 256)
    assert len({base, no_qkv, k8_only, both}) == 4
