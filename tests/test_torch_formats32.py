"""The per-32 formats q4_1, q5_0, q5_1 and q8_0 in the port, against the
JAX package, on the CPU: quantizers, the q4_K / q5_K encoders and codecs,
the kernel layout, the JAX-layout converter, and the plain versions of
K1 ``gemm_exact`` and K4 ``gemm_dequant`` in every form (the kernels
themselves are held to these on the card by ``tests/test_torch_cuda.py``).

Inputs are made with numpy from a seed.  Tolerances:

* quantizers, encoders, codecs, layouts: none (bit for bit);
* K1's plain version: ``1e-6 * max|C|`` against the float64-summed golden
  ``ref/gemm.py::gemm_wxa8`` (the same exact integer dots and float32
  block terms; only the float32 sum over blocks differs), ``1e-5 *
  max|C|`` against JAX ``gemm_exact`` in interpret mode, whose TPU
  epilogue takes the terms in another order;
* K4's plain version: ``1e-5`` relative (``atol = 1e-5 * max|C|``) against
  JAX ``gemm`` with ``mxu_dtype=float32`` in interpret mode (the same
  float32 weights, summed in another order);
* the plain GEMM rungs: ``1e-5 * max|C|`` against JAX's ``gemm_xla``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_gemm_tpu.formats import gguf as jgguf
from quant_gemm_tpu.formats import jax_quant as jq
from quant_gemm_tpu.formats import kquants as jk
from quant_gemm_tpu.formats import numpy_ref as jnr
from quant_gemm_tpu.kernels import gemm_xla as jx
from quant_gemm_tpu.kernels.gemm_exact import gemm_exact as j_gemm_exact
from quant_gemm_tpu.kernels.gemm_pallas import gemm as j_gemm
from quant_gemm_tpu.kernels.gemm_pallas import prepare as j_prepare
from quant_gemm_tpu.ref import gemm as jref
from quant_gemm_tpu_torch.formats import kquants as tk
from quant_gemm_tpu_torch.formats import numpy_ref as pnr
from quant_gemm_tpu_torch.formats import quant as tq
from quant_gemm_tpu_torch.formats.blocks import Q8_1Tensor
from quant_gemm_tpu_torch.kernels import layout, registry
from quant_gemm_tpu_torch.kernels.gemm_dequant import (gemm_dequant,
                                                       gemm_dequant_plain)
from quant_gemm_tpu_torch.kernels.gemm_exact import (FUSED_QTYPES,
                                                     gemm_exact,
                                                     gemm_exact_fused_plain,
                                                     gemm_exact_plain)
from quant_gemm_tpu_torch.kernels.gemm_megalayer import norm_qkv_plain
from quant_gemm_tpu_torch.models import convert
from quant_gemm_tpu_torch.ops.rms_norm import rms_norm
from quant_gemm_tpu_torch.ref import gemm as pref

NEW = ["q4_1", "q5_0", "q5_1", "q8_0"]
ALL = ["q4_0", *NEW]
M, N, K = 4, 384, 1024


def _inputs(kind: str, k: int = 1056) -> np.ndarray:
    """[6, k] float32 rows built to hit the quantizers' edge cases."""
    rng = np.random.default_rng({"normal": 0, "tiny": 1, "huge": 2,
                                 "ties": 3}[kind])
    x = rng.standard_normal((6, k)).astype(np.float32)
    if kind == "tiny":
        x *= np.float32(1e-6)  # f16-subnormal scales
    elif kind == "huge":
        x *= np.float32(1e7)  # saturating scales
    elif kind == "ties":
        x = (rng.integers(-63, 64, (6, k)) * 0.5).astype(np.float32)
        x[:, ::32] = 31.5
    x[0, :32] = 0.0  # all-zero block: d = 0, safe reciprocal
    x[1, 32:64] = 0.25  # constant block: max == min
    return x


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("kind", ["normal", "tiny", "huge", "ties"])
@pytest.mark.parametrize("qtype", NEW)
def test_torch_quantizers_bit_equal_to_jax(qtype, kind):
    x = _inputs(kind)
    t = tq.QUANTIZE[qtype](torch.from_numpy(x))
    golden = jnr.QUANTIZE[qtype](x)
    jt = jq.QUANTIZE[qtype](jnp.asarray(x))
    assert type(t).__name__ == type(golden).__name__
    for f, a, b, c in zip(golden._fields, golden, t, jt):
        np.testing.assert_array_equal(_np(b), a, err_msg=f)
        np.testing.assert_array_equal(np.asarray(c), a, err_msg=f)
    np.testing.assert_array_equal(tq.codes(t).numpy(), jnr.codes(golden))
    np.testing.assert_array_equal(tq.dequantize(t).numpy(),
                                  jnr.dequantize(golden))


@pytest.mark.parametrize("qtype", ALL + ["q8_1"])
def test_numpy_golden_copy_equals_jax(qtype):
    x = _inputs("normal")
    a, b = pnr.QUANTIZE[qtype](x), jnr.QUANTIZE[qtype](x)
    for f, u, v in zip(b._fields, a, b):
        np.testing.assert_array_equal(u, v, err_msg=f)
    np.testing.assert_array_equal(pnr.codes(a), jnr.codes(b))
    np.testing.assert_array_equal(pnr.dequantize(a), jnr.dequantize(b))
    bits = (x > 0).astype(np.uint8)
    np.testing.assert_array_equal(pnr.pack_planar_bits(bits),
                                  jnr.pack_planar_bits(bits))
    np.testing.assert_array_equal(
        tq.unpack_planar_bits(tq.pack_planar_bits(torch.from_numpy(bits))),
        bits)


KQ = {"q4_K": (jk.quantize_q4_k, tk.quantize_q4_k, jk.dequantize_q4_k,
               tk.dequantize_q4_k, jk.to_bytes, tk.to_bytes, tk.from_bytes),
      "q5_K": (jk.quantize_q5_k, tk.quantize_q5_k, jk.dequantize_q5_k,
               tk.dequantize_q5_k, jk.to_bytes_q5_k, tk.to_bytes_q5_k,
               tk.from_bytes_q5_k)}


@pytest.mark.parametrize("search", [True, False])
@pytest.mark.parametrize("qtype", list(KQ))
def test_kquant_encoders_and_codecs_bit_equal_to_jax(qtype, search):
    """The q4_K / q5_K encoders (with and without the qkx2 scale search),
    their dequantizers and GGUF bytes equal JAX's; the port's decoder
    takes JAX's bytes back to the same container."""
    jenc, tenc, jdeq, tdeq, jtob, ttob, tfromb = KQ[qtype]
    x = np.random.default_rng(5).uniform(-1, 1, (8, 1024)).astype(np.float32)
    x[0, :256] = 0.0
    x[1, :32] = 0.3
    jt, t = jenc(x, search=search), tenc(x, search=search)
    for f, a, b in zip(jt._fields, jt, t):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=f)
    np.testing.assert_array_equal(tdeq(t).numpy(), jdeq(jt))
    raw = jtob(jt)
    np.testing.assert_array_equal(ttob(t).numpy(), raw)
    for a, b in zip(t, tfromb(torch.from_numpy(raw))):
        assert torch.equal(a, b)


# GGUF block fields (ggml-common.h): byte ranges of d, m, qh, qs per block
GGUF_FIELDS = {"q4_0": {"d": (0, 2), "qs": (2, 18)},
               "q4_1": {"d": (0, 2), "m": (2, 4), "qs": (4, 20)},
               "q5_0": {"d": (0, 2), "qh": (2, 6), "qs": (6, 22)},
               "q5_1": {"d": (0, 2), "m": (2, 4), "qh": (4, 8),
                        "qs": (8, 24)},
               "q8_0": {"d": (0, 2), "qs": (2, 34)}}


@pytest.mark.parametrize("qtype", ALL)
def test_layout_is_the_gguf_blocks(qtype):
    """Each plane of a prepared weight holds exactly its field of
    llama.cpp's blocks (JAX's byte-exact GGUF serializer): codes in block
    order, q5's qh words with bit j the 5th bit of code j; codes and
    dequantized values equal the golden's."""
    x = _inputs("normal")
    t = tq.QUANTIZE[qtype](torch.from_numpy(x))
    pw = layout.prepare(t)
    raw = jgguf.to_bytes(jnr.QUANTIZE[qtype](x))  # [6, nb, block bytes]
    n, nb = raw.shape[:2]
    for field, (lo, hi) in GGUF_FIELDS[qtype].items():
        plane = getattr(pw, field)
        got = plane.contiguous().view(torch.uint8).numpy().reshape(n, nb, -1)
        np.testing.assert_array_equal(got, raw[:, :, lo:hi], err_msg=field)
    assert (pw.m is None) == ("m" not in GGUF_FIELDS[qtype])
    assert (pw.qh is None) == ("qh" not in GGUF_FIELDS[qtype])
    golden = jnr.QUANTIZE[qtype](x)
    np.testing.assert_array_equal(layout.codes(pw).numpy().astype(np.int32),
                                  jnr.codes(golden))
    np.testing.assert_array_equal(layout.dequantize(pw).numpy(),
                                  jnr.dequantize(golden))


@pytest.mark.parametrize("k", [1024, 640])
@pytest.mark.parametrize("qtype", ALL + ["q4_k"])
def test_planar_from_jax_gives_the_ports_prepare(qtype, k):
    """A JAX PreparedWeight (K-major, x8 bytes, padded, planar qh bits)
    comes back as the port's own layout of the same container."""
    x = np.random.default_rng(7).normal(0, 0.05, (300, k)).astype(np.float32)
    if qtype == "q4_k":
        jt = jk.quantize_q4_k(x[:, :512] if k % 256 else x)
        jc = jk.to_effective(jt)
        want = layout.prepare(tk.to_effective(tk.Q4_KTensor(
            *(torch.from_numpy(np.asarray(a)) for a in jt))))
    else:
        jc = jnr.QUANTIZE[qtype](x)
        want = layout.prepare(tq.QUANTIZE[qtype](torch.from_numpy(x)))
    jw = jax.tree_util.tree_map(np.asarray, j_prepare(jc))
    pc = convert.planar_from_jax(jw)
    got = layout.prepare(type(pc)(*(torch.tensor(a) for a in pc)))
    assert got.qtype == want.qtype and (got.n, got.k) == (want.n, want.k)
    for f in ("qs", "d", "m", "qh"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.fixture(scope="module")
def gemm_inputs():
    """Weights in every per-32 format (the golden's numpy containers, the
    JAX prepared layout, the port's) and a Q8_1 activation, (4, 384,
    1024)."""
    rng = np.random.default_rng(11)
    w = rng.normal(0, 0.05, (N, K)).astype(np.float32)
    a = rng.standard_normal((M, K)).astype(np.float32)
    out = {}
    for q in ALL:
        wq = jnr.QUANTIZE[q](w)
        out[q] = (wq, j_prepare(wq),
                  layout.prepare(tq.QUANTIZE[q](torch.from_numpy(w))))
    out["w"] = w
    a8 = jnr.quantize_q8_1(a)
    return out, a, a8, Q8_1Tensor(*(torch.from_numpy(np.asarray(t))
                                    for t in a8))


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("qtype", NEW)
def test_gemm_exact_plain_matches_golden_and_jax(gemm_inputs, qtype):
    """K1's new epilogues: q5_0 d_w(d_a sumi - 16 s_a), q4_1/q5_1 d_w d_a
    sumi + m_w s_a, q8_0 d_w d_a sumi (signed codes)."""
    weights, a, a8, a8_t = gemm_inputs
    wq, jw, pw = weights[qtype]
    w = weights["w"]
    got = gemm_exact(pw, a8_t).numpy()
    golden = jref.gemm_wxa8(wq, a8)
    _close(got, golden, 1e-6)
    _close(got, j_gemm_exact(jw, jq.device_put(a8)), 1e-5)
    # the port's copy of the golden, on its own containers
    np.testing.assert_array_equal(
        pref.gemm_wxa8(pnr.QUANTIZE[qtype](w), pnr.quantize_q8_1(a)), golden)


@pytest.mark.parametrize("act", ["float32", "q8_1"])
@pytest.mark.parametrize("qtype", NEW)
def test_gemm_dequant_f32_plain_matches_jax(gemm_inputs, qtype, act):
    """K4's float32-activation form against JAX ``gemm`` with
    ``mxu_dtype=float32`` (a Q8_1 activation folded to float32 by both)."""
    weights, a, a8, a8_t = gemm_inputs
    _, jw, pw = weights[qtype]
    if act == "q8_1":
        got = registry.LADDER["pallas_f32"](pw, a8_t).numpy()
        want = j_gemm(jw, jq.device_put(a8), mxu_dtype=jnp.float32)
    else:
        got = gemm_dequant(pw, torch.from_numpy(a)).numpy()
        want = j_gemm(jw, jnp.asarray(a), mxu_dtype=jnp.float32)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("qtype", NEW)
def test_gemm_dequant_bf16_plain_form(gemm_inputs, qtype):
    """K4's bf16 form: the bf16 activation times the float32-dequantized
    weight, the serving prefill's numbers (JAX rounds the weight to bf16
    too in its bf16 modes; the port keeps it in float32)."""
    weights, a, _, _ = gemm_inputs
    _, _, pw = weights[qtype]
    ab = torch.from_numpy(a).to(torch.bfloat16)
    got = gemm_dequant(pw, ab)
    want = ab.double() @ torch.from_numpy(
        jnr.dequantize(weights[qtype][0])).double().T
    _close(got.numpy(), want.numpy(), 1e-5)


@pytest.mark.parametrize("rung", ["xla_dequant", "xla_compensated",
                                  "xla_int"])
@pytest.mark.parametrize("qtype", ALL)
def test_plain_gemm_rungs_match_jax(gemm_inputs, qtype, rung):
    weights, _, a8, a8_t = gemm_inputs
    wq = weights[qtype][0]
    tw = type(tq.QUANTIZE[qtype](torch.zeros(1, 32)))(
        *(torch.from_numpy(np.asarray(t)) for t in wq))
    got = registry.LADDER[rung](tw, a8_t).numpy()
    jfn = {"xla_dequant": jx.gemm_wxa8_scaled_xla,
           "xla_compensated": jx.gemm_wxa8_compensated_xla,
           "xla_int": jx.gemm_wxa8_int_xla}[rung]
    jw = jq.device_put(wq)
    _close(got, jfn(jw, jq.device_put(a8)), 1e-5)
    if rung == "xla_int":
        _close(got, jref.gemm_wxa8(wq, a8), 1e-6)


def test_ladder_refuses_what_it_does_not_take(gemm_inputs):
    """Each rung refuses the activation kind it does not take, and K6 the
    forms with a qh plane (the JAX dispatch keeps them on quantize + K1);
    the K4 fused_quant and K6 q8_0 rungs run (slice 7)."""
    weights, a, _, a8_t = gemm_inputs
    pw = weights["q8_0"][2]
    x = torch.from_numpy(a)
    with pytest.raises(TypeError):
        registry.LADDER["pallas_fused_quant"](pw, a8_t)
    with pytest.raises(TypeError):
        registry.LADDER["pallas_exact"](pw, x)
    with pytest.raises(TypeError):
        registry.LADDER["pallas_exact_fused"](pw, a8_t)
    with pytest.raises(NotImplementedError, match="qh plane"):
        registry.LADDER["pallas_exact_fused"](weights["q5_0"][2], x)
    torch.testing.assert_close(
        registry.LADDER["pallas_exact_fused"](pw, x),
        gemm_exact_plain(pw, tq.quantize_q8_1(x)), rtol=0, atol=0)
    assert registry.LADDER["pallas_fused_quant"](pw, x).shape == \
        (x.shape[0], pw.n)


@pytest.mark.parametrize("m, route", [(1, "gemm_exact"), (12, "gemm_exact"),
                                      (13, "gemm_dequant")])
@pytest.mark.parametrize("qtype", NEW)
def test_dispatch_takes_the_new_formats(gemm_inputs, monkeypatch, qtype, m,
                                        route):
    """Decode rows take K1, prefill rows K4 on the bf16 fold; with
    FUSED_DECODE a form K6 lacks keeps quantize + K1 (bit-identical)."""
    weights, _, _, _ = gemm_inputs
    pw = weights[qtype][2]
    x = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (m, K)).astype(np.float32))
    monkeypatch.setattr(registry, "FUSED_DECODE", True)
    got = registry.dispatch(pw, x, quantize_act=True, ops=registry.PLAIN)
    act = tq.quantize_q8_1(x)
    want = (gemm_exact_plain(pw, act) if route == "gemm_exact"
            else gemm_dequant_plain(pw, registry.fold_q8_1(act)))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- K % 64 == 32 (K = 1056): the port's layout takes any K % 32 == 0 ---

K33 = 1056


@pytest.fixture(scope="module")
def k1056():
    rng = np.random.default_rng(33)
    w = rng.normal(0, 0.05, (256, K33)).astype(np.float32)
    x = (rng.standard_normal((8, K33)) * 2).astype(np.float32)
    return w, x


@pytest.mark.parametrize("qtype", ALL + ["q4_k"])
def test_k1_k4_k6_at_k_1056_match_the_golden(k1056, qtype):
    w, x = k1056
    if qtype == "q4_k":
        # the effective form at K % 256 != 0 (a q4_K tensor itself needs
        # K % 256 == 0): q4_1's blocks with f32 planes take its kernel path
        wq = jnr.quantize_q4_1(w)
        pw = layout.prepare(tk.EffectiveQ41(
            torch.from_numpy(wq.packed), torch.from_numpy(
                wq.d.astype(np.float32)), torch.from_numpy(
                    wq.m.astype(np.float32))))
    else:
        wq = jnr.QUANTIZE[qtype](w)
        pw = layout.prepare(tq.QUANTIZE[qtype](torch.from_numpy(w)))
    a8 = jnr.quantize_q8_1(x)
    a8_t = tq.quantize_q8_1(torch.from_numpy(x))
    _close(gemm_exact(pw, a8_t).numpy(), jref.gemm_wxa8(wq, a8), 1e-6)
    _close(gemm_dequant(pw, torch.from_numpy(x)).numpy(),
           jref.gemm_wxa16(x, wq), 1e-5)
    if qtype in FUSED_QTYPES:
        _close(gemm_exact_fused_plain(pw, torch.from_numpy(x)).numpy(),
               jref.gemm_wxa8(wq, a8), 1e-6)


def test_k2_at_k_1056_matches_the_golden(k1056):
    """K2 (RMSNorm + Q8_1 + the exact q4_0 wqkv) at K = 1056 against
    the golden chain: the port's RMSNorm, numpy Q8_1, ``gemm_wxa8``."""
    w, x = k1056
    nw = np.random.default_rng(34).normal(1, 0.1, K33).astype(np.float32)
    pw = layout.prepare(tq.quantize_q4_0(torch.from_numpy(w)))
    got = norm_qkv_plain(pw, torch.from_numpy(x), torch.from_numpy(nw), 1e-5)
    h = rms_norm(torch.from_numpy(x), torch.from_numpy(nw), 1e-5).numpy()
    want = jref.gemm_wxa8(jnr.quantize_q4_0(w), jnr.quantize_q8_1(h))
    _close(got.numpy(), want, 1e-6)
