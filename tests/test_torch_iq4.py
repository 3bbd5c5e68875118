"""IQ4_NL and IQ4_XS tensors in the port against the JAX package, on the
CPU: the byte codecs, the IQ4_NL encoder, the GGUF reader and writer, the
layout of the ``iq4_xs`` form, and the plain versions of its K1, K4 and
K6 forms.

Tolerances: the containers, bytes and layouts are bit-equal (the codecs
move bits through an int8 codebook; ``d * (sc - 32)`` is exact in
float32).  The GEMMs: NMSE < 1e-10 against ``ref/gemm.py::gemm_wxa8``,
the yardstick of JAX's ``tests/test_kquants.py::
test_iq4_xs_decode_and_kernel``; K1 and K6 also against JAX's exact
kernel (interpret mode) at 1e-5 x max|C| (float32 summation order); K4
against JAX's ``gemm`` (float32 operand) at 1e-5 x max|C|, as the other
per-32 forms are held; K6 bit for bit against quantize + K1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_gemm_tpu.formats import gguf_file as jgf
from quant_gemm_tpu.formats import jax_quant as jq
from quant_gemm_tpu.formats import kquants as jk
from quant_gemm_tpu.formats import numpy_ref as jnr
from quant_gemm_tpu.kernels.gemm_exact import gemm_exact as j_gemm_exact
from quant_gemm_tpu.kernels.gemm_exact import (gemm_exact_fused as
                                               j_gemm_exact_fused)
from quant_gemm_tpu.kernels.gemm_pallas import prepare as j_prepare
from quant_gemm_tpu.ref import gemm as jref
from quant_gemm_tpu_torch.formats import gguf_file as tgf
from quant_gemm_tpu_torch.formats import kquants as tk
from quant_gemm_tpu_torch.formats import quant as tq
from quant_gemm_tpu_torch.formats.blocks import Q8_0Tensor
from quant_gemm_tpu_torch.kernels import layout, registry
from quant_gemm_tpu_torch.kernels.gemm_dequant import gemm_dequant
from quant_gemm_tpu_torch.kernels.gemm_exact import (FUSED_QTYPES,
                                                     gemm_exact,
                                                     gemm_exact_fused,
                                                     gemm_exact_plain)
from quant_gemm_tpu_torch.models import convert
from quant_gemm_tpu_torch.models import gguf_loader as tgl


def _raw_xs(n=256, nsb=2, seed=3):
    """Random block_iq4_xs bytes, d kept finite (JAX's test draws them
    so)."""
    raw = np.random.default_rng(seed).integers(0, 256, (n, nsb, 136),
                                               dtype=np.uint8)
    raw[:, :, 1] &= 0x3B
    return raw


def _raw_nl(n=64, k=256, seed=4):
    x = np.random.default_rng(seed).normal(0, 1, (n, k)).astype(np.float32)
    x[0, :32] = 0.0  # an all-zero block: d = 0
    x[1, 32:64] *= 1e-6
    return jk.quantize_iq4_nl(x), x


def _nmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return ((got - want) ** 2).sum() / (want ** 2).sum()


def test_iq4_nl_encoder_bit_equal_to_jax():
    raw, x = _raw_nl()
    np.testing.assert_array_equal(
        tk.quantize_iq4_nl(torch.from_numpy(x)).numpy(), raw)


def test_iq4_nl_container_bit_equal_to_jax():
    raw, _ = _raw_nl()
    want = jk.from_bytes_iq4_nl(raw)
    got = tk.from_bytes_iq4_nl(torch.from_numpy(raw))
    assert isinstance(got, Q8_0Tensor)
    np.testing.assert_array_equal(got.qs.numpy(), np.asarray(want.qs))
    np.testing.assert_array_equal(got.d.numpy(), np.asarray(want.d))
    np.testing.assert_array_equal(tk.dequantize_iq4(got).numpy(),
                                  jk.dequantize_iq4_nl_bytes(raw))


def test_iq4_xs_container_bit_equal_to_jax():
    raw = _raw_xs()
    want = jk.from_bytes_iq4_xs(raw)
    got = tk.from_bytes_iq4_xs(torch.from_numpy(raw))
    assert isinstance(got, tk.EffectiveQ80) and got.d.dtype == torch.float32
    np.testing.assert_array_equal(got.qs.numpy(), np.asarray(want.qs))
    np.testing.assert_array_equal(got.d.numpy(),
                                  np.asarray(want.d, np.float32))
    np.testing.assert_array_equal(tk.dequantize_iq4(got).numpy(),
                                  jk.dequantize_iq4_xs_bytes(raw))


@pytest.mark.parametrize("qtype", ["iq4_nl", "iq4_xs"])
def test_gguf_round_trip_equals_jax(qtype, tmp_path):
    """Each writer writes the other's bytes; each reader reads them into
    equal containers."""
    raw = _raw_xs() if qtype == "iq4_xs" else _raw_nl()[0]
    shape = (raw.shape[0], raw.shape[1] * (256 if qtype == "iq4_xs"
                                           else 32))
    pj, pt = tmp_path / "j.gguf", tmp_path / "t.gguf"
    jgf.write_gguf(str(pj), {"w.weight": jgf.RawTensor(qtype, shape,
                                                       raw.tobytes())})
    tgf.write_gguf(pt, {"w.weight": tgf.RawTensor(
        qtype, shape, torch.from_numpy(raw.reshape(-1)))})
    assert pt.read_bytes() == pj.read_bytes()
    want = jgf.GGUFFile(str(pj)).load("w.weight")
    got = tgf.GGUFFile(pt).load("w.weight", "cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(b, a.numpy().dtype))
    with pytest.raises(ValueError, match="bytes"):
        tgf.RawTensor(qtype, shape, raw.tobytes()[:-1])


def test_iq4_xs_layout_and_convert_equal_jax():
    """``layout.prepare`` of the effective form: q8_0's layout with
    float32 scales, equal to the port's reading of JAX's prepared iq4_xs
    weight (``convert.planar_from_jax``); iq4_nl prepares as q8_0."""
    raw = _raw_xs()
    pw = layout.prepare(tk.from_bytes_iq4_xs(torch.from_numpy(raw)))
    assert pw.qtype == "iq4_xs" and pw.qs.dtype == torch.int8
    assert pw.d.dtype == torch.float32 and pw.m is None and pw.qh is None
    np.testing.assert_array_equal(layout.codes(pw).numpy(),
                                  np.asarray(jk.from_bytes_iq4_xs(raw).qs))
    np.testing.assert_array_equal(layout.dequantize(pw).numpy(),
                                  jk.dequantize_iq4_xs_bytes(raw))
    jw = jax.tree_util.tree_map(np.asarray,
                                j_prepare(jk.from_bytes_iq4_xs(raw)))
    p = convert.planar_from_jax(jw)
    assert isinstance(p, tk.EffectiveQ80)
    back = layout.prepare(tk.EffectiveQ80(*(torch.from_numpy(
        np.ascontiguousarray(x)) for x in p)))
    for a, b in zip(pw[3:], back[3:]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b)
    nl = layout.prepare(tk.from_bytes_iq4_nl(torch.from_numpy(_raw_nl()[0])))
    assert nl.qtype == "q8_0" and nl.d.dtype == torch.float16
    assert "iq4_xs" in FUSED_QTYPES and "iq4_xs" in layout.F32_PLANES


def _iq4_xs_case(m=4, k=512, seed=11):
    raw = _raw_xs(n=256, nsb=k // 256)
    jc = jk.from_bytes_iq4_xs(raw)
    pw = layout.prepare(tk.from_bytes_iq4_xs(torch.from_numpy(raw)))
    a = np.random.default_rng(seed).standard_normal((m, k)).astype(
        np.float32)
    return jc, pw, a


def test_iq4_xs_k1_plain_within_jax_yardstick():
    """JAX's ``test_iq4_xs_decode_and_kernel``: the exact GEMM against
    ``gemm_wxa8`` at NMSE < 1e-10; and against JAX's ``gemm_exact``."""
    jc, pw, a = _iq4_xs_case()
    a8 = jnr.quantize_q8_1(a)
    got = gemm_exact(pw, tq.quantize_q8_1(torch.from_numpy(a))).numpy()
    assert _nmse(got, jref.gemm_wxa8(jc, a8)) < 1e-10
    want = np.asarray(j_gemm_exact(j_prepare(jc), jq.device_put(a8)))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # the dispatch takes the iq4_xs weight on the K1 route (M <= 12)
    routed = registry.dispatch(pw, torch.from_numpy(a), quantize_act=True)
    torch.testing.assert_close(routed, torch.from_numpy(got), rtol=0,
                               atol=0)


def test_iq4_xs_k6_plain_bit_equal_to_quantize_and_k1():
    """K6's iq4_xs form (JAX's ``_kernel_w8_fused`` takes every weight
    without a qh plane): quantize + K1 bit for bit, degenerate blocks
    included, and JAX's ``gemm_exact_fused`` to 1e-5 x max|C|."""
    jc, pw, a = _iq4_xs_case(m=8, seed=12)
    a[0, :32], a[-1, 32:64] = 0.0, 7e8
    x = torch.from_numpy(a)
    got = gemm_exact_fused(pw, x)
    torch.testing.assert_close(got, gemm_exact_plain(pw, tq.quantize_q8_1(x)),
                               rtol=0, atol=0)
    want = np.asarray(j_gemm_exact_fused(j_prepare(jc), jnp.asarray(a)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    assert _nmse(got.numpy(), jref.gemm_wxa8(jc, jnr.quantize_q8_1(a))) \
        < 1e-10


def test_iq4_xs_k4_plain_matches_jax():
    """K4's iq4_xs form: with a float32 operand against JAX's ``gemm`` at
    ``mxu_dtype=float32`` (1e-5 x max|C|); with the serving prefill's
    bf16 operand (the Q8_1 activation folded, M > 12) as the bf16
    activation times the float32 dequantized weight, in float64 (JAX's
    bf16 modes round the weight to bf16 too, the port keeps it in
    float32), 1e-5 x max|C|; the golden on the Q8_1 codes within the
    bf16 operand's NMSE."""
    from quant_gemm_tpu.kernels.gemm_pallas import gemm as j_gemm

    jc, pw, a = _iq4_xs_case(m=32, seed=13)
    got = gemm_dequant(pw, torch.from_numpy(a)).numpy()
    want = np.asarray(j_gemm(j_prepare(jc), jnp.asarray(a),
                             mxu_dtype=jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    a8 = jnr.quantize_q8_1(a)
    fold = registry.fold_q8_1(tq.quantize_q8_1(torch.from_numpy(a)))
    got = gemm_dequant(pw, fold).numpy()
    want = fold.double() @ torch.from_numpy(
        jk.dequantize_iq4_xs_bytes(_raw_xs(n=256, nsb=2))).double().T
    np.testing.assert_allclose(got, want.numpy(), rtol=0,
                               atol=1e-5 * np.abs(want.numpy()).max())
    assert _nmse(got, jref.gemm_wxa8(jc, a8)) < 1e-4
    routed = registry.dispatch(pw, torch.from_numpy(a), quantize_act=True)
    torch.testing.assert_close(routed, torch.from_numpy(got), rtol=0,
                               atol=0)


def test_loader_serves_iq4_tensors_as_jax():
    """``gguf_loader._prep`` lays iq4_nl out as q8_0 and iq4_xs in its
    own form, as JAX's ``_prep`` does."""
    raw_nl, _ = _raw_nl()
    nl = tgl._prep(tk.from_bytes_iq4_nl(torch.from_numpy(raw_nl)))
    xs = tgl._prep(tk.from_bytes_iq4_xs(torch.from_numpy(_raw_xs())))
    assert (nl.qtype, xs.qtype) == ("q8_0", "iq4_xs")
    np.testing.assert_array_equal(
        layout.dequantize(nl).numpy(), jk.dequantize_iq4_nl_bytes(raw_nl))
    emb = tgl._dequantize(tk.from_bytes_iq4_xs(torch.from_numpy(_raw_xs())))
    np.testing.assert_array_equal(emb.numpy(),
                                  jk.dequantize_iq4_xs_bytes(_raw_xs()))


def test_random_iq4_blocks_are_valid():
    g = torch.Generator().manual_seed(0)
    for qtype in ("iq4_nl", "iq4_xs"):
        raw = tk.random_iq4(qtype, 64, 512, 0.05, g)
        dec = (tk.from_bytes_iq4_xs if qtype == "iq4_xs"
               else tk.from_bytes_iq4_nl)(raw)
        x = tk.dequantize_iq4(dec)
        assert torch.isfinite(x).all()
        assert 0.03 < float(x.std()) < 0.08
        # mean about 0 (a sign on every scale), not the codebook's -5.9/69
        # of the standard deviation
        assert abs(float(x.mean())) < 0.03 * float(x.std()), qtype
        want = (jk.dequantize_iq4_xs_bytes if qtype == "iq4_xs"
                else jk.dequantize_iq4_nl_bytes)(raw.numpy())
        np.testing.assert_array_equal(x.numpy(), want)
