"""The port's host block codec (``quant_gemm_tpu_torch/native.py``, its own
``csrc/host/blockcodec.cpp`` built with g++ into ``build/``): the JAX
package's ``tests/test_native.py`` cases on the port's codec, bit for bit
against the port's numpy and torch codecs and JAX's ``numpy_ref`` /
``kquants`` on the same bytes; the port's K-quant byte decoders (one
torch decode, which never builds the codec) against it, bit for bit."""

from __future__ import annotations

import time
import unittest.mock as mock

import numpy as np
import pytest
import torch

from quant_gemm_tpu import native as jnative
from quant_gemm_tpu.formats import gguf as jgguf
from quant_gemm_tpu.formats import kquants as jk
from quant_gemm_tpu.formats import numpy_ref as jnr
from quant_gemm_tpu_torch import native
from quant_gemm_tpu_torch.formats import gguf, kquants
from quant_gemm_tpu_torch.formats import numpy_ref as tnr
from quant_gemm_tpu_torch.formats import quant as tq
from quant_gemm_tpu_torch.harness import datagen
from quant_gemm_tpu_torch.kernels import _build


@pytest.fixture(scope="module", autouse=True)
def codec():
    if not native.available():
        pytest.skip("no C++ compiler on PATH")


@pytest.fixture(scope="module")
def x():
    return datagen.normal((16, 512), seed=5)


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint8)


def _same(got, want, what=""):
    assert len(got) == len(want), what
    for f, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"{what}.{f}")


def test_codec_builds_outside_the_tracked_tree():
    path, flags = native.library()
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert path.name.startswith("blockcodec-") and path.suffix == ".so"
    assert flags[:len(native.CXX_FLAGS)] == native.CXX_FLAGS
    assert native.SOURCE.parent.name == "host"
    assert native.k16_available() and native.q6k_available()


def test_codec_builds_without_openmp_where_it_cannot_link(monkeypatch,
                                                          tmp_path):
    """A toolchain that cannot take the OpenMP flag (the H100 machine's
    g++ has no libgomp.spec) builds the codec without it: the same bits."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_path", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "OPENMP", "-fno-such-openmp-flag")
    assert native.available()
    path, flags = native.library()
    assert flags == native.CXX_FLAGS and path.parent == tmp_path
    x = datagen.normal((4, 256), seed=9)
    _same(native.quantize_q8_1(x), tnr.quantize_q8_1(x), "q8_1")


@pytest.mark.parametrize("fmt", ["q4_0", "q8_0", "q8_1"])
def test_native_quantize_bitexact(fmt, x):
    t_c = getattr(native, f"quantize_{fmt}")(x)
    _same(t_c, tnr.QUANTIZE[fmt](x), fmt)
    _same(t_c, jnr.QUANTIZE[fmt](x), fmt)  # JAX's numpy golden
    _same(t_c, tq.QUANTIZE[fmt](torch.from_numpy(x)), fmt)  # torch codec
    _same(getattr(native, f"quantize_{fmt}")(torch.from_numpy(x)), t_c, fmt)


@pytest.mark.parametrize("fmt", ["q4_0", "q8_0", "q8_1"])
def test_native_dequantize_bitexact(fmt, x):
    t = native.__dict__[f"quantize_{fmt}"](x)
    got = native.dequantize(t)
    np.testing.assert_array_equal(got.numpy(), tq.dequantize(t).numpy())
    np.testing.assert_array_equal(
        got.numpy(), jnr.dequantize(jnr.QUANTIZE[fmt](x)))


def test_native_aos_repack_bitexact(x):
    t = native.quantize_q4_0(x)
    aos_c = native.q4_0_to_aos(t)
    np.testing.assert_array_equal(aos_c.numpy(), gguf.to_bytes(t).numpy())
    np.testing.assert_array_equal(aos_c.numpy(),
                                  jgguf.to_bytes(jnr.quantize_q4_0(x)))
    _same(native.q4_0_from_aos(aos_c), t, "q4_0")
    _same(native.q4_0_from_aos(aos_c.numpy()),
          gguf.from_bytes(aos_c, "q4_0"), "q4_0")


def test_native_faster_than_numpy():
    """The point of the codec: bulk conversion speed (a sanity bound, not
    a ratio)."""
    big = datagen.normal((256, 4096), seed=6)
    t0 = time.perf_counter()
    native.quantize_q4_0(big)
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    tnr.quantize_q4_0(big)
    t_np = time.perf_counter() - t0
    assert t_c < 5.0 and t_np < 30.0, (t_c, t_np)


def _jax_numpy(fn, raw, check):
    with mock.patch.object(jnative, check, lambda: False):
        return fn(raw)


KQ = [("q4_k", 144, "q4_k_from_aos", kquants.from_bytes, jk.from_bytes,
       "kquants_available"),
      ("q5_k", 176, "q5_k_from_aos", kquants.from_bytes_q5_k,
       jk.from_bytes_q5_k, "kquants_available"),
      ("q6_k", 210, "q6_k_from_aos", kquants.from_bytes_q6_k,
       jk.from_bytes_q6_k, "q6k_available"),
      ("q2_k", 84, "q2_k_from_aos", kquants.from_bytes_q2_k,
       jk.from_bytes_q2_k, "k16_available"),
      ("q3_k", 110, "q3_k_from_aos", kquants.from_bytes_q3_k,
       jk.from_bytes_q3_k, "k16_available")]


@pytest.mark.parametrize("qt, nbytes, nat, port, jax_fn, check", KQ,
                         ids=[k[0] for k in KQ])
def test_native_kquant_decode_bitexact(qt, nbytes, nat, port, jax_fn, check):
    """Random bytes (every scale-packing, nibble, code-group and hmask
    path): the codec, the port's torch decode and JAX's numpy decode, bit
    for bit."""
    raw = np.random.default_rng(40 + nbytes).integers(
        0, 256, (16, 4, nbytes)).astype(np.uint8)
    got = getattr(native, nat)(raw)
    _same(got, port(torch.from_numpy(raw)), qt)
    _same(got, _jax_numpy(jax_fn, raw, check), qt)


def test_native_kquant_roundtrip_through_encoder():
    """quantize_q4_k / q5_k / q6_k -> to_bytes -> codec == the original
    container."""
    x = datagen.normal((8, 512), seed=41)
    for enc, to_bytes, dec in (
            (kquants.quantize_q4_k, kquants.to_bytes, native.q4_k_from_aos),
            (kquants.quantize_q5_k, kquants.to_bytes_q5_k,
             native.q5_k_from_aos),
            (kquants.quantize_q6_k, kquants.to_bytes_q6_k,
             native.q6_k_from_aos)):
        t = enc(x)
        _same(dec(to_bytes(t)), t, enc.__name__)


@pytest.mark.parametrize("qt, nbytes, nat, port, jax_fn, check", KQ,
                         ids=[k[0] for k in KQ])
def test_kquant_decoders_need_no_codec(monkeypatch, qt, nbytes, nat, port,
                                       jax_fn, check):
    """The port's byte decoders never load the codec: with its build
    failing they decode CPU bytes, to the codec's bits."""
    raw = np.random.default_rng(3 + nbytes).integers(
        0, 256, (4, 2, nbytes)).astype(np.uint8)
    want = getattr(native, nat)(raw)

    def no_codec():
        raise RuntimeError("building the block codec failed")

    monkeypatch.setattr(native, "_load", no_codec)
    _same(port(torch.from_numpy(raw)), want, qt)


def test_unavailable_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_path", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.delenv("CXX", raising=False)
    assert not native.available() and not native.kquants_available()
    with pytest.raises(native.NativeUnavailable):
        native.quantize_q4_0(np.zeros((1, 32), np.float32))
    assert not list(tmp_path.iterdir())


def test_a_failing_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_path", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="building the block codec"):
        native.available()
    assert [p.name for p in tmp_path.iterdir()] == ["bad.cpp"]


def test_shapes_are_checked(x):
    with pytest.raises(ValueError, match="K % 32"):
        native.quantize_q4_0(np.zeros((2, 33), np.float32))
    with pytest.raises(ValueError, match="144"):
        native.q4_k_from_aos(np.zeros((2, 1, 143), np.uint8))
    with pytest.raises(TypeError, match="dequantizes"):
        native.dequantize(tq.quantize_q4_1(torch.from_numpy(x)))
