"""The port's K-quant containers and byte codecs against the JAX package's
``formats/kquants.py``, on the CPU.

Every comparison is bit-equal: the codecs move bits, ``to_effective`` and
``scp``/``mp`` are exact float32 products of the same operands, and the
dequantizers round the same float32 operations in the same order.  Inputs:
the tensors of ``tests/golden/tiny_llama_q4km.gguf`` (bytes written by an
independent generator), random bytes (every bit pattern of the scale and
code fields; f16 fields may hold inf or NaN, compared bit for bit), and
containers from the JAX encoders.
"""

import pathlib

import numpy as np
import pytest
import torch

from quant_gemm_tpu.formats import kquants as jk
from quant_gemm_tpu.formats.gguf_file import GGUFFile as JGGUFFile
from quant_gemm_tpu_torch.formats import kquants as tk

FIXTURE = pathlib.Path(__file__).parent / "golden" / "tiny_llama_q4km.gguf"

# GGUF type -> (JAX decoder, JAX encoder, JAX dequantizer)
JAX = {
    "q4_K": (jk.from_bytes, jk.to_bytes, jk.dequantize_q4_k),
    "q6_K": (jk.from_bytes_q6_k, jk.to_bytes_q6_k, jk.dequantize_q6_k),
    "q2_K": (jk.from_bytes_q2_k, jk.to_bytes_q2_k, jk.dequantize_q2_k),
    "q3_K": (jk.from_bytes_q3_k, jk.to_bytes_q3_k, jk.dequantize_q3_k),
}
JAX_QUANTIZE = {"q4_K": jk.quantize_q4_k, "q6_K": jk.quantize_q6_k,
                "q2_K": jk.quantize_q2_k, "q3_K": jk.quantize_q3_k}


def _bits(x) -> np.ndarray:
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint8).reshape(-1)


def _assert_same_container(j, t):
    """Same fields, dtypes and bits (torch container ``t``, numpy ``j``)."""
    assert type(t).__name__ == type(j).__name__
    assert t._fields == j._fields
    for name in j._fields:
        a, b = np.asarray(getattr(j, name)), getattr(t, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


def _assert_same_floats(a, b):
    np.testing.assert_array_equal(_bits(np.asarray(a, np.float32)),
                                  _bits(b.numpy()))


def _scales_and_deq(qt, j, t):
    """to_effective (q4_K) or scp/mp (per-16), and the dequantized
    values, bit-equal."""
    with np.errstate(all="ignore"):
        if qt == "q4_K":
            ej, et = jk.to_effective(j), tk.to_effective(t)
            _assert_same_floats(ej.d, et.d)
            _assert_same_floats(ej.m, et.m)
            np.testing.assert_array_equal(_bits(ej.packed), _bits(et.packed))
        else:
            _assert_same_floats(j.scp, t.scp)
            jmp = getattr(j, "mp", None)  # JAX's Q6_KTensor has none
            assert (jmp is None) == (t.mp is None)
            if jmp is not None:
                _assert_same_floats(jmp, t.mp)
        _assert_same_floats(JAX[qt][2](j), tk.DEQUANT[type(t)](t))


_FIXTURE_TENSORS = [n for n, info in JGGUFFile(FIXTURE).tensors.items()
                    if info["qtype"] in JAX]


@pytest.fixture(scope="module")
def fixture_file():
    return JGGUFFile(FIXTURE)


@pytest.mark.parametrize("name", _FIXTURE_TENSORS)
def test_fixture_tensor_decodes_as_jax(fixture_file, name):
    """Foreign bytes: every q4_K / q6_K tensor of the fixture decodes to
    the JAX container, and encodes back to its bytes."""
    qt = fixture_file.tensors[name]["qtype"]
    dec, enc, _ = JAX[qt]
    nbytes, tdec, tenc = tk.CODECS[qt]
    raw = np.array(fixture_file.raw(name))
    n, k = fixture_file.tensors[name]["shape"]
    aos = raw.reshape(n, k // tk.QK_K, nbytes)
    j, t = dec(aos), tdec(torch.from_numpy(aos))
    _assert_same_container(j, t)
    _scales_and_deq(qt, j, t)
    np.testing.assert_array_equal(tenc(t).numpy(), aos)
    np.testing.assert_array_equal(enc(j), aos)


@pytest.mark.parametrize("qt", list(JAX))
def test_random_bytes_decode_as_jax_and_round_trip(qt):
    """Every bit pattern: uniform random bytes (scale fields included)."""
    nbytes, tdec, tenc = tk.CODECS[qt]
    raw = np.random.default_rng(len(qt) + nbytes).integers(
        0, 256, (6, 4, nbytes), dtype=np.uint8)
    j, t = JAX[qt][0](raw), tdec(torch.from_numpy(raw))
    _assert_same_container(j, t)
    _scales_and_deq(qt, j, t)
    np.testing.assert_array_equal(tenc(t).numpy(), raw)


@pytest.mark.parametrize("qt", list(JAX))
def test_jax_encoded_containers_serialize_as_jax(qt):
    """Containers from the JAX encoders (q4_K with its weighted scale
    search) carried into torch serialize to the JAX bytes."""
    x = np.random.default_rng(7).normal(0, 0.05, (8, 512)).astype(np.float32)
    j = JAX_QUANTIZE[qt](x)
    t = getattr(tk, type(j).__name__)(
        *(torch.from_numpy(np.ascontiguousarray(np.asarray(f))) for f in j))
    raw = tk.CODECS[qt][2](t).numpy()
    np.testing.assert_array_equal(raw, JAX[qt][1](j))
    _scales_and_deq(qt, j, t)


@pytest.mark.parametrize("qt", list(JAX))
def test_random_blocks_are_valid(qt):
    """The seeded random blocks the full-width smoke run serves: they
    survive a byte round trip, decode in JAX to the same values, and have
    about the asked scale."""
    g = torch.Generator().manual_seed(3)
    t = tk.random_blocks(qt, 64, 1024, 0.03, g)
    nbytes, tdec, tenc = tk.CODECS[qt]
    raw = tenc(t)
    _assert_same_container(JAX[qt][0](raw.numpy()), tdec(raw))
    x = tk.DEQUANT[type(t)](t)
    assert torch.isfinite(x).all()
    assert abs(float(x.mean())) < 0.003 and 0.02 < float(x.std()) < 0.04
    assert tk.k16_qtype(t) == (None if qt == "q4_K" else qt.lower())


K16 = ["q6_K", "q3_K", "q2_K"]


def _k16_sources(qt):
    """A per-16 container from random bytes, from the JAX encoder and from
    ``random_blocks``, each beside the JAX container of the same bits."""
    nbytes, tdec, tenc = tk.CODECS[qt]
    raw = np.random.default_rng(nbytes).integers(0, 256, (6, 4, nbytes),
                                                 dtype=np.uint8)
    yield JAX[qt][0](raw), tdec(torch.from_numpy(raw))
    x = np.random.default_rng(9).normal(0, 0.05, (8, 512)).astype(np.float32)
    j = JAX_QUANTIZE[qt](x)
    yield j, getattr(tk, type(j).__name__)(
        *(torch.from_numpy(np.ascontiguousarray(np.asarray(f))) for f in j))
    t = tk.random_blocks(qt, 16, 1024, 0.03, torch.Generator().manual_seed(4))
    yield JAX[qt][0](tenc(t).numpy()), t


@pytest.mark.parametrize("qt", K16)
def test_compact_k16_layout_keeps_the_products(qt):
    """``layout.PreparedK16`` keeps the container's f16 d and int8 sc (q2_K
    also dmin and mn), 8.5625 (q2_K 9.125) bits a weight; its ``scp`` and
    ``mp`` are the containers' and JAX's products bit for bit, and
    ``dequantize_k16`` the container's values."""
    from quant_gemm_tpu_torch.kernels import layout

    for j, t in _k16_sources(qt):
        w = layout.prepare_k16(t)
        n, k = w.n, w.k
        assert (w.d.dtype, w.sc.dtype) == (torch.float16, torch.int8)
        assert w.d.shape == (n, k // 256) and w.sc.shape == (n, k // 16)
        assert (w.dmin is None) == (w.mn is None) == (qt != "q2_K")
        planes = sum(p.numel() * p.element_size()
                     for p in layout.k16_planes(w))
        assert 8 * (w.qs.numel() + planes) == n * k * (
            9.125 if qt == "q2_K" else 8.5625)
        with np.errstate(all="ignore"):
            _assert_same_floats(j.scp, w.scp)
            _assert_same_floats(t.scp, w.scp)
            if qt == "q2_K":
                _assert_same_floats(j.mp, w.mp)
                _assert_same_floats(t.mp, w.mp)
            else:
                assert w.mp is None
            np.testing.assert_array_equal(
                _bits(tk.DEQUANT[type(t)](t).numpy()),
                _bits(layout.dequantize_k16(w).numpy()))


@pytest.mark.parametrize("qt", K16)
def test_factor_recovers_the_encoders_planes(qt):
    """``convert._factor`` turns the products JAX keeps (``scp``, q2_K's
    ``-mp``) back into the encoder's own d and sc (dmin and mn); on any
    blocks its factors give the same products bit for bit."""
    from quant_gemm_tpu_torch.kernels import layout
    from quant_gemm_tpu_torch.models import convert

    lo_hi = convert.K16_SCALES[qt.lower()]
    for i, (j, t) in enumerate(_k16_sources(qt)):
        if i == 0:  # random bytes: f16 fields may be inf or NaN
            continue
        w = layout.prepare_k16(t)
        n = w.n
        d, sc = convert._factor(w.scp.reshape(n, -1, 16), *lo_hi)
        got = layout.PreparedK16(w.qtype, n, w.k, w.qs, d.reshape(n, -1),
                                 sc.reshape(n, -1))
        _assert_same_floats(w.scp, got.scp)
        if i == 1:  # the encoder's planes themselves
            assert torch.equal(d.reshape(n, -1), w.d)
            assert torch.equal(sc.reshape(n, -1), w.sc)
        if qt == "q2_K":
            dmin, mn = convert._factor(-w.mp.reshape(n, -1, 16),
                                       *convert.K16_SCALES["q2_k"])
            got = got._replace(dmin=dmin.reshape(n, -1),
                               mn=mn.reshape(n, -1))
            _assert_same_floats(w.mp, got.mp)
            if i == 1:
                assert torch.equal(dmin.reshape(n, -1), w.dmin)
                assert torch.equal(mn.reshape(n, -1), w.mn)
