"""The port's ggml compatibility adapter against the JAX package's, on the
CPU.

Exact: a tensor view over a GGUF file written by JAX has ggml's ``ne``
convention and decodes to JAX's floats.  ``gemm_from_ggml`` "auto" on a
Q8_1 activation (the decode route, K1's plain version) within ``1e-5 *
max|C|`` of JAX's and of the numpy golden (float32 sums in other orders),
and the named rungs ``xla_dequant`` and ``pallas_bf16`` within NMSE 1e-10
and 1e-4 of JAX's (float32 summation orders; bf16 operand rounding on
both sides).  The ``ggml_op_*`` drop-ins against JAX's at ``rtol=1e-5,
atol=1e-6`` (float32 element ops: XLA's and PyTorch's exp, rsqrt, tanh
differ in the last bits), RoPE in both modes against the numpy golden at
``atol=2e-6``.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_gemm_tpu import compat as jc
from quant_gemm_tpu.formats import gguf_file as jgguf
from quant_gemm_tpu.formats import numpy_ref as jnr
from quant_gemm_tpu_torch import compat as tc
from quant_gemm_tpu_torch.formats import numpy_ref
from quant_gemm_tpu_torch.formats.gguf_file import GGUFFile
from quant_gemm_tpu_torch.formats.quant import quantize_q8_1
from quant_gemm_tpu_torch.ops.rope import rope_ref
from quant_gemm_tpu_torch.ref import gemm as refg


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    w = _x((128, 512), 3)
    path = tmp_path_factory.mktemp("gguf") / "adapter.gguf"
    jgguf.write_gguf(path, {"blk.0.attn_q.weight": jnr.quantize_q4_0(w),
                            "blk.0.norm.weight": np.ones(512, np.float32)},
                     metadata={"general.name": "adapter-test"})
    return path, w


def test_tensor_view_matches_jax(gguf_path):
    path, w = gguf_path
    jv = jc.tensor_view_from_gguf(jgguf.GGUFFile(path), "blk.0.attn_q.weight")
    with GGUFFile(path) as gf:
        tv = tc.tensor_view_from_gguf(gf, "blk.0.attn_q.weight")
        nv = tc.tensor_view_from_gguf(gf, "blk.0.norm.weight")
        assert (tv.k, tv.rows, tv.ne, tv.qtype) == (jv.k, jv.rows, jv.ne,
                                                    jv.qtype) == (
            512, 128, (512, 128), "q4_0")
        soa = tv.to_soa()
        np.testing.assert_array_equal(
            numpy_ref.dequantize(type(soa)(*(x.numpy() for x in soa))),
            jnr.dequantize(jv.to_soa()))
        assert nv.qtype == "f32" and nv.rows == 1
        assert tc.prepare_from_gguf(gf, "blk.0.attn_q.weight",
                                    device="cpu").qtype == "q4_0"


def test_gemm_from_ggml_matches_jax(gguf_path):
    path, w = gguf_path
    jv = jc.tensor_view_from_gguf(jgguf.GGUFFile(path), "blk.0.attn_q.weight")
    with GGUFFile(path) as gf:
        tv = tc.tensor_view_from_gguf(gf, "blk.0.attn_q.weight")
    a = _x((2, 512), 4)
    from quant_gemm_tpu.formats import jax_quant

    aq = quantize_q8_1(torch.from_numpy(a))
    got = tc.gemm_from_ggml(tv, aq, kernel="auto").numpy()
    want = np.asarray(jc.gemm_from_ggml(
        jv, jax_quant.device_put(jnr.quantize_q8_1(a)), kernel="auto"))
    gold = refg.gemm_wxa8(numpy_ref.quantize_q4_0(w),
                          numpy_ref.quantize_q8_1(a))
    for ref in (want, gold):
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    for rung, tol in (("xla_dequant", 1e-10), ("pallas_bf16", 1e-4)):
        got = tc.gemm_from_ggml(tv, torch.from_numpy(a), kernel=rung).numpy()
        want = np.asarray(jc.gemm_from_ggml(jv, jnp.asarray(a), kernel=rung))
        assert ((got - want) ** 2).sum() <= tol * (want ** 2).sum(), rung


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(kw or dict(rtol=1e-5, atol=1e-6)))


def test_ggml_ops_match_jax():
    x, y = _x((4, 64), 5), _x((4, 64), 6)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for name in ("silu", "gelu"):
        _close(tc.GGML_OPS[name](tx), jc.GGML_OPS[name](jnp.asarray(x)))
    _close(tc.ggml_op_soft_max(tx, scale=0.5),
           jc.ggml_op_soft_max(jnp.asarray(x), scale=0.5))
    for name in ("add", "mul"):
        _close(tc.GGML_OPS[name](tx, ty),
               jc.GGML_OPS[name](jnp.asarray(x), jnp.asarray(y)))
    blob = struct.pack("<f", 1e-5)
    for eps in (blob, 1e-6):
        _close(tc.ggml_op_rms_norm(tx, eps), jc.ggml_op_rms_norm(x, eps))
    assert set(tc.GGML_OPS) == set(jc.GGML_OPS)


def test_ggml_rope_modes():
    x = _x((2, 1, 2, 64), 7)  # [B, T, H, hd]
    pos = np.array([[3], [5]], np.int32)
    for mode, inter in ((0, True), (2, False)):
        got = tc.ggml_op_rope(torch.from_numpy(x), pos, {"mode": mode})
        _close(got, rope_ref(x, pos, interleaved=inter), atol=2e-6)
        _close(got, jc.ggml_op_rope(jnp.asarray(x), pos, {"mode": mode}),
               atol=2e-6)
