"""The port's ``quant_gemm``-compatible API against the JAX package's, on
the CPU.

Exact: the quantizers' block bytes equal JAX's for every format (numpy in,
numpy out; torch in, torch out), the dequantizer's floats equal JAX's,
and the checks raise JAX's errors with JAX's messages.  The weight-first
GEMM against JAX's ``api.gemm_q4_0_q8_1`` within ``1e-5 * max|C|``
(both run exact integer block dots; their float32 sums go in other
orders), and against the numpy golden ``ref/gemm.py::gemm_wxa8`` (float64
sums) within NMSE 1e-10; on CPU tensors it is the plain K1 route
(``gemm_exact.k1_order`` of the block terms on the card, bit for bit:
``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from quant_gemm_tpu import api as japi
from quant_gemm_tpu_torch import api as tapi
from quant_gemm_tpu_torch.formats import numpy_ref
from quant_gemm_tpu_torch.ref import gemm as refg

QTYPES = ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "q8_1"]


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("qtype", QTYPES)
def test_quantize_bytes_equal_jax(qtype):
    x = _x((3, 5, 128), 1)
    want = np.asarray(japi.quantize(x, qtype))
    got = tapi.quantize(x, qtype)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    t = tapi.quantize(torch.from_numpy(x), qtype)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.uint8
    np.testing.assert_array_equal(t.numpy(), want)
    np.testing.assert_array_equal(tapi.dequantize(got, qtype, 128),
                                  np.asarray(japi.dequantize(want, qtype,
                                                             128)))


def test_gemm_matches_jax_and_golden():
    """M = 64 out-features, N = 4 activation rows (the decode route), K
    1024; and N = 20, past DECODE_M_MAX (the K4 route)."""
    for n in (4, 20):
        w, a = _x((64, 1024), 2), _x((n, 1024), 3)
        wq, aq = tapi.quantize_q4_0(w), tapi.quantize_q8_1(a)
        got = tapi.gemm_q4_0_q8_1(wq, aq, 64, n, 1024)
        want = np.asarray(japi.gemm_q4_0_q8_1(wq, aq, 64, n, 1024))
        assert got.shape == (64, n) and isinstance(got, np.ndarray)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        if n == 4:
            gold = refg.gemm_wxa8(numpy_ref.quantize_q4_0(w),
                                  numpy_ref.quantize_q8_1(a)).T
            assert ((got - gold) ** 2).sum() <= 1e-10 * (gold ** 2).sum()
        t = tapi.gemm_q4_0_q8_1(torch.from_numpy(wq), torch.from_numpy(aq),
                                64, n, 1024)
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), got)


def test_validation_errors_match_jax():
    x = _x((2, 128), 7)
    cases = [
        lambda api: api.quantize_q4_0(x[:, :100]),
        lambda api: api.gemm_q4_0_q8_1(x, x, 2, 2, 128),
        lambda api: api.gemm_q4_0_q8_1(api.quantize_q4_0(x),
                                       api.quantize_q8_1(x), 4, 2, 128),
        lambda api: api.gemm_q4_0_q8_1(api.quantize_q4_0(x),
                                       api.quantize_q8_1(x), 2, 3, 128),
        lambda api: api.quantize(x, "q6_k"),
        lambda api: api.dequantize(x, "q4_0", 128),
        lambda api: api.dequantize(api.quantize_q4_0(x), "q4_0", 64),
    ]
    for case in cases:
        msgs = []
        for api in (japi, tapi):
            with pytest.raises(ValueError) as e:
                case(api)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
