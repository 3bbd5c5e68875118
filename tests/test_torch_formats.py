"""The port's block formats against the JAX package, on the CPU.

Tolerance: none — the torch quantizers, the port's numpy golden and the
q4_0 device layout must be bit-equal to the JAX package's
``formats/numpy_ref.py`` and ``formats/jax_quant.py`` on the same inputs
(the GGUF byte contract and the quantizers' rounding are exact integer /
IEEE-f16 results, so any difference is a bug).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_gemm_tpu.formats import jax_quant as jq
from quant_gemm_tpu.formats import numpy_ref as jnr
from quant_gemm_tpu_torch.formats import numpy_ref as pnr
from quant_gemm_tpu_torch.formats import quant as tq
from quant_gemm_tpu_torch.kernels import layout

FORMATS = ["q4_0", "q8_0", "q8_1"]
TORCH_TWINS = ("q4_0", "q8_1")  # the formats the port quantizes in torch


def _inputs(kind: str) -> np.ndarray:
    """[6, 256] float32 rows built to hit the quantizers' edge cases."""
    rng = np.random.default_rng({"normal": 0, "tiny": 1, "huge": 2,
                                 "ties": 3}[kind])
    x = rng.standard_normal((6, 256)).astype(np.float32)
    if kind == "tiny":
        x *= np.float32(1e-6)  # f16-subnormal scales
    elif kind == "huge":
        x *= np.float32(1e7)  # saturating scales (f16_sat)
    elif kind == "ties":
        # every block's amax is 127, so the 8-bit scale is exactly 1 and
        # the half-integer inputs land on .5 ties: rint rounds to even
        x = (rng.integers(-253, 254, (6, 256)) * 0.5).astype(np.float32)
        x[:, ::32] = 127.0
    x[0, :32] = 0.0  # all-zero block: d = 0, safe reciprocal
    return x


@pytest.mark.parametrize("kind", ["normal", "tiny", "huge", "ties"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_quantizers_bit_equal(fmt, kind):
    x = _inputs(kind)
    ref = jnr.QUANTIZE[fmt](x)
    jax_t = jq.QUANTIZE[fmt](jnp.asarray(x))
    mine_np = pnr.QUANTIZE[fmt](x)
    for r, a, c in zip(ref, mine_np, jax_t):
        np.testing.assert_array_equal(a, r)
        np.testing.assert_array_equal(np.asarray(c), r)
    np.testing.assert_array_equal(pnr.dequantize(mine_np),
                                  jnr.dequantize(ref))
    if fmt in TORCH_TWINS:
        mine_t = tq.QUANTIZE[fmt](torch.from_numpy(x))
        for r, b in zip(ref, mine_t):
            np.testing.assert_array_equal(b.numpy(), r)
        np.testing.assert_array_equal(
            tq.dequantize(mine_t).numpy(), jnr.dequantize(ref))


def test_q8_1_sum_is_f16_of_d_times_code_sum():
    """s = f16(d * sum(q)), not the sum of the float inputs."""
    x = _inputs("normal")
    a = tq.quantize_q8_1(torch.from_numpy(x))
    qsum = a.qs.to(torch.int32).reshape(6, 8, 32).sum(-1).to(torch.float32)
    want = (qsum * a.d.to(torch.float32)).to(torch.float16)
    torch.testing.assert_close(a.s, want, rtol=0, atol=0)
    xsum = torch.from_numpy(x).reshape(6, 8, 32).sum(-1).to(torch.float16)
    assert not torch.equal(a.s, xsum)


def test_layout_is_gguf_block_order():
    x = _inputs("normal")
    w = tq.quantize_q4_0(torch.from_numpy(x))
    pw = layout.prepare(w)
    codes = jnr.codes(jnr.quantize_q4_0(x))  # [6, 256] raw 0..15
    # GGUF block_q4_0.qs: byte j of block b = code 32b+j | code 32b+j+16 << 4
    blocks = codes.reshape(6, 8, 2, 16)
    want = (blocks[:, :, 0] | (blocks[:, :, 1] << 4)).reshape(6, 128)
    np.testing.assert_array_equal(pw.qs.numpy(), want.astype(np.uint8))
    np.testing.assert_array_equal(layout.codes(pw).numpy(), codes)
    np.testing.assert_array_equal(
        layout.dequantize(pw).numpy(), jnr.dequantize(jnr.quantize_q4_0(x)))


def test_prepare_rejects_unported_formats():
    """A q5_K tensor lays out through its effective q5_1 form (f32
    planes); IQ4_NL blocks lay out as q8_0 once decoded and IQ4_XS
    blocks in their effective ``iq4_xs`` form (slice 14), while their
    raw bytes raise, as does a K-quant container passed without its
    effective form."""
    from quant_gemm_tpu.formats import kquants as jk
    from quant_gemm_tpu_torch.formats import kquants as tk

    w5k = tk.quantize_q5_k(_inputs("normal"), search=False)
    pw = layout.prepare(tk.to_effective_q5_k(w5k))
    assert pw.qtype == "q5_k" and pw.d.dtype == torch.float32
    np.testing.assert_array_equal(layout.dequantize(pw).numpy(),
                                  tk.dequantize_q5_k(w5k).numpy())
    with pytest.raises(NotImplementedError):
        layout.prepare(w5k)
    iq4 = jk.quantize_iq4_nl(_inputs("normal"))  # block_iq4_nl bytes
    with pytest.raises(NotImplementedError, match="not ported"):
        layout.prepare(iq4)
    nl = layout.prepare(tk.from_bytes_iq4_nl(torch.from_numpy(iq4)))
    assert nl.qtype == "q8_0"
    np.testing.assert_array_equal(layout.dequantize(nl).numpy(),
                                  jk.dequantize_iq4_nl_bytes(iq4))
    raw = np.random.default_rng(5).integers(0, 256, (6, 1, 136),
                                            dtype=np.uint8)
    raw[:, :, 1] &= 0x3B
    xs = layout.prepare(tk.from_bytes_iq4_xs(torch.from_numpy(raw)))
    assert xs.qtype == "iq4_xs" and xs.d.dtype == torch.float32
    np.testing.assert_array_equal(layout.dequantize(xs).numpy(),
                                  jk.dequantize_iq4_xs_bytes(raw))
