"""The port's spec runner and its element ops against the JAX package, on
the CPU.

Inputs come from the definitions' seeds (numpy) or, for the ops, from
numpy with a seed stated in each test.  Tolerances:

* the runner (``device="cpu"``: every kernel's plain version) passes every
  committed definition under its own threshold; for the gemm, quantize
  and kquant definitions its NMSE is within 1e-3 relative of the JAX
  runner's on the same definition (the same quantized inputs, float32
  products summed in other orders); the element-op and attention
  definitions sit near float32 rounding in both runners, so both must
  pass (the port's attention scores the same bf16-rounded k/v it feeds
  the kernel);
* K9's plain version against JAX ``rms_norm_pallas`` in interpret mode:
  ``atol = 1e-6 * max|y|`` (the sums of squares are taken in other float32
  orders, which moves the normalised rows by one or two units in the
  last place); K10's against ``softmax_pallas``: ``atol = 1e-6``;
* the plain ops (GELU, RoPE, causal softmax, ...): ``atol = 1e-6`` against
  JAX, the RoPE and Llama-3 tables bit for bit.
"""

import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_gemm_tpu.ops import activations as jact
from quant_gemm_tpu.ops import elementwise as jel
from quant_gemm_tpu.specs import spec_runner as jrunner
from quant_gemm_tpu_torch.ops import activations as tact
from quant_gemm_tpu_torch.ops import elementwise as tel
from quant_gemm_tpu_torch.ops import rope as trope
from quant_gemm_tpu_torch.ops import softmax as tsm
from quant_gemm_tpu_torch.ops.rms_norm import (rms_norm_pallas,
                                               rms_norm_pallas_plain,
                                               rms_norm_ref)
from quant_gemm_tpu_torch.specs import spec_runner as runner

jrms = importlib.import_module("quant_gemm_tpu.ops.rms_norm")
jsm = importlib.import_module("quant_gemm_tpu.ops.softmax")
jrope = importlib.import_module("quant_gemm_tpu.ops.rope")

DEFS = runner.definitions()
EXACT_OPS = ("gemm_quant", "quantize", "quantize_kquant")


def test_definitions_are_the_jax_packages():
    """The port's definitions are copies of the JAX package's, all of
    them."""
    rel = {p.relative_to(runner.HERE / "definitions") for p in DEFS}
    jrel = {p.relative_to(jrunner.HERE / "definitions")
            for p in jrunner.definitions()}
    assert rel == jrel and len(rel) == 26
    for r in rel:
        assert (json.loads((runner.HERE / "definitions" / r).read_text())
                == json.loads((jrunner.HERE / "definitions" / r).read_text()))


@pytest.mark.parametrize("path", DEFS, ids=lambda p: p.stem)
def test_runner_matches_jax(path):
    got = runner.run_spec(path, device="cpu")
    assert got.passed, got.row()
    want = jrunner.run_spec(jrunner.HERE / path.relative_to(runner.HERE))
    assert want.passed, want.row()
    assert (got.name, got.metric, got.threshold) == (
        want.name, want.metric, want.threshold)
    if runner.load(path)["op_type"] in EXACT_OPS:
        assert abs(got.nmse - want.nmse) <= 1e-3 * want.nmse, (got, want)


def test_main_sweeps_every_definition(capsys):
    assert runner.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"{len(DEFS)}/{len(DEFS)} specs passed" in out
    assert out.count("PASS") == len(DEFS)


def test_runner_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the default device on a machine without a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        runner.run_spec(DEFS[0])


def _rungs(path):
    """The ladder rungs a gemm definition's activation takes."""
    q8 = runner.load(path)["inputs"]["A"]["dtype"] == "q8_1"
    return ["pallas_f32", "pallas_bf16"] + (["pallas_exact", "xla_int"]
                                            if q8 else [])


GEMM_RUNGS = [(p, impl) for p in DEFS if p.parent.name == "gemm"
              for impl in _rungs(p)]


@pytest.mark.parametrize("path, impl", GEMM_RUNGS,
                         ids=[f"{p.stem}-{i}" for p, i in GEMM_RUNGS])
def test_gemm_specs_at_k_1056(path, impl):
    """K % 64 == 32: the port's layout takes it (JAX's planar 4/5-bit
    prepare does not); each gemm definition passes its threshold there
    under each rung its activation takes."""
    r = runner.run_spec(path, impl=impl, params={"M": 8, "K": 1056},
                        device="cpu")
    assert r.passed, r.row()


@pytest.mark.parametrize("stem", ["q4_0_q8_1", "q5_1_a16"])
def test_gemm_memo_keeps_the_draws(stem):
    """A caller's ``memo`` holds the seeded draws and golden of a shape
    and gives the same result as drawing anew, bit for bit; the runner
    keeps nothing itself."""
    path = next(p for p in DEFS if p.stem == stem)
    params = {"M": 8, "N": 64, "K": 256}
    fresh = runner.run_spec(path, params=params, device="cpu")
    memo = {}
    first = runner.run_spec(path, params=params, device="cpu", memo=memo)
    assert set(memo) == {("A", 8, 256), ("W", 64, 256), ("C", 8, 64, 256)}
    again = runner.run_spec(path, params=params, device="cpu", memo=memo)
    assert fresh.nmse == first.nmse == again.nmse and fresh.passed


CASES = [(r, c) for r in (5, 300) for c in (512, 1000)]


def _rows(r, c, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((r, c)) * 0.5).astype(np.float32)
    return x, rng.uniform(0.5, 1.5, c).astype(np.float32)


@pytest.mark.parametrize("r, c", CASES)
def test_rms_norm_pallas_plain_matches_jax(r, c):
    x, w = _rows(r, c, r * c)
    got = rms_norm_pallas(torch.from_numpy(x), torch.from_numpy(w))
    want = np.asarray(jrms.rms_norm_pallas(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    torch.testing.assert_close(
        got, rms_norm_pallas_plain(torch.from_numpy(x), torch.from_numpy(w)),
        rtol=0, atol=0)
    np.testing.assert_array_equal(rms_norm_ref(x, w), jrms.rms_norm_ref(x, w))


@pytest.mark.parametrize("r, c", CASES)
def test_softmax_pallas_plain_matches_jax(r, c):
    x, _ = _rows(r, c, r + c)
    x *= 8.0
    got = tsm.softmax_pallas(torch.from_numpy(x))
    want = np.asarray(jsm.softmax_pallas(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tsm.softmax_ref(x), jsm.softmax_ref(x))


def test_row_kernels_refuse_other_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(TypeError):
        rms_norm_pallas(x.double(), torch.ones(8))
    with pytest.raises(ValueError):
        rms_norm_pallas(x, torch.ones(7))
    with pytest.raises(TypeError):
        tsm.softmax_pallas(x[0])
    with pytest.raises(ValueError):  # neither the CPU nor a CUDA device
        tsm.softmax_pallas(x.to("meta"))
    with pytest.raises(ValueError):
        rms_norm_pallas(x.to("meta"), torch.ones(8, device="meta"))
    before = (rms_norm_pallas.launches, tsm.softmax_pallas.launches)
    rms_norm_pallas(x, torch.ones(8))
    tsm.softmax_pallas(x)
    assert (rms_norm_pallas.launches, tsm.softmax_pallas.launches) == before


@pytest.mark.parametrize("name", ["gelu", "gelu_quick", "silu"])
def test_activations_match_jax(name):
    x = (np.random.default_rng(9).standard_normal((5, 512)) * 3).astype(
        np.float32)
    got = getattr(tact, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(getattr(jact, name)(
        jnp.asarray(x))), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(getattr(tact, f"{name}_ref")(x),
                                  getattr(jact, f"{name}_ref")(x))


@pytest.mark.parametrize("interleaved", [False, True])
def test_rope_matches_jax(interleaved):
    x = np.random.default_rng(10).standard_normal((6, 4, 64)).astype(
        np.float32)
    pos = np.arange(3, 9)
    got = trope.rope(torch.from_numpy(x), torch.from_numpy(pos),
                     interleaved=interleaved).numpy()
    want = np.asarray(jrope.rope(jnp.asarray(x), jnp.asarray(pos),
                                 interleaved=interleaved))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        trope.rope_ref(x, pos, interleaved=interleaved),
        jrope.rope_ref(x, pos, interleaved=interleaved))
    cos, sin = trope.rope_cache(64, 64, device="cpu")
    jcos, jsin = jrope.rope_cache(64, 64)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))
    args = (128, 500000.0, 8.0, 1.0, 4.0, 8192)
    np.testing.assert_array_equal(trope.llama3_inv_freq(*args),
                                  jrope.llama3_inv_freq(*args))


def test_rope_cache_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the default device on a machine without a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        trope.rope_cache(16, 64)


def test_causal_softmax_and_elementwise_match_jax():
    x = np.random.default_rng(12).standard_normal((4, 9)).astype(np.float32)
    y = np.random.default_rng(13).standard_normal((4, 9)).astype(np.float32)
    pos = np.array([0, 3, 8, 20])
    got = tsm.softmax_causal(torch.from_numpy(x), torch.from_numpy(pos), 0.7)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jsm.softmax_causal(jnp.asarray(x),
                                                   jnp.asarray(pos), 0.7)),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(),
                               jsm.softmax_causal_ref(x, pos, 0.7),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tsm.softmax(torch.from_numpy(x)).numpy(),
                               jsm.softmax_ref(x), rtol=0, atol=1e-6)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for name, args in (("add", ()), ("mul", ()), ("add_scale", (0.3,))):
        np.testing.assert_array_equal(
            getattr(tel, name)(xt, yt, *args).numpy(),
            np.asarray(getattr(jel, name)(jnp.asarray(x), jnp.asarray(y),
                                          *args)))
        np.testing.assert_array_equal(getattr(tel, f"{name}_ref")(x, y, *args),
                                      getattr(jel, f"{name}_ref")(x, y, *args))
    np.testing.assert_array_equal(tel.scale(xt, 0.3).numpy(),
                                  tel.scale_ref(x, 0.3))
