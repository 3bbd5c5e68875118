"""Every public name of every JAX module has a counterpart in the port:
the same name in the port's matching module, or a row of :data:`TABLE`
naming where it lives in the port and why (a rename, a re-export the port
keeps in its submodule), or ``None`` with a TPU-only reason.

Public names: a module's ``__all__``, else its top-level functions,
classes and assignments whose names do not start with ``_``.  The port's
matching module has the same dotted path under ``quant_gemm_tpu_torch``,
except for :data:`RENAMED` modules.
"""

from __future__ import annotations

import ast
import importlib
import pathlib

import numpy as np
import pytest
import torch

import quant_gemm_tpu
from quant_gemm_tpu import utils as jutils
from quant_gemm_tpu.formats import gguf as jgguf
from quant_gemm_tpu.formats import kquants as jk
from quant_gemm_tpu.formats import numpy_ref as jnr
from quant_gemm_tpu.harness import datagen as jdg
from quant_gemm_tpu.harness import metrics as jmetrics
from quant_gemm_tpu.ops import activations as jact
from quant_gemm_tpu.ref import gemm as jref
from quant_gemm_tpu_torch import utils
from quant_gemm_tpu_torch.formats import gguf, kquants
from quant_gemm_tpu_torch.formats import numpy_ref as tnr
from quant_gemm_tpu_torch.formats import quant as tq
from quant_gemm_tpu_torch.harness import datagen, metrics
from quant_gemm_tpu_torch.kernels import gemm_exact_k16, gemm_xla, layout
from quant_gemm_tpu_torch.ops import activations
from quant_gemm_tpu_torch.ref import gemm as tref

JAX_ROOT = pathlib.Path(quant_gemm_tpu.__file__).parent
#: JAX module -> the port's module of another name
RENAMED = {"kernels.gemm_pallas": "kernels.gemm_dequant",
           "formats.jax_quant": "formats.quant"}
TPU_ONLY = "TPU-only"

#: "jax.module::NAME" -> ("port.module::NAME" or None, reason)
TABLE = {
    # re-exports of the JAX packages' __init__ files: the port keeps them
    # in the submodules (its package imports stay light)
    "::api": ("api::gemm_q4_0_q8_1", "the port's api module, imported as "
              "quant_gemm_tpu_torch.api"),
    "::QK": ("formats.blocks::QK", "re-export kept in formats.blocks"),
    "::SPECS": ("formats.blocks::SPECS", "re-export kept in formats.blocks"),
    **{f"formats::{n}": (f"formats.blocks::{n}",
                         "re-export kept in formats.blocks")
       for n in ("QK", "SPECS", "QuantSpec", "Q4_0Tensor", "Q4_1Tensor",
                 "Q5_0Tensor", "Q5_1Tensor", "Q8_0Tensor", "Q8_1Tensor")},
    "formats::gguf": ("formats.gguf::to_bytes", "the module "
                      "quant_gemm_tpu_torch.formats.gguf"),
    "kernels::PreparedWeight": ("kernels.layout::PreparedWeight",
                                "the port's device layout module"),
    "kernels::prepare": ("kernels.layout::prepare",
                         "the port's device layout module"),
    "kernels::gemm_pallas_call": ("kernels.gemm_dequant::gemm_dequant",
                                  "K4 under the port's name"),
    "kernels::supports": (None, f"{TPU_ONLY}: JAX's K4 pads K into "
                          "256-row nibble packs and needs K % 64; the "
                          "port's K4 takes any K % 32, the shape condition "
                          "gemm_dequant._check raises on"),
    "kernels::gemm_exact_fused": ("kernels.gemm_exact::gemm_exact_fused",
                                  "re-export kept in kernels.gemm_exact"),
    "kernels::KERNELS": ("kernels.registry::LADDER", "JAX's KERNELS dict "
                         "of ladder rungs is the port's registry.LADDER "
                         "(registry.KERNELS is the port's Ops tuple)"),
    "kernels::dispatch": ("kernels.registry::dispatch",
                          "re-export kept in kernels.registry"),
    **{f"ops::{n}": (f"ops.{m}::{n}", f"re-export kept in ops.{m}")
       for m, names in (("activations", ("silu", "silu_mul", "gelu",
                                         "gelu_quick")),
                        ("elementwise", ("add", "mul", "scale", "add_scale")),
                        ("rms_norm", ("rms_norm_pallas",)),
                        ("rope", ("rope_cache", "apply_rope")),
                        ("softmax", ("softmax_causal", "softmax_pallas")))
       for n in names},
    "formats.jax_quant::device_put": (None, f"{TPU_ONLY}: jnp.asarray onto "
                                      "the default JAX device; the port's "
                                      "containers move with .to(device)"),
    "harness.aot::topology": (None, f"{TPU_ONLY}: libtpu's deviceless "
                              "topology; nvcc needs none (aot_compile)"),
    "harness.aot::topology_available": (None, f"{TPU_ONLY}: libtpu's "
                                        "topology lock"),
    "harness.aot::topology_mesh": (None, f"{TPU_ONLY}: a mesh of "
                                   "compile-only TPU devices"),
    "harness.aot::shape_structs": (None, f"{TPU_ONLY}: jax.ShapeDtypeStruct"
                                   "s for lowering on a topology"),
    "harness.aot::compiled_hlo": (None, f"{TPU_ONLY}: XLA's scheduled HLO; "
                                  "the port's schedule is read from a "
                                  "torch.profiler window (overlap_report)"),
    "harness.aot::OVERLAP_OPTS": (None, f"{TPU_ONLY}: XLA:TPU's "
                                  "latency-hiding scheduler flags"),
    "harness.aot::DEFAULT_TOPOLOGY": (None, f"{TPU_ONLY}: the v5e slice "
                                      "the gate compiles for"),
    "harness.benchmark::default_chain": (None, f"{TPU_ONLY}: keeps XLA from "
                                         "hoisting a kernel out of a "
                                         "fori_loop; eager launches between "
                                         "CUDA events have no such hazard"),
    "kernels.gemm_exact::PreparedK16": ("kernels.layout::PreparedK16",
                                        "the port's device layout module"),
    "kernels.gemm_exact::prepare_k16": ("kernels.layout::prepare_k16",
                                        "the port's device layout module"),
    **{f"kernels.gemm_exact::{n}": (f"kernels.gemm_exact_k16::{n}",
                                    "K7's module of its own")
       for n in ("gemm_exact_k16", "PreparedQ6K", "prepare_q6k",
                 "gemm_exact_q6k")},
    "kernels.gemm_pallas::prepare": ("kernels.layout::prepare",
                                     "the port's device layout module"),
    "kernels.gemm_pallas::gemm": ("kernels.gemm_dequant::gemm_dequant",
                                  "K4 under the port's name"),
    "kernels.gemm_pallas::supports": (None, f"{TPU_ONLY}: see kernels::"
                                      "supports"),
    "kernels.gemm_megalayer::ENABLED": ("kernels.gemm_megalayer::"
                                        "ENABLE_QKV", "JAX's switch of "
                                        "both fusions at once: set "
                                        "ENABLE_QKV and ENABLE_TAIL"),
    "models.llama::jit_forward": ("models.serve::Server", "jax.jit of the "
                                  "forward: on the card the Server replays "
                                  "each step from a captured CUDA graph"),
    "ops.attention::decode_ts_bucket": ("ops.attention::decode_s_hi",
                                        "its s_hi half; the ts half is the "
                                        "TPU's tile size"),
    "utils::f16_sat": ("formats.numpy_ref::f16_sat",
                       "kept beside the numpy golden that uses it"),
}


def _public(path: pathlib.Path, mod) -> list:
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names += [x.id for t in targets for x in ast.walk(t)
                      if isinstance(x, ast.Name)]
    return [n for n in names if not n.startswith("_")]


def _modules() -> list:
    out = []
    for p in sorted(JAX_ROOT.rglob("*.py")):
        rel = p.relative_to(JAX_ROOT).with_suffix("").as_posix()
        rel = rel.replace("/", ".").removesuffix("__init__").rstrip(".")
        out.append((rel, p))
    return out


MODULES = _modules()


def _port(dotted: str):
    mod, name = dotted.split("::")
    return getattr(importlib.import_module(
        "quant_gemm_tpu_torch" + (f".{mod}" if mod else "")), name)


@pytest.mark.parametrize("rel, path", MODULES, ids=[m[0] or "package"
                                                    for m in MODULES])
def test_every_public_name_has_a_counterpart(rel, path):
    jmod = importlib.import_module("quant_gemm_tpu" + (f".{rel}" if rel
                                                       else ""))
    pmod = importlib.import_module(
        "quant_gemm_tpu_torch" + (f".{RENAMED.get(rel, rel)}" if rel else ""))
    missing = []
    for name in _public(path, jmod):
        key = f"{rel}::{name}"
        if key in TABLE:
            port, reason = TABLE[key]
            assert reason and "later" not in reason.lower(), key
            if port is None:
                assert reason.startswith(TPU_ONLY), key
            else:
                assert _port(port) is not None, key
        elif not hasattr(pmod, name):
            missing.append(name)
    assert not missing, f"{rel}: no counterpart for {missing}"


def test_table_rows_are_all_needed():
    """Every row names a real JAX public name that the port's module (not
    a package, whose attributes depend on what was imported) lacks under
    that name: a stale row is an error."""
    publics = {}
    for rel, path in MODULES:
        jmod = importlib.import_module("quant_gemm_tpu" + (f".{rel}" if rel
                                                           else ""))
        publics[rel] = set(_public(path, jmod))
    for key in TABLE:
        rel, name = key.split("::")
        assert name in publics[rel], key
        pmod = importlib.import_module(
            "quant_gemm_tpu_torch" + (f".{RENAMED.get(rel, rel)}" if rel
                                      else ""))
        assert hasattr(pmod, "__path__") or not hasattr(pmod, name), key


def test_every_jax_module_has_a_port_module():
    for rel, _ in MODULES:
        importlib.import_module(
            "quant_gemm_tpu_torch" + (f".{RENAMED.get(rel, rel)}" if rel
                                      else ""))


# ---------------------------------------------------------------------------
# the names this slice added, against JAX's on the same numpy inputs
# ---------------------------------------------------------------------------


def _pair(w_fmt, seed=3, m=4, n=48, k=256):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    return (jnr.QUANTIZE[w_fmt](w), jnr.quantize_q8_1(a),
            tnr.QUANTIZE[w_fmt](w), tnr.quantize_q8_1(a))


@pytest.mark.parametrize("fn, fmt", [("gemm_w4a8", "q4_0"),
                                     ("gemm_w8a8", "q8_0")])
def test_ref_gemm_forms_match_jax(fn, fmt):
    jw, ja, tw, ta = _pair(fmt)
    np.testing.assert_array_equal(getattr(tref, fn)(tw, ta),
                                  getattr(jref, fn)(jw, ja))
    other = "q8_0" if fmt == "q4_0" else "q4_0"
    with pytest.raises(ValueError):
        getattr(tref, fn)(_pair(other)[2], ta)


@pytest.mark.parametrize("fn, fmt", [("vec_dot_q4_0_q8_1", "q4_0"),
                                     ("vec_dot_q8_0_q8_1", "q8_0")])
def test_vec_dots_match_jax(fn, fmt):
    jw, ja, tw, ta = _pair(fmt, seed=5)
    for r in range(3):
        row = [type(t)(*(np.asarray(f)[r:r + 1] for f in t)) for t in
               (jw, ja, tw, ta)]
        assert getattr(tref, fn)(row[2], row[3]) == \
            getattr(jref, fn)(row[0], row[1])


def test_metrics_datagen_utils_activations_match_jax():
    assert metrics.NMSE_VS_FP32 == jmetrics.NMSE_VS_FP32
    assert metrics.NMSE_KERNEL_VS_GOLDEN == jmetrics.NMSE_KERNEL_VS_GOLDEN
    np.testing.assert_array_equal(datagen.xavier((8, 16), 16, 8, seed=4),
                                  jdg.xavier((8, 16), 16, 8, seed=4))
    np.testing.assert_array_equal(datagen.he((8, 16), 16, seed=4),
                                  jdg.he((8, 16), 16, seed=4))
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 70000.0, 1e-8], np.float32)
    np.testing.assert_array_equal(utils.round_nearest_even(x),
                                  jutils.round_nearest_even(x))
    np.testing.assert_array_equal(
        utils.round_nearest_even(torch.from_numpy(x)).numpy(),
        jutils.round_nearest_even(x))
    np.testing.assert_array_equal(utils.f16(x), jutils.f16(x))
    np.testing.assert_array_equal(utils.f16(torch.from_numpy(x)).numpy(),
                                  jutils.f16(x))
    g = np.random.default_rng(8).standard_normal((2, 64)).astype(np.float32)
    np.testing.assert_array_equal(activations.silu_mul_ref(g, g[::-1]),
                                  jact.silu_mul_ref(g, g[::-1]))


@pytest.mark.parametrize("qt, nbytes", [("q2_k", 84), ("q3_k", 110)])
def test_kquant_byte_dequantizers_match_jax(qt, nbytes):
    rng = np.random.default_rng(61)
    raw = rng.integers(0, 256, (8, 2, nbytes)).astype(np.uint8)
    raw[:, :, nbytes - 2 - (2 if qt == "q2_k" else 0):] = 0x3C  # finite f16
    got = getattr(kquants, f"dequantize_{qt}_bytes")(torch.from_numpy(raw))
    want = getattr(jk, f"dequantize_{qt}_bytes")(raw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fmt", ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0",
                                 "q8_1"])
def test_gguf_names_match_jax(fmt):
    rng = np.random.default_rng(62)
    x = rng.standard_normal((3, 128)).astype(np.float32)
    t = tq.QUANTIZE[fmt](torch.from_numpy(x))
    raw = gguf.to_bytes(t)
    np.testing.assert_array_equal(raw.numpy(),
                                  jgguf.to_bytes(jnr.QUANTIZE[fmt](x)))
    for a, b in zip(gguf.from_bytes(raw, fmt), t):
        assert torch.equal(a, b)


def test_aliases_are_the_port_functions():
    assert gemm_exact_k16.gemm_exact_q6k is gemm_exact_k16.gemm_exact_k16
    assert gemm_exact_k16.prepare_q6k is layout.prepare_k16
    assert gemm_exact_k16.PreparedQ6K is layout.PreparedK16
    for n in ("wxa16", "wxa8_scaled", "wxa8_compensated", "wxa8_int", "fp32"):
        assert getattr(gemm_xla, f"gemm_{n}_xla") is getattr(gemm_xla,
                                                             f"gemm_{n}")
    rng = np.random.default_rng(63)
    a = rng.standard_normal((4, 64)).astype(np.float32)
    w = rng.standard_normal((8, 64)).astype(np.float32)
    np.testing.assert_allclose(
        gemm_xla.gemm_fp32_xla(torch.from_numpy(a), torch.from_numpy(w)),
        jref.gemm_fp32(a, w), rtol=1e-6, atol=1e-6)
