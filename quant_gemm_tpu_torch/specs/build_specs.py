"""Generate the operator definition and solution JSONs (run: python -m
quant_gemm_tpu_torch.specs.build_specs).

Counterpart of ``quant_gemm_tpu/specs/build_specs.py``: each *definition*
fixes an operator's axes, dtypes, constraints, quantization semantics and
an accuracy threshold, and is the JAX package's byte for byte (the port's
spec runner, ``spec_runner.py``, holds its kernels to the same
definitions); each *solution* names the port's implementation
(``module::NAME`` or ``module::NAME['key']``) for a runner to load, one
for each of the JAX package's solutions (``jax_solution``), on Hopper
(``nvidia-h100-sm_90a``).  ``tests/test_torch_specs_tools.py`` holds the
committed JSONs to this generator.
"""

from __future__ import annotations

import importlib
import json
import pathlib
import re

HERE = pathlib.Path(__file__).parent

QUANT_SPECS = {
    "q4_0": {
        "block_size": 32,
        "bytes_per_block": 18,
        "bits_per_element": 4.5,
        "quantize": "d = max(|x|)/7; q = clip(rint(x/d), -8, 7) + 8",
        "dequantize": "x = (q - 8) * d",
    },
    "q4_1": {
        "block_size": 32,
        "bytes_per_block": 20,
        "bits_per_element": 5.0,
        "quantize": "d = (max-min)/15; m = min; q = clip(rint((x-m)/d), 0, 15)",
        "dequantize": "x = q * d + m",
    },
    "q5_0": {
        "block_size": 32,
        "bytes_per_block": 22,
        "bits_per_element": 5.5,
        "quantize": "d = max(|x|)/15; q = clip(rint(x/d), -16, 15) + 16",
        "dequantize": "x = (q - 16) * d",
    },
    "q5_1": {
        "block_size": 32,
        "bytes_per_block": 24,
        "bits_per_element": 6.0,
        "quantize": "d = (max-min)/31; m = min; q = clip(rint((x-m)/d), 0, 31)",
        "dequantize": "x = q * d + m",
    },
    "q8_0": {
        "block_size": 32,
        "bytes_per_block": 34,
        "bits_per_element": 8.5,
        "quantize": "d = max(|x|)/127; q = clip(rint(x/d), -127, 127)",
        "dequantize": "x = q * d",
    },
    "q8_1": {
        "block_size": 32,
        "bytes_per_block": 36,
        "bits_per_element": 9.0,
        "quantize": "d = max(|x|)/127; q = clip(rint(x/d), -127, 127); s = f16(d * sum(q))",
        "dequantize": "x = q * d",
        "note": "s is the llama.cpp-exact compensation sum (d * integer code sum)",
    },
}

EPILOGUES = {
    "q4_0": "C += d_w * (d_a * sumi - 8 * s_a)",
    "q4_1": "C += d_w * d_a * sumi + m_w * s_a",
    "q5_0": "C += d_w * (d_a * sumi - 16 * s_a)",
    "q5_1": "C += d_w * d_a * sumi + m_w * s_a",
    "q8_0": "C += d_w * d_a * sumi",
}

NMSE = {"q4_0": 0.015, "q4_1": 0.015, "q5_0": 0.01, "q5_1": 0.01, "q8_0": 0.005}

KQUANT_SPECS = {
    "q4_k": {
        "superblock_size": 256,
        "bytes_per_superblock": 144,
        "bits_per_element": 4.5,
        "quantize": ("per 32-sub-block: d' = d*ls[j], m' = -dmin*lm[j] with "
                     "6-bit (ls, lm) pairs and f16 super-scales (d, dmin); "
                     "q = clip(rint((x + dmin*lm)/d'), 0, 15)"),
        "dequantize": "x = d*ls[j]*q - dmin*lm[j]",
        "serialized": "block_q4_K: d f16 | dmin f16 | scales[12] | qs[128]",
    },
    "q5_k": {
        "superblock_size": 256,
        "bytes_per_superblock": 176,
        "bits_per_element": 5.5,
        "quantize": "as q4_k with 5-bit codes (clip 0..31), qh 5th-bit plane",
        "dequantize": "x = d*ls[j]*q - dmin*lm[j], q in [0, 31]",
        "serialized": ("block_q5_K: d f16 | dmin f16 | scales[12] | qh[32] | "
                       "qs[128]"),
    },
}


def _kquant_def(qtype: str) -> dict:
    return {
        "name": f"quantize_{qtype}",
        "op_type": "quantize_kquant",
        "description": (
            f"float32 [..., K] -> {qtype} super-blocks (K % 256 == 0); "
            "serves on the exact int8-MXU kernel via per-32 effective scales"
        ),
        "axes": {"K": {"type": "var"}, "QK_K": {"type": "const", "value": 256}},
        "constraints": ["K % QK_K == 0"],
        "inputs": {"x": {"shape": ["R", "K"], "dtype": "float32"}},
        "outputs": {"y": {"shape": ["R", "K"], "dtype": qtype}},
        "quantization_spec": {qtype: KQUANT_SPECS[qtype]},
        "accuracy": {
            "metric": "roundtrip_nmse",
            "threshold": {"q4_k": 4.5e-3, "q5_k": 1.1e-3}[qtype],
            "data": "uniform(-1, 1), seed 42",
        },
        "params": {"R": 8, "K": 1024},
    }

GEMM_AXES = {
    "M": {"type": "var", "description": "tokens (batch x sequence)"},
    "N": {"type": "var", "description": "output features"},
    "K": {"type": "var", "description": "reduction dim, multiple of 32"},
    "QK": {"type": "const", "value": 32},
}


def _gemm_def(wtype: str, atype: str) -> dict:
    name = f"gemm_{wtype}_{atype}"
    return {
        "name": name,
        "op_type": "gemm_quant",
        "description": (
            f"C[M,N] = A[M,K] @ W[N,K]^T with {wtype} weights and "
            f"{atype} activations (project convention: M = tokens)"
        ),
        "axes": GEMM_AXES,
        "constraints": ["K % QK == 0"],
        "inputs": {
            "A": {
                "shape": ["M", "K"],
                "dtype": atype,
                "description": "activations (float32 for a16, q8_1 blocks for a8)",
            },
            "W": {"shape": ["N", "K"], "dtype": wtype, "description": "weights"},
        },
        "outputs": {"C": {"shape": ["M", "N"], "dtype": "float32"}},
        "quantization_spec": {
            k: v for k, v in QUANT_SPECS.items() if k in (wtype, atype)
        },
        "epilogue": EPILOGUES[wtype] if atype == "q8_1" else "dequantize-then-dot",
        "accuracy": {
            "metric": "nmse_vs_fp32",
            "threshold": NMSE[wtype],
            "data": "normal(0, 0.5), seed 42",
        },
        "params": {"M": 4, "N": 384, "K": 1024},
    }


def _quantize_def(qtype: str) -> dict:
    return {
        "name": f"quantize_{qtype}",
        "op_type": "quantize",
        "description": f"float32 [..., K] -> {qtype} blocks (round-trip test)",
        "axes": {"K": {"type": "var"}, "QK": {"type": "const", "value": 32}},
        "constraints": ["K % QK == 0"],
        "inputs": {"x": {"shape": ["R", "K"], "dtype": "float32"}},
        "outputs": {"y": {"shape": ["R", "K"], "dtype": qtype}},
        "quantization_spec": {qtype: QUANT_SPECS[qtype]},
        "accuracy": {
            "metric": "roundtrip_nmse",
            "threshold": {
                "q4_0": 6e-3, "q4_1": 6e-3, "q5_0": 1.5e-3,
                "q5_1": 1.5e-3, "q8_0": 3e-5, "q8_1": 3e-5,
            }[qtype],
            "data": "uniform(-1, 1), seed 42",
        },
        "params": {"R": 8, "K": 1024},
    }


def _elementop_def(name, op_type, desc, extra_inputs=(), threshold=1e-5, params=None):
    inputs = {"x": {"shape": ["R", "C"], "dtype": "float32"}}
    for nm, shape in extra_inputs:
        inputs[nm] = {"shape": shape, "dtype": "float32"}
    return {
        "name": name,
        "op_type": op_type,
        "description": desc,
        "axes": {"R": {"type": "var"}, "C": {"type": "var"}},
        "inputs": inputs,
        "outputs": {"y": {"shape": ["R", "C"], "dtype": "float32"}},
        "accuracy": {"metric": "nmse_vs_cpu_ref", "threshold": threshold},
        "params": params or {"R": 5, "C": 512},
    }


def build() -> dict[str, dict]:
    defs: dict[str, dict] = {}
    for w in NMSE:
        defs[f"gemm/{w}_a16"] = _gemm_def(w, "float32")
        defs[f"gemm/{w}_q8_1"] = _gemm_def(w, "q8_1")
    for q in QUANT_SPECS:
        defs[f"quantization/quantize_{q}"] = _quantize_def(q)
    defs["normalization/rmsnorm"] = _elementop_def(
        "rmsnorm", "rmsnorm",
        "y = x * rsqrt(mean(x^2) + eps) * weight, eps = 1e-5",
        extra_inputs=[("weight", ["C"])],
    )
    defs["activation/silu"] = _elementop_def(
        "silu", "activation", "y = x * sigmoid(x)")
    defs["activation/gelu"] = _elementop_def(
        "gelu", "activation", "y = 0.5 x (1 + erf(x/sqrt(2)))")
    defs["activation/gelu_quick"] = _elementop_def(
        "gelu_quick", "activation",
        "llama.cpp tanh approximation, coefficients 0.7978845608, 0.044715",
        threshold=1e-5,
    )
    defs["attention/softmax"] = _elementop_def(
        "softmax", "softmax", "row softmax, numerically stable (max-subtract)")
    defs["attention/rope"] = {
        "name": "rope",
        "op_type": "rope",
        "description": "rotary embedding, split layout, theta = pos/base^(2i/d)",
        "axes": {
            "S": {"type": "var", "description": "sequence"},
            "H": {"type": "var", "description": "heads"},
            "D": {"type": "var", "description": "head dim (even)"},
        },
        "inputs": {
            "x": {"shape": ["S", "H", "D"], "dtype": "float32"},
            "pos": {"shape": ["S"], "dtype": "int32"},
        },
        "outputs": {"y": {"shape": ["S", "H", "D"], "dtype": "float32"}},
        "params": {"S": 6, "H": 4, "D": 64, "base": 10000.0},
        "accuracy": {"metric": "nmse_vs_cpu_ref", "threshold": 1e-9},
    }
    defs["attention/flash_decode"] = {
        "name": "flash_decode",
        "op_type": "attention",
        "description": (
            "Causal decode attention (T=1) over a [B, KV, S, hd] KV cache "
            "with per-slot lengths: out = softmax(q k^T / sqrt(hd) + "
            "causal_mask(pos)) v, online-softmax single pass"
        ),
        "axes": {
            "B": {"type": "var", "description": "batch slots"},
            "KV": {"type": "var", "description": "kv heads"},
            "REP": {"type": "var", "description": "GQA group width (H / KV)"},
            "S": {"type": "var", "description": "cache length (static)"},
            "HD": {"type": "const", "value": 128, "description": "head dim"},
        },
        "constraints": ["S % ts == 0 after tile auto-halving", "pos[b] < S"],
        "inputs": {
            "q": {"shape": ["B", "KV", "REP", "HD"], "dtype": "float32",
                  "description": "grouped queries, one token per slot"},
            "k": {"shape": ["B", "KV", "S", "HD"], "dtype": "bfloat16",
                  "description": "key cache (or [L,...] stacked with layer=)"},
            "v": {"shape": ["B", "KV", "S", "HD"], "dtype": "bfloat16"},
            "pos": {"shape": ["B"], "dtype": "int32",
                    "description": "current token position per slot "
                                   "(attends to slots <= pos)"},
        },
        "outputs": {"o": {"shape": ["B", "KV", "REP", "HD"],
                          "dtype": "float32"}},
        "accuracy": {"metric": "max_abs_err_vs_dense_softmax",
                     "threshold": 2e-03, "data": "normal(0, 1), f32 cache",
                     "note": "bf16 MXU dot rounding dominates on TPU "
                             "(~5e-4); interpret mode reaches 1e-6"},
        "params": {"B": 4, "KV": 2, "REP": 4, "S": 256, "HD": 128},
    }
    defs["attention/flash_prefill"] = {
        "name": "flash_prefill",
        "op_type": "attention",
        "description": (
            "Causal prefill attention over T-major grouped query rows "
            "(row t*REP + r = token t of GQA member r) against a "
            "[B, KV, S, hd] cache; query token t attends cache slots "
            "<= pos0[b] + t.  Online-softmax streaming, O(tile) memory "
            "(no [T, S] score materialization)"
        ),
        "axes": {
            "B": {"type": "var", "description": "batch slots"},
            "KV": {"type": "var", "description": "kv heads"},
            "REP": {"type": "var", "description": "GQA group width (H / KV)"},
            "T": {"type": "var", "description": "query tokens per slot"},
            "S": {"type": "var", "description": "cache length (static)"},
            "HD": {"type": "const", "value": 128, "description": "head dim"},
        },
        "constraints": ["pos0[b] + T <= S"],
        "inputs": {
            "q": {"shape": ["B", "KV", "T*REP", "HD"], "dtype": "float32"},
            "k": {"shape": ["B", "KV", "S", "HD"], "dtype": "bfloat16"},
            "v": {"shape": ["B", "KV", "S", "HD"], "dtype": "bfloat16"},
            "pos0": {"shape": ["B"], "dtype": "int32",
                     "description": "position of the first query token"},
        },
        "outputs": {"o": {"shape": ["B", "KV", "T*REP", "HD"],
                          "dtype": "float32"}},
        "accuracy": {"metric": "max_abs_err_vs_dense_softmax",
                     "threshold": 1e-2, "data": "normal(0, 1), f32 cache",
                     "note": "MXU default-precision rounding dominates on "
                             "TPU (~5e-3, below the dense bf16 path's own "
                             "error); interpret mode reaches 1e-6"},
        "params": {"B": 2, "KV": 2, "REP": 2, "T": 32, "S": 128, "HD": 128},
    }
    for q in ("q4_k", "q5_k"):
        defs[f"quantization/quantize_{q}"] = _kquant_def(q)
    return defs


TARGET = ["nvidia-h100-sm_90a"]


def _solution(name, jax_name, op_type, language, entry, description):
    return {"name": name, "op_type": op_type, "language": language,
            "target": TARGET, "entry_point": entry,
            "jax_solution": jax_name, "description": description}


_PKG = "quant_gemm_tpu_torch"
SOLUTIONS = {s["name"]: s for s in (
    _solution(
        "gemm_dequant_bf16", "gemm_pallas_bf16", "gemm_quant", "cuda",
        f"{_PKG}.kernels.registry::LADDER['pallas']",
        "K4: dequant GEMM on the bf16 tensor cores (mma.sync), the "
        "N-major weight blocks dequantized to bf16 operands, float32 "
        "accumulation (csrc/gemm_dequant.cu)"),
    _solution(
        "gemm_dequant_f32", "gemm_pallas_f32", "gemm_quant", "cuda",
        f"{_PKG}.kernels.registry::LADDER['pallas_f32']",
        "K4's float32 form: the float32 activation as three bf16 pieces "
        "(gemm_dequant.split3), every piece x code product exact, the "
        "accuracy of a float32 product (csrc/gemm_dequant.cu)"),
    _solution(
        "gemm_exact_int", "gemm_pallas_exact_int", "gemm_quant", "cuda",
        f"{_PKG}.kernels.gemm_exact::gemm_exact",
        "K1: per-32-block int8 tensor-core dots (mma.sync) on "
        "the raw codes plus the format's compensation epilogue, the "
        "serving decode GEMM (M <= 12), bit-equal to k1_order of the "
        "golden's block terms (csrc/gemm_exact.cu, csrc/k1.cuh)"),
    _solution(
        "flash_prefill_cuda", "flash_prefill_pallas", "attention", "cuda",
        f"{_PKG}.ops.attention::flash_prefill",
        "K5: causal streaming prefill attention over the [L, B, KV, S, hd] "
        "cache, bf16 tensor cores, online softmax, O(tile) memory; int8 "
        "cache with its per-token scales folded in (csrc/flash_prefill.cu)"),
    _solution(
        "kquant_effective_serving", "kquant_effective_serving",
        "quantize_kquant", "python/torch",
        f"{_PKG}.formats.kquants::to_effective",
        "Q4_K per-32 effective (d*ls, -dmin*lm) float32 scales, served by "
        "the q4_1 forms of K1 and K4"),
    _solution(
        "flash_decode_cuda", "flash_decode_pallas", "attention", "cuda",
        f"{_PKG}.ops.attention::flash_decode",
        "K3: online-softmax decode attention over the serving KV cache, "
        "the walk split into pieces and merged; bf16 or int8 cache "
        "(per-token scales folded into scores and weights), window and "
        "ring (csrc/flash_decode.cu)"),
    _solution(
        "gemm_torch_dequant", "gemm_xla_dequant", "gemm_quant",
        "python/torch", f"{_PKG}.kernels.registry::LADDER['xla_dequant']",
        "dequantize + float32 matmul, the plain rung (any K)"),
    _solution(
        "gemm_exact_fused", "gemm_pallas_exact_fused", "gemm_quant", "cuda",
        f"{_PKG}.kernels.gemm_exact::gemm_exact_fused",
        "K6: K1 with the Q8_1 quantize of its float activation in the "
        "kernel (per-32 amax, f16-rounded d, stored s), bit-equal to "
        "quantize_q8_1 + K1 (csrc/gemm_exact_fused.cu)"),
    _solution(
        "gemm_exact_k16", "gemm_pallas_q6k", "gemm_quant", "cuda",
        f"{_PKG}.kernels.gemm_exact_k16::gemm_exact_k16",
        "K7: per-16-block int8 tensor-core dots on the exact q6_K / q3_K / "
        "q2_K codes with float32 per-16 scales d*sc (q2_K's mins added), "
        "K1's body (csrc/gemm_exact_k16.cu)"),
)}


_ENTRY = re.compile(r"^(?P<name>[A-Za-z_]\w*)(?:\[(?P<q>['\"])(?P<key>[^'\"]+)"
                    r"(?P=q)\])?$")


def resolve(entry_point: str):
    """The object a solution's ``entry_point`` names: ``module::NAME``, or
    ``module::NAME['key']`` (an item of a mapping, JAX's
    ``KERNELS['pallas']`` form)."""
    mod_name, expr = entry_point.split("::")
    m = _ENTRY.match(expr)
    if m is None:
        raise ValueError(f"cannot parse entry point {entry_point!r}")
    obj = getattr(importlib.import_module(mod_name), m.group("name"))
    return obj if m.group("key") is None else obj[m.group("key")]


def main() -> None:
    for rel, d in build().items():
        path = HERE / "definitions" / f"{rel}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(d, indent=2) + "\n")
    sol_dir = HERE / "solutions"
    sol_dir.mkdir(exist_ok=True)
    for name, s in SOLUTIONS.items():
        (sol_dir / f"{name}.json").write_text(json.dumps(s, indent=2) + "\n")
    print(f"wrote {len(build())} definitions, {len(SOLUTIONS)} solutions "
          f"under {HERE}")


__all__ = ["build", "main", "resolve", "SOLUTIONS", "QUANT_SPECS", "EPILOGUES", "NMSE",
           "KQUANT_SPECS", "GEMM_AXES", "HERE", "TARGET"]


if __name__ == "__main__":
    main()
