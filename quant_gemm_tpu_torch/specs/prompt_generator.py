"""Kernel implementation-brief generator: a definition JSON rendered as a
self-contained brief for a CUDA kernel on Hopper (sm_90a).

Counterpart of ``quant_gemm_tpu/specs/prompt_generator.py``, with its
sections (axes, tensors, block formats, quantization math, epilogue,
device layout, entry point, pitfalls, acceptance checklist, solution
template) holding the port's own content: the format table from
:data:`..formats.blocks.SPECS`, the N-major layout of
``kernels/layout.py``, a plain-C entry point bound by ``kernels/
_build.py``'s rules, and the pitfalls that have bitten this port's
kernels.  A new kernel, written by hand or otherwise, starts from the
contract the committed ones meet.

CLI::

    python -m quant_gemm_tpu_torch.specs.prompt_generator gemm/q4_0_q8_1
    python -m quant_gemm_tpu_torch.specs.prompt_generator --all -o DIR
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import textwrap

from ..formats.blocks import SPECS

HERE = pathlib.Path(__file__).parent

#: words of the definitions (shared with the JAX package) that name the
#: TPU's units, and what the brief says for them on this card
_TERMS = {"int8-MXU": "int8 tensor-core", "MXU": "tensor-core"}

_LAYOUTS = {
    "q4_0": "18 B = f16 d | 16 B qs (byte j: elem j low nibble, elem j+16 high)",
    "q4_1": "20 B = f16 d | f16 m | 16 B qs (nibble interleave as q4_0)",
    "q5_0": "22 B = f16 d | u32 qh (bit i -> elem i 5th bit) | 16 B qs",
    "q5_1": "24 B = f16 d | f16 m | u32 qh | 16 B qs",
    "q8_0": "34 B = f16 d | 32 B qs (sequential int8)",
    "q8_1": "36 B = f16 d | f16 s=d*sum(q) | 32 B qs (sequential int8)",
}

# kernels/layout.py: everything N-major and unpadded, a weight row's
# bytes contiguous
_DEVICE = {
    "q4_0": "qs u8[N, K/2] (block b's 16 bytes at [16b, 16b+16): llama.cpp's"
            " block_q4_0 qs, one 16-byte load a block) + d f16[N, K/32]",
    "q4_1": "qs u8[N, K/2] + d f16[N, K/32] + m f16[N, K/32]",
    "q5_0": "qs u8[N, K/2] + qh i32[N, K/32] (bit j = 5th bit of code 32b+j)"
            " + d f16[N, K/32]",
    "q5_1": "qs u8[N, K/2] + qh i32[N, K/32] + d f16[N, K/32] + m f16[N, K/32]",
    "q8_0": "qs i8[N, K] (block b's 32 codes at [32b, 32b+32)) + d f16[N, K/32]",
    "q8_1": "activations: qs i8[M, K] + d f16[M, K/32] + s f16[M, K/32], "
            "row-major as quantize_q8_1 returns them",
}

_ENTRY = """\
## Entry point (plain C, bound with ctypes)

The source is `quant_gemm_tpu_torch/csrc/<name>.cu`; it includes no PyTorch
header (a build takes seconds) and `kernels/_build.py` compiles it with
`nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC -Xptxas -v` into a library hashed over source, headers and
flags.

```cpp
extern "C" int qgt_<name>(const void* w_qs, const void* w_d, const void* a,
                          void* out, int m, int n, int k,
                          long long stride_a, void* stream) {
    <name>_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(...);
    return (int)cudaGetLastError();
}
```

(`csrc/common.cuh` exports `qgt_error_string`, which `_build.check` reads.)

```python
from quant_gemm_tpu_torch.kernels import _build

def my_kernel(w, a):
    if a.device.type == "cpu":
        return my_kernel_plain(w, a)       # the plain PyTorch version
    _build.check_aligned("my_kernel", w.qs, a)
    out = torch.empty(m, n, dtype=torch.float32, device=a.device)
    fn = _build.function("<name>", "qgt_<name>", [_build.P] * 4
                         + [_build.I] * 3 + [_build.L, _build.P])
    _build.check("<name>", "qgt_<name>", fn(
        _build.ptr(w.qs), _build.ptr(w.d), _build.ptr(a), _build.ptr(out),
        m, n, k, a.stride(0), _build.stream(a.device)))
    my_kernel.launches += 1              # counted where it launches
    return out
```

Binding rules: every pointer and the stream `c_void_p`, every size `c_int`,
every element stride `c_longlong`; launch on
`torch.cuda.current_stream().cuda_stream`; return `cudaGetLastError()` and
raise through `_build.check`; a CPU tensor runs the plain version, a CUDA
one launches or raises, nothing falls back.
"""

_PITFALLS = """\
## Hopper pitfalls (each has bitten a kernel of this port)

1. **Rounding**: quantizers round half to even: `__float2int_rn` /
   `rintf`, as `torch.round` and `np.rint`.  `roundf` and
   `(int)(x + 0.5f)` round ties away from zero and fail the bit checks.
2. **Q8_1 sum**: `s = f16(d * sum(q))` over the integer codes
   (llama.cpp's), not `sum(x)`.
3. **Alignment**: 16-byte vector loads need operands on 16-byte
   boundaries; a view at an odd offset is copied (`_build.aligned16`) or
   refused (`_build.check_aligned`), never read misaligned.
4. **Ties between summation orders**: a last-ulp difference before the
   Q8_1 quantize (an RMSNorm or SiLU in another float32 order) moves a
   code across a .5 tie; fused kernels are held bit for bit only on
   inputs that make their prologue exact, elsewhere to a stated tolerance.
5. **Registers and spills**: read `-Xptxas -v` (`python -m
   quant_gemm_tpu_torch.harness.aot`) for every template instance; a
   spill in the inner loop costs more than a smaller tile.
6. **Timing**: time with CUDA events around single launches with the
   50 MB L2 flushed before each (`harness.benchmark.DeviceTimer`), and
   state the card's power limit beside every number.
"""


_EXACT = ("Integer block dots are exact (int8 tensor cores, int32 "
          "accumulators); the per-block terms are float32, scales f16-stored "
          "and upcast to float32 at load.  Sum the blocks in the order "
          "`kernels/gemm_exact.py::k1_order` replays, so the output is "
          "reproducible bit for bit.")
_DEQUANT = ("Dequantize each weight block to bf16 tensor-core operands (a "
            "float32 activation as three bf16 pieces, "
            "`kernels/gemm_dequant.py::split3`, each piece x code product "
            "exact) and accumulate in float32.")


def _port_text(s: str) -> str:
    for tpu, port in _TERMS.items():
        s = s.replace(tpu, port)
    return s


def format_table(names) -> str:
    rows = ["| format | bits | B/block | B/elem | layout (AoS byte-exact) |",
            "|---|---|---|---|---|"]
    for nm in names:
        s = SPECS[nm]
        rows.append(
            f"| {nm} | {s.bits} | {s.block_bytes} | {s.bytes_per_elem:.4g} "
            f"| {_LAYOUTS[nm]} |"
        )
    return "\n".join(rows)


def _quant_formulas(d: dict) -> str:
    qs = d.get("quantization_spec", {})
    out = []
    for nm, spec in qs.items():
        out.append(f"* **{nm}**: quantize `{spec.get('quantize', '-')}`; "
                   f"dequantize `{spec.get('dequantize', '-')}`"
                   + (f"  ({spec['note']})" if "note" in spec else ""))
    return "\n".join(out) or "(float op — no quantization spec)"


def generate(defn: dict) -> str:
    """Render one definition JSON into a markdown implementation brief."""
    name = defn["name"]
    fmts = sorted(
        {v["dtype"] for v in defn.get("inputs", {}).values()
         if v.get("dtype") in SPECS}
    )
    axes = "\n".join(
        f"* `{k}`: {v.get('description', '')}"
        + (f" (const = {v['value']})" if v.get("type") == "const" else "")
        for k, v in defn.get("axes", {}).items()
    )
    shapes = "\n".join(
        f"* input `{k}`: shape {v['shape']}, dtype `{v['dtype']}` — "
        f"{v.get('description', '')}"
        for k, v in defn.get("inputs", {}).items()
    ) + "\n" + "\n".join(
        f"* output `{k}`: shape {v['shape']}, dtype `{v['dtype']}`"
        for k, v in defn.get("outputs", {}).items()
    )
    acc = defn.get("accuracy", {})
    epilogue = defn.get("epilogue")
    parts = [
        f"# Implementation brief: `{name}` (CUDA, Hopper sm_90a)",
        "",
        _port_text(defn.get("description", "")),
        "",
        "## Axes",
        axes,
        "",
        "## Tensors",
        shapes,
        "",
        "## Block formats",
        format_table(fmts) if fmts else "(none — float operator)",
        "",
        "### Quantization math",
        _quant_formulas(defn),
        "",
    ]
    if epilogue:
        parts += [
            "## Epilogue (the formula the kernel must evaluate per block)",
            f"```\n{epilogue}\n```",
            _DEQUANT if epilogue == "dequantize-then-dot" else _EXACT,
            "",
        ]
    if fmts:
        parts += [
            "## Device layout (`kernels/layout.py`: N-major, unpadded; the "
            "serialized AoS form exists only at the GGUF boundary)",
            "\n".join(f"* **{f}**: {_DEVICE[f]}" for f in fmts),
            "",
            "A ragged N is masked in the kernel; K is a multiple of 32.",
            "",
        ]
    parts += [
        _ENTRY,
        _PITFALLS,
        "## Acceptance checklist",
        textwrap.dedent(f"""\
            - [ ] a plain PyTorch version beside the kernel, run for CPU
                  tensors, equal to the golden (`ref.gemm` / `ops.*_ref`)
            - [ ] a CPU test (`tests/test_torch_*.py`) holding the plain
                  version to the JAX package's function on the same numpy
                  inputs, at the stated tolerance
            - [ ] {acc.get('metric', 'nmse_vs_fp32')} < {acc.get('threshold', 0.015)}
                  on data `{acc.get('data', 'normal(0, 0.5), seed 42')}`
            - [ ] constraints hold: {', '.join(defn.get('constraints', [])) or '-'}
            - [ ] a `chip_smoke.py` row on the card: the kernel against its
                  plain version (bit for bit where the arithmetic allows
                  it), timed beside its bound, launches counted
            - [ ] no spill in `python -m quant_gemm_tpu_torch.harness.aot`
            - [ ] a solution JSON in `specs/solutions/` (from
                  `specs/build_specs.py`) whose entry point resolves
            """),
        "",
        "## Solution JSON template",
        "```json",
        json.dumps(
            {
                "name": f"{name}_<variant>",
                "op_type": defn.get("op_type", ""),
                "language": "cuda",
                "target": ["nvidia-h100-sm_90a"],
                "entry_point": "quant_gemm_tpu_torch.kernels.<module>::<fn>",
                "description": "<what the kernel does, and its source>",
            },
            indent=2,
        ),
        "```",
    ]
    return "\n".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("spec", nargs="?", help="e.g. gemm/q4_0_q8_1")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("-o", "--out", help="file (single) or directory (--all)")
    args = ap.parse_args(argv)
    defs = HERE / "definitions"
    if args.all:
        outdir = pathlib.Path(args.out) if args.out else None
        for p in sorted(defs.rglob("*.json")):
            text = generate(json.loads(p.read_text()))
            if outdir:
                outdir.mkdir(parents=True, exist_ok=True)
                (outdir / f"{p.stem}.md").write_text(text)
                print(f"wrote {outdir / (p.stem + '.md')}")
            else:
                print(text, "\n\n---\n")
        return 0
    if not args.spec:
        ap.error("pass a spec path like gemm/q4_0_q8_1, or --all")
    p = defs / f"{args.spec}.json"
    text = generate(json.loads(p.read_text()))
    if args.out:
        pathlib.Path(args.out).write_text(text)
        print(f"wrote {args.out}")
    else:
        print(text)
    return 0


__all__ = ["generate", "format_table", "main", "HERE"]


if __name__ == "__main__":
    sys.exit(main())
