"""The port's spec tools (``specs/build_specs.py``,
``specs/prompt_generator.py``): the generator against the committed
definitions and solutions and against the JAX package's definitions;
every solution resolves; every definition renders a CUDA brief whose
format table is ``blocks.SPECS``'s and which names no TPU unit."""

from __future__ import annotations

import json
import re

import pytest

from quant_gemm_tpu.specs import build_specs as jbuild
from quant_gemm_tpu.specs import spec_runner as jrunner
from quant_gemm_tpu_torch.formats.blocks import SPECS
from quant_gemm_tpu_torch.specs import build_specs, prompt_generator

DEFS = build_specs.HERE / "definitions"
SOLS = build_specs.HERE / "solutions"


def test_generator_equals_committed_definitions_byte_for_byte():
    gen = build_specs.build()
    assert len(gen) == 26
    for rel, want in gen.items():
        path = DEFS / f"{rel}.json"
        assert path.read_text() == json.dumps(want, indent=2) + "\n", rel
    on_disk = {p.relative_to(DEFS).with_suffix("").as_posix()
               for p in DEFS.rglob("*.json")}
    assert on_disk == set(gen)


def test_definitions_equal_jax():
    assert build_specs.build() == jbuild.build()
    jdefs = jbuild.HERE / "definitions"
    for p in DEFS.rglob("*.json"):
        assert p.read_text() == (jdefs / p.relative_to(DEFS)).read_text()


def test_generator_equals_committed_solutions():
    on_disk = {p.stem: p.read_text() for p in SOLS.glob("*.json")}
    assert on_disk == {n: json.dumps(s, indent=2) + "\n"
                       for n, s in build_specs.SOLUTIONS.items()}


def test_one_solution_per_jax_solution_on_hopper():
    sols = build_specs.SOLUTIONS.values()
    assert sorted(s["jax_solution"] for s in sols) == sorted(jbuild.SOLUTIONS)
    jax_ops = {n: s["op_type"] for n, s in jbuild.SOLUTIONS.items()}
    for s in sols:
        assert s["target"] == ["nvidia-h100-sm_90a"]
        assert s["op_type"] == jax_ops[s["jax_solution"]]
        assert s["language"] == ("python/torch" if s["jax_solution"] in (
            "gemm_xla_dequant", "kquant_effective_serving") else "cuda")
        assert s["entry_point"].startswith("quant_gemm_tpu_torch.")


def test_solution_descriptions_carry_no_tpu_figure():
    """(The ladder keys and ``jax_solution`` keep JAX's names.)"""
    for s in build_specs.SOLUTIONS.values():
        text = s["description"]
        assert not re.search(r"pallas|mosaic|vmem|\bmxu\b|\bv5[ep]\b|tpu\b|"
                             r"TFLOPS|\d+(\.\d+)? ?(us|ms)\b", text, re.I), \
            s["name"]


def test_every_solution_resolves():
    """Each entry point parses as JAX's ``test_solutions_resolve`` parses
    ``module::NAME['key']`` and names a callable."""
    for p in sorted(SOLS.glob("*.json")):
        s = json.loads(p.read_text())
        fn = build_specs.resolve(s["entry_point"])
        assert callable(fn), s["name"]
        mod, expr = s["entry_point"].split("::")
        assert fn is eval(expr, vars(__import__(mod, fromlist=["x"])))  # noqa: S307
    with pytest.raises(ValueError, match="cannot parse"):
        build_specs.resolve("quant_gemm_tpu_torch.kernels.registry::LADDER[1]")


TPU_WORDS = re.compile(r"pallas|mosaic|vmem|\bmxu\b|\btpu\b|\bv[2-7][ep]?\b|"
                       r"trillium|\bici\b|sublane", re.I)


@pytest.mark.parametrize("path", jrunner.definitions(), ids=lambda p: p.stem)
def test_brief_renders_for_every_definition(path):
    rel = path.relative_to(jrunner.HERE / "definitions")
    defn = json.loads((DEFS / rel).read_text())
    text = prompt_generator.generate(defn)
    for section in ("# Implementation brief", "## Axes", "## Tensors",
                    "## Block formats", "### Quantization math",
                    "## Entry point", "## Hopper pitfalls",
                    "## Acceptance checklist", "## Solution JSON template"):
        assert section in text, (defn["name"], section)
    assert not TPU_WORDS.search(text), TPU_WORDS.search(text).group(0)
    if defn.get("epilogue"):
        assert defn["epilogue"] in text
    tmpl = text.split("```json\n")[-1].split("```")[0]
    assert json.loads(tmpl)["target"] == ["nvidia-h100-sm_90a"]


def test_format_table_is_blocks_specs():
    table = prompt_generator.format_table(list(SPECS))
    rows = [r.split("|")[1:-1] for r in table.splitlines()[2:]]
    assert [r[0].strip() for r in rows] == list(SPECS)
    for r in rows:
        s = SPECS[r[0].strip()]
        assert int(r[1]) == s.bits and int(r[2]) == s.block_bytes
        assert float(r[3]) == pytest.approx(s.bytes_per_elem, rel=1e-3)
        assert r[4].strip().startswith(f"{s.block_bytes} B")


def test_cli_matches_jax(tmp_path, capsys):
    assert prompt_generator.main(["gemm/q4_0_q8_1"]) == 0
    assert "gemm_q4_0_q8_1" in capsys.readouterr().out
    assert prompt_generator.main(["--all", "-o", str(tmp_path)]) == 0
    assert len(list(tmp_path.glob("*.md"))) == 26
    out = tmp_path / "one.md"
    assert prompt_generator.main(["attention/rope", "-o", str(out)]) == 0
    assert out.read_text().startswith("# Implementation brief: `rope`")
