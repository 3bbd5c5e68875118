"""A configuration, its architecture, a traffic mix and a per-layer metric
are files of their own, found by name: adding one edits no file that is
there."""

import copy
import json
import shutil
from pathlib import Path

import pytest
import torch

from port_bench import harness, trace, traffic, weights
from port_bench.reference import model as ref

from . import tiny


def test_new_config_and_mix_found_by_name(tmp_path):
    config = dict(tiny.CONFIG, source="another shape")
    mix = dict(tiny.MIX, clients=3)
    bench = tiny.write(tmp_path, config, mix)
    cell = harness.cell(tiny.CELL, tmp_path, bench)
    assert cell.config["source"] == "another shape"
    assert cell.mix["clients"] == 3
    assert cell.limits["logit_gap_max"]["limit"] == tiny.LIMIT
    names = {m["name"] for m in cell.end_to_end}
    assert names == {"output_tok_s", "itl_p95_ms", "ttft_p90_ms",
                     "prompt_tok_s", "setup_s"}
    assert traffic.load("sessions", tmp_path)["clients"] == 3


def test_new_metric_found_by_name(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "steps_per_s.py").write_text(
        "def read(run):\n    return len(run.steps) / run.seconds\n")
    read = harness.reader("steps_per_s", tmp_path)

    class Run:
        steps = [0] * 30
        seconds = 3.0

    assert read(Run()) == 10.0


def test_a_metric_without_workloads_follows_what_it_moves(tmp_path):
    bench = tiny.write(tmp_path)
    bench["per_layer"].append({"name": "steps_per_s", "unit": "1/s",
                               "better": "higher",
                               "source": "host_clock", "layer": "server",
                               "moves": "prompt_tok_s"})
    (tmp_path / "bench.json").write_text(json.dumps(bench))
    per = {m["name"] for m in harness.cell(tiny.CELL, tmp_path,
                                           bench).per_layer}
    assert "steps_per_s" in per
    rag = harness.cell("qwen2.5-1.5b.rag-prefill", harness.ROOT, bench)
    assert "steps_per_s" in {m["name"] for m in rag.per_layer}
    decode = harness.cell("mistral-7b.chat-decode", harness.ROOT, bench)
    assert "steps_per_s" not in {m["name"] for m in decode.per_layer}


def test_each_configuration_resolves_to_archs_llama():
    for w in harness.spec()["workloads"]:
        arch = harness.cell(w["name"]).arch
        assert Path(arch.__file__) == harness.ROOT / "archs" / "llama.py"


#: an architecture added in a file of its own: the llama block under
#: another name, recording what the harness calls
TWIN = '''"""The llama block under another name."""

from port_bench.archs import llama

CALLS = []
KERNEL_GROUPS = [("twin kernel", "twin_kernel")]


def _recorded(name):
    def call(*args):
        CALLS.append(name)
        return getattr(llama, name)(*args)

    return call


program, server, shapes, reference = (
    _recorded(n) for n in ("program", "server", "shapes", "reference"))
'''


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_an_architecture_is_added_in_new_files_only(tmp_path):
    root = tmp_path / "port_bench"
    shutil.copytree(harness.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(root)
    new = {Path("archs/twin.py"): TWIN,
           Path("configs/twin.json"): json.dumps(dict(tiny.CONFIG,
                                                      arch="twin")),
           Path("traffic/twin-sessions.json"): json.dumps(tiny.MIX),
           Path("limits/twin.sessions.json"): json.dumps(
               {"logit_gap_max": {"limit": tiny.LIMIT}})}
    for path, text in new.items():
        (root / path).write_text(text)
    assert _files(root) == before | {p: t.encode() for p, t in new.items()}
    bench = copy.deepcopy(harness.spec())
    bench["workloads"].append({"name": "twin.sessions", "config": "twin",
                               "traffic": "twin-sessions", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("twin.sessions")
    cell = harness.cell("twin.sessions", root, bench)
    assert Path(cell.arch.__file__) == root / "archs" / "twin.py"
    res = tiny.run_tiny(root, seed=2 ** 31 + 21, cell_=cell)
    assert res["correct"], res["compared"]
    assert set(cell.arch.CALLS) == {"program", "server", "shapes",
                                    "reference"}


def test_an_architectures_kernel_groups_follow_the_named_ones():
    extra = [("twin kernel", "twin_kernel"), ("twin gemm", "gemm_exact")]
    assert trace.group("void twin_kernel<8>", extra) == "twin kernel"
    assert trace.group("void twin_kernel<8>") == trace.OTHER
    # a named group keeps its label
    assert trace.group("gemm_exact_kernel", extra) == "K1 gemm_exact"


@pytest.mark.parametrize("arch", [None, "nosuch"], ids=["missing",
                                                         "unknown"])
def test_a_configuration_without_a_known_arch_stops_naming_the_file(
        tmp_path, arch):
    config = {k: v for k, v in tiny.CONFIG.items() if k != "arch"}
    if arch:
        config["arch"] = arch
    bench = tiny.write(tmp_path, config)
    with pytest.raises(SystemExit) as e:
        harness.cell(tiny.CELL, tmp_path, bench)
    want = (tmp_path / "archs" / "nosuch.py" if arch
            else tmp_path / "configs" / "tiny.json")
    assert str(want) in str(e.value)


def test_the_reference_is_a_function_of_reference_over_the_benchmarks_own(
        tmp_path):
    cell = tiny.cell(tmp_path)
    model = weights.Model(cell.config, 5, torch.device("cpu"))
    fn = harness.reference(cell, model)
    assert fn.func is ref.logits
    assert {type(a) for a in fn.args} == {ref.Arch,
                                          weights.ReferenceWeights}


#: architectures whose reference the harness refuses: the program's own
#: forward, and the plain reference bound to a tensor made outside it
NOT_A_REFERENCE = {
    "programs": '''
from port_bench.archs.llama import program, server, shapes


def reference(config, model):
    from quant_gemm_tpu_torch.models import llama

    return llama.forward
''',
    "bound": '''
import functools

import torch

from port_bench.archs.llama import program, server, shapes
from port_bench.reference import model as ref


def reference(config, model):
    return functools.partial(ref.logits, torch.zeros(1))
'''}


@pytest.mark.parametrize("arch", sorted(NOT_A_REFERENCE))
def test_a_reference_from_outside_reference_is_refused(tmp_path, arch):
    bench = tiny.write(tmp_path, dict(tiny.CONFIG, arch=arch))
    (tmp_path / "archs" / f"{arch}.py").write_text(NOT_A_REFERENCE[arch])
    cell = harness.cell(tiny.CELL, tmp_path, bench)
    with pytest.raises(SystemExit) as e:
        harness.reference(cell, None)
    assert repr(arch) in str(e.value)
    assert ("torch.Tensor" if arch == "bound"
            else str(harness.ROOT / "reference")) in str(e.value)
