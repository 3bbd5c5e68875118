"""The port's ``generate`` CLI (``python -m quant_gemm_tpu_torch.scripts.
generate``) in subprocesses on ``tests/golden/tiny_llama_q4km.gguf``, on
the CPU (``--device cpu``).

Tolerance: none.  The greedy transcript is ``tests/test_gguf_interop.py::
test_greedy_transcript_pinned``'s (``GREEDY_CONT`` after ``PROMPT_IDS``),
token for token; the text is the tokenizer's decode of prompt and
transcript together, as the JAX ``scripts/generate.py`` prints it.  The
chat, JSON-grammar and grammar-file runs (the last one sampled, with a
seed) print what JAX's ``scripts/generate.py --cpu`` prints for the same
flags, run in subprocesses beside them.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from quant_gemm_tpu.formats.gguf_file import GGUFFile
from quant_gemm_tpu.models import tokenizer as jt

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "golden" / "tiny_llama_q4km.gguf"
PROMPT = "hello world"
PROMPT_IDS = [0, 262, 312, 311, 292]  # tests/test_gguf_interop.py
GREEDY_CONT = [252, 44, 79, 306, 79, 306]


def _run(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "quant_gemm_tpu_torch.scripts.generate",
         "-m", str(FIXTURE), *args],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT)


# the runs held against JAX's CLI ({g}: a yes/no grammar file)
JAX_CASES = {
    "chat_json": ("-p", "hi", "--chat", "--json", "-n", "4"),
    "grammar_sampled": ("-p", "say", "--grammar-file", "{g}", "-n", "3",
                        "--temp", "0.7", "--top-k", "20", "--top-p", "0.9",
                        "--min-p", "0.01", "--repeat-penalty", "1.1",
                        "--seed", "5"),
}


@pytest.fixture(scope="module")
def tok():
    return jt.tokenizer_from_gguf(GGUFFile(str(FIXTURE)).metadata)


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    """(JAX's ``scripts/generate.py --cpu`` stdout for each of
    ``JAX_CASES``, all run at once; the grammar file's path)."""
    g = tmp_path_factory.mktemp("gbnf") / "yn.gbnf"
    g.write_text('root ::= "yes" | "no"\n', encoding="utf-8")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "scripts" / "generate.py"), "-m",
         str(FIXTURE), *(a.format(g=g) for a in args), "--cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env=env) for name, args in JAX_CASES.items()}
    out = {}
    for name, p in procs.items():
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, se[-1500:]
        out[name] = so
    return out, g


def _case(name, g):
    return [a.format(g=g) for a in JAX_CASES[name]]


def test_prompt_gives_the_pinned_transcript(tok):
    r = _run("-p", PROMPT, "-n", "6", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-1500:]
    assert f"prompt -> 5 tokens: {PROMPT_IDS}" in r.stderr
    assert "6 tokens in" in r.stderr
    assert r.stdout.rstrip("\n") == tok.decode(PROMPT_IDS + GREEDY_CONT)


def test_ids_give_the_pinned_ids():
    r = _run("--ids", ",".join(map(str, PROMPT_IDS)), "-n", "6",
             "--device", "cpu", "--kv", "bf16")
    assert r.returncode == 0, r.stderr[-1500:]
    assert r.stdout.strip() == ",".join(map(str, GREEDY_CONT))


def test_chat_and_json_grammar(tok, jax_cli):
    out, g = jax_cli
    r = _run(*_case("chat_json", g), "--device", "cpu")
    assert r.returncode == 0, r.stderr[-1500:]
    rendered = "<|user|>\nhi<|eot|><|assistant|>\n"
    assert r.stdout.startswith(rendered)
    assert r.stdout[len(rendered):].lstrip().startswith("{")
    assert r.stdout == out["chat_json"]


def test_grammar_file_and_sampling_flags(jax_cli):
    out, g = jax_cli
    r = _run(*_case("grammar_sampled", g), "--device", "cpu")
    assert r.returncode == 0, r.stderr[-1500:]
    assert r.stdout.rstrip("\n")[len("say"):] in ("yes", "no")
    assert r.stdout == out["grammar_sampled"]


@pytest.mark.parametrize("flag", ["--lora", "--draft"])
def test_unported_options_name_the_roadmap(flag):
    """``--lora`` and ``--draft`` are served (slice 15: tests/test_torch_
    lora.py and test_torch_speculative.py run them): a missing file
    fails and is named, and ``--draft`` refuses a grammar, as JAX's
    CLI does."""
    r = _run("-p", PROMPT, flag, "x.gguf", "--device", "cpu")
    assert r.returncode != 0
    assert "x.gguf" in r.stderr and "NotImplementedError" not in r.stderr
    if flag == "--draft":
        r = _run("-p", PROMPT, flag, "x.gguf", "--json", "--device", "cpu")
        assert r.returncode != 0 and "exclusive" in r.stderr


def test_runs_on_the_card_unless_asked(tok):
    """Without ``--device`` the CLI asks for CUDA: on a machine without a
    GPU it fails and says so rather than run on the CPU."""
    code = ("import torch, sys; sys.exit(0 if torch.cuda.is_available() "
            "else 3)")
    if subprocess.run([sys.executable, "-c", code]).returncode == 0:
        pytest.skip("a GPU is present: the default device works")
    r = _run("-p", PROMPT, "-n", "2")
    assert r.returncode != 0
    assert "device='cpu'" in r.stderr or "device 'cuda'" in r.stderr
    assert json.dumps(GREEDY_CONT) not in r.stdout
