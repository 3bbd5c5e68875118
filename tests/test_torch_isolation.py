"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on CUDA unless the caller asks for the CPU."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "quant_gemm_tpu_torch"


def test_importing_every_module_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import quant_gemm_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'quant_gemm_tpu' or "
        "m.startswith('quant_gemm_tpu.'))\n"
        "assert len(mods) >= 65, mods\n"
        "new = {'formats.kquants', 'formats.gguf_file', "
        "'kernels.gemm_exact_k16', 'models.gguf_loader', "
        "'harness.datagen', 'harness.metrics', 'ref.gemm', "
        "'kernels.gemm_xla', 'ops.softmax', 'ops.elementwise', "
        "'specs.spec_runner', 'models.lora', 'models.speculative', "
        "'models.evaluate', 'models.hf_loader', 'api', 'compat', "
        "'scripts.perplexity', 'harness.benchmark', 'harness.profiling', "
        "'harness.aot', 'native', 'specs.build_specs', "
        "'specs.prompt_generator', 'formats.gguf', 'scripts.trace_loss'}\n"
        "assert {p.__name__ + '.' + n for n in new} <= set(mods), mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|quant_gemm_tpu)(?:\.|\s|$)", re.M)


def test_no_jax_or_reference_import_in_sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 15
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in _IMPORT.finditer(f.read_text())]
    assert not hits, hits


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the default device on a machine without a GPU")


def test_default_device_raises_without_gpu(no_gpu):
    from quant_gemm_tpu_torch.models import llama, serve

    cfg = llama.LlamaConfig(vocab=64, dim=64, n_layers=1, n_heads=2,
                            n_kv_heads=2, d_ff=128, max_seq=32)
    params = llama.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        llama.quantize_params(params)
    with pytest.raises(RuntimeError, match="cuda"):
        llama.init_qparams(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        llama.KVCache.init(cfg, 1)
    qp = llama.quantize_params(params, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.Server(qp, cfg, max_prefill_chunk=48)
    from quant_gemm_tpu_torch.formats.gguf_file import GGUFFile
    from quant_gemm_tpu_torch.models import gguf_loader

    fixture = ROOT / "tests" / "golden" / "tiny_llama_q4km.gguf"
    with pytest.raises(RuntimeError, match="cuda"):
        gguf_loader.load_llama(fixture)
    with pytest.raises(RuntimeError, match="cuda"):
        GGUFFile(fixture).load("output.weight")
    # the slice-15 entry points default to the card too
    from quant_gemm_tpu_torch.models import hf_loader, lora

    with pytest.raises(RuntimeError, match="cuda"):
        lora.load_lora(fixture)
    with pytest.raises(RuntimeError, match="cuda"):
        hf_loader.load_hf_llama(ROOT / "tests")


def test_kernel_build_raises_without_toolchain(no_gpu, monkeypatch):
    """With no nvcc the build raises; nothing falls back."""
    from quant_gemm_tpu_torch.kernels import _build

    if _build.shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", Path("/nonexistent/qgt-build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["gemm_exact"])


def test_build_dir_is_the_checkout_or_a_user_cache(tmp_path):
    """Kernels build into the checkout's build/; an installed copy of the
    package (no pyproject.toml beside it) builds into a per-user cache."""
    code = ("from quant_gemm_tpu_torch.kernels import _build\n"
            "print(_build.BUILD_DIR)\n")
    site = tmp_path / "site"
    shutil.copytree(PKG, site / PKG.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    found = {}
    for where in (ROOT, site):
        env = dict(os.environ, PYTHONPATH=str(where),
                   XDG_CACHE_HOME=str(tmp_path / "cache"))
        out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        found[where] = out.stdout.strip()
    assert found[ROOT] == str(ROOT / "build")
    assert found[site] == str(tmp_path / "cache" / PKG.name)


def test_chip_smoke_refuses_to_run_without_gpu(no_gpu, tmp_path):
    """No GPU: non-zero exit and no result line.  Alone in a directory
    (without the package), the same."""
    env = dict(os.environ, PYTHONPATH="")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_cpu_entry_points_run_when_asked(no_gpu):
    from quant_gemm_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab=64, dim=64, n_layers=1, n_heads=2,
                            n_kv_heads=2, d_ff=128, max_seq=32)
    qp = llama.init_qparams(cfg, seed=1, device="cpu")
    cache = llama.KVCache.init(cfg, 2, device="cpu")
    logits, cache = llama.forward(qp, cfg, torch.zeros(2, 3, dtype=torch.long),
                                  cache)
    assert logits.shape == (2, 3, 64) and bool(torch.isfinite(logits).all())
    assert cache.pos.tolist() == [3, 3]
    assert np.isfinite(logits.numpy()).all()


@pytest.mark.parametrize("qtype", ["bf16", "q8"])
def test_cpu_flash_prefill_route_runs_when_asked(no_gpu, qtype):
    """A 64-token chunk takes flash_prefill, and a step decode with either
    cache; on CPU tensors every kernel wrapper runs its plain version and
    counts no launch."""
    from quant_gemm_tpu_torch.kernels import registry
    from quant_gemm_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab=64, dim=64, n_layers=1, n_heads=2,
                            n_kv_heads=2, d_ff=128, max_seq=80, window=40)
    qp = llama.init_qparams(cfg, seed=1, device="cpu")
    cache = llama.KVCache.init(cfg, 2, qtype, device="cpu")
    before = [f.launches for f in registry.KERNELS]
    for t in (64, 1):
        logits, cache = llama.forward(
            qp, cfg, torch.ones(2, t, dtype=torch.long), cache)
        assert logits.shape == (2, t, 64)
        assert bool(torch.isfinite(logits).all())
    assert cache.pos.tolist() == [65, 65]
    assert cache.quantized == (qtype == "q8")
    assert [f.launches for f in registry.KERNELS] == before


SLICE16 = ("formats.checkpoint", "models.train", "models.llama_tp",
           "parallel.sharding", "parallel.multihost", "parallel.health",
           "scripts.multihost")


def test_slice16_modules_pull_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE16!r}:\n"
        "    importlib.import_module('quant_gemm_tpu_torch.' + m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'quant_gemm_tpu'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_slice16_entry_points_default_to_cuda(no_gpu, tmp_path):
    from quant_gemm_tpu_torch.formats import checkpoint
    from quant_gemm_tpu_torch.models import llama, train
    from quant_gemm_tpu_torch.parallel import health, multihost, sharding

    cfg = llama.LlamaConfig(vocab=64, dim=64, n_layers=1, n_heads=2,
                            n_kv_heads=2, d_ff=128, max_seq=32)
    params = llama.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        train.make_state_step(params, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        sharding.make_mesh({"tp": 1})
    with pytest.raises(RuntimeError, match="cuda"):
        multihost.global_mesh({"dp": 1})
    with pytest.raises(RuntimeError, match="cuda"):
        health.check(1.0)
    checkpoint.save_npz(tmp_path / "w.npz", {"w": np.ones(4, np.float32)})
    with pytest.raises(RuntimeError, match="cuda"):
        checkpoint.load_npz(tmp_path / "w.npz")
    mesh = sharding.make_mesh({"tp": 1}, device="cpu")
    assert mesh.device.type == "cpu" and mesh.groups == {"tp": None}
    assert health.check(5.0, mesh).ok
