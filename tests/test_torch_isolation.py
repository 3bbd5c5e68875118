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
        "assert len(mods) >= 15, mods\n"
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
