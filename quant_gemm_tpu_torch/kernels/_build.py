"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``<name>-<hash>.so`` under
:data:`BUILD_DIR` (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC``), where the hash covers the source, the shared headers and the
flags, so an edited source never loads a stale library.  The sources
expose a plain C interface and include no PyTorch header: a build takes
seconds, against minutes for ``torch.utils.cpp_extension.load``.

Binding rules (every wrapper follows them):

* every pointer and the stream are ``c_void_p``, every size ``c_int``,
  every element stride ``c_longlong``;
* kernels launch on ``torch.cuda.current_stream().cuda_stream``;
* each C entry point returns ``cudaGetLastError()``; :func:`check` raises
  when it is not 0.

A build that fails raises; nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"


def _build_dir() -> Path:
    """``build/`` of the source checkout; for an installed package, whose
    parent directory may be shared or read-only, a per-user cache."""
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").exists():
        return root / "build"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "quant_gemm_tpu_torch"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, object] = {}
#: ptxas report (registers, shared memory, spills) of each library built
#: by this process, by source name
BUILD_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "quant_gemm_tpu_torch are built on a machine with the "
                       "CUDA toolkit (PATH or CUDA_HOME)")


def source_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def compile_sources(names, out: dict, flags=NVCC_FLAGS, env=None,
                    logs=None) -> dict:
    """Compile ``csrc/<name>.cu`` to the path ``out[name]`` for each name,
    one ``nvcc`` per source, all started together (each written to a
    temporary file beside its path and renamed into place, so concurrent
    processes never see half a library).  Puts the compiler's output (the
    ``-Xptxas -v`` report) by name into ``logs`` (a new dict by default)
    and returns it; raises with the output of each source that failed."""
    nvcc = nvcc_path()
    procs = []
    for n in names:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=Path(out[n]).parent)
        os.close(fd)
        cmd = [nvcc, *flags, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env)))
    logs = {} if logs is None else logs
    failed = []
    for n, tmp, p in procs:
        log, _ = p.communicate()
        logs[n] = log
        if p.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {p.returncode}) ---\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def build(names=None) -> dict[str, float]:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` per source, all started together.  Returns the wall
    seconds of the build; raises with the compiler's output on failure."""
    names = source_names() if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {"seconds": 0.0}
    nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    compile_sources(todo, {n: _lib_path(n) for n in todo}, logs=BUILD_LOG)
    return {"seconds": time.perf_counter() - t0}


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            lib.qgt_error_string.restype = ctypes.c_char_p
            lib.qgt_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes):
    """C entry point ``symbol`` of ``csrc/<name>.cu`` with its argtypes
    (bound once per process)."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _fns[symbol] = fn
    return fn


def check(name: str, symbol: str, rc: int) -> None:
    if rc != 0:
        msg = load(name).qgt_error_string(rc).decode()
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc} ({msg})")


def check_aligned(name: str, *tensors) -> None:
    """The kernels load 16 bytes at a time: raise for a tensor whose data
    does not start on a 16-byte boundary (a view at an odd offset)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operand at {t.data_ptr():#x} is not "
                             "16-byte aligned")


def aligned16(t):
    """``t``, or a copy of it when its data does not start on 16 bytes
    (for kernels that load an operand 16 bytes at a time and take no
    view at an odd offset)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


P = ctypes.c_void_p  # pointer / stream argument type
I = ctypes.c_int
L = ctypes.c_longlong  # element strides
F = ctypes.c_float


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


__all__ = ["build", "compile_sources", "load", "function", "check",
           "check_aligned", "aligned16", "source_names", "BUILD_DIR",
           "BUILD_LOG"]
