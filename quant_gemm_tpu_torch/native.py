"""ctypes bindings for the host C++ block codec
(``csrc/host/blockcodec.cpp``).

Counterpart of ``quant_gemm_tpu/native.py``: bulk conversion at the GGUF
boundary on the host.  The library builds on first use with ``g++ -O3
-march=native -fPIC -shared -std=c++17 -fopenmp`` (without ``-fopenmp``
where the toolchain cannot link OpenMP, as on the H100 machine: the rows
then run one after another, the bits are the same) into the kernels'
``BUILD_DIR`` under a name hashed over the source, the flags and what
``-march=native`` means here (written to a temporary file and renamed
into place, so concurrent processes never load half a library); nothing
is built into a tracked path.
:func:`available` is False only when no C++ compiler is on ``PATH``; a
build that fails raises.

The functions take numpy arrays or CPU tensors and return the port's
containers of CPU tensors, bit-equal to the port's torch codecs
(``tests/test_torch_native.py``).  Nothing else in the port calls it:
``formats/kquants.py``'s byte decoders are one torch decode for CPU and
CUDA bytes alike, which never needs a compiler (JAX's route numpy bytes
through this codec).  ``chip_smoke.py`` (h5) times the three on a
TinyLlama-width Q4_K_M file's K-quant tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np
import torch

from .formats.blocks import QK, Q4_0Tensor, Q8_0Tensor, Q8_1Tensor
from .kernels import _build

SOURCE = _build.CSRC / "host" / "blockcodec.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
#: added where the toolchain links OpenMP (the rows run in parallel; the
#: bits are the same without it)
OPENMP = "-fopenmp"

_lock = threading.Lock()
_lib = None
_path = None


class NativeUnavailable(RuntimeError):
    """No C++ compiler on ``PATH``: the codec cannot be built here."""


def _compiler() -> str:
    for cxx in (os.environ.get("CXX"), "g++", "c++"):
        if cxx and shutil.which(cxx):
            return shutil.which(cxx)
    raise NativeUnavailable("no C++ compiler (g++ or c++) on PATH")


def _target(cxx: str) -> str:
    """What ``-march=native`` means on this machine (the compiler's own
    expansion), so a library built for another CPU is never loaded."""
    out = subprocess.run([cxx, "-march=native", "-E", "-v", "-x", "c++", "-"],
                         input="", capture_output=True, text=True, timeout=60)
    return "\n".join(ln for ln in out.stderr.splitlines() if "-march=" in ln)


def _lib_path(flags, target: str):
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(target.encode())
    return _build.BUILD_DIR / f"blockcodec-{h.hexdigest()[:16]}.so"


def _compile(cxx: str, flags, path):
    """Build into ``path`` (a temporary file renamed into place); the
    compiler's output when it fails, else None."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    out = subprocess.run([cxx, *flags, "-o", tmp, str(SOURCE)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        os.unlink(tmp)
        return out.stdout + out.stderr
    os.replace(tmp, path)
    return None


def _build_lib():
    """The library's (path, flags), built if needed: with OpenMP, or
    without it where the toolchain cannot link it; raises when neither
    builds."""
    cxx = _compiler()
    target = _target(cxx)
    variants = [(*CXX_FLAGS, OPENMP), CXX_FLAGS]
    paths = [_lib_path(f, target) for f in variants]
    for flags, path in zip(variants, paths):
        if path.exists():
            return path, flags
    errors = []
    for flags, path in zip(variants, paths):
        err = _compile(cxx, flags, path)
        if err is None:
            return path, flags
        errors.append(f"--- {' '.join(flags)} ---\n{err}")
    raise RuntimeError("building the block codec failed:\n"
                       + "\n".join(errors))


def library():
    """``(path, flags)`` of the codec library this process loaded (built
    at first use)."""
    _load()
    return _path


def _load():
    global _lib, _path
    with _lock:
        if _lib is not None:
            return _lib
        path = _build_lib()
        lib = ctypes.CDLL(str(path[0]))
        i64 = ctypes.c_int64
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        sigs = {
            "qgt_quantize_q4_0": [f32p, i64, i64, u8p, u16p],
            "qgt_quantize_q8_0": [f32p, i64, i64, i8p, u16p],
            "qgt_quantize_q8_1": [f32p, i64, i64, i8p, u16p, u16p],
            "qgt_dequantize_q4_0": [u8p, u16p, i64, i64, f32p],
            "qgt_dequantize_q8_0": [i8p, u16p, i64, i64, f32p],
            "qgt_q4_0_aos_to_planar": [u8p, i64, i64, u8p, u16p],
            "qgt_q4_0_planar_to_aos": [u8p, u16p, i64, i64, u8p],
            "qgt_q4_k_aos_to_planar": [u8p, i64, i64, u8p, u16p, u16p, u8p,
                                       u8p],
            "qgt_q5_k_aos_to_planar": [u8p, i64, i64, u8p, u8p, u16p, u16p,
                                       u8p, u8p],
            "qgt_q6_k_aos_to_soa": [u8p, i64, i64, u16p, i8p, i8p],
            "qgt_q2_k_aos_to_soa": [u8p, i64, i64, u16p, u16p, u8p, u8p,
                                    i8p],
            "qgt_q3_k_aos_to_soa": [u8p, i64, i64, u16p, i8p, i8p],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        lib.qgt_version.restype = ctypes.c_int
        lib.qgt_version.argtypes = []
        _lib, _path = lib, path
        return lib


def _version() -> int:
    try:
        return _load().qgt_version()
    except NativeUnavailable:
        return 0


def available() -> bool:
    """True when the codec is built or can be (a C++ compiler on PATH)."""
    return _version() >= 1


def kquants_available() -> bool:
    return _version() >= 2


def q6k_available() -> bool:
    return _version() >= 3


def k16_available() -> bool:
    """The per-16 K-quant decoders (q2_K / q3_K / q6_K) are there."""
    return _version() >= 4


def _np(x, dtype) -> np.ndarray:
    """A C-contiguous numpy array of ``x`` (numpy, or a CPU tensor)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"the host codec takes CPU tensors, not "
                             f"{x.device}")
        x = x.detach().numpy()
    return np.ascontiguousarray(x, dtype)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _2d(x) -> np.ndarray:
    x = _np(x, np.float32)
    if x.ndim != 2 or x.shape[1] % QK:
        raise ValueError(f"takes float [rows, K], K % {QK} == 0, got "
                         f"{x.shape}")
    return x


def quantize_q4_0(x) -> Q4_0Tensor:
    x = _2d(x)
    rows, k = x.shape
    packed = np.zeros((rows, k // 2), np.uint8)
    d = np.empty((rows, k // QK), np.uint16)
    _load().qgt_quantize_q4_0(x, rows, k, packed, d)
    return Q4_0Tensor(*_t(packed, d.view(np.float16)))


def quantize_q8_0(x) -> Q8_0Tensor:
    x = _2d(x)
    rows, k = x.shape
    qs = np.empty((rows, k), np.int8)
    d = np.empty((rows, k // QK), np.uint16)
    _load().qgt_quantize_q8_0(x, rows, k, qs, d)
    return Q8_0Tensor(*_t(qs, d.view(np.float16)))


def quantize_q8_1(x) -> Q8_1Tensor:
    x = _2d(x)
    rows, k = x.shape
    qs = np.empty((rows, k), np.int8)
    d = np.empty((rows, k // QK), np.uint16)
    s = np.empty((rows, k // QK), np.uint16)
    _load().qgt_quantize_q8_1(x, rows, k, qs, d, s)
    return Q8_1Tensor(*_t(qs, d.view(np.float16), s.view(np.float16)))


def _f16_bits(d) -> np.ndarray:
    return _np(d, np.float16).view(np.uint16)


def dequantize(t) -> torch.Tensor:
    """float32 [rows, K] of a q4_0, q8_0 or q8_1 container."""
    lib = _load()
    if isinstance(t, Q4_0Tensor):
        packed = _np(t.packed, np.uint8)
        rows, kh = packed.shape
        out = np.empty((rows, kh * 2), np.float32)
        lib.qgt_dequantize_q4_0(packed, _f16_bits(t.d), rows, kh * 2, out)
        return torch.from_numpy(out)
    if isinstance(t, (Q8_0Tensor, Q8_1Tensor)):
        qs = _np(t.qs, np.int8)
        rows, k = qs.shape
        out = np.empty((rows, k), np.float32)
        lib.qgt_dequantize_q8_0(qs, _f16_bits(t.d), rows, k, out)
        return torch.from_numpy(out)
    raise TypeError(f"the host codec dequantizes q4_0, q8_0 and q8_1, not "
                    f"{type(t).__name__}")


def _aos(aos, block_bytes: int) -> np.ndarray:
    aos = _np(aos, np.uint8)
    if aos.ndim != 3 or aos.shape[2] != block_bytes:
        raise ValueError(f"takes blocks [rows, nb, {block_bytes}], got "
                         f"{aos.shape}")
    return aos


def q4_0_from_aos(aos) -> Q4_0Tensor:
    """AoS block bytes [rows, nb, 18] -> planar container (GGUF import)."""
    aos = _aos(aos, 18)
    rows, nb, _ = aos.shape
    k = nb * QK
    packed = np.zeros((rows, k // 2), np.uint8)
    d = np.empty((rows, nb), np.uint16)
    _load().qgt_q4_0_aos_to_planar(aos, rows, k, packed, d)
    return Q4_0Tensor(*_t(packed, d.view(np.float16)))


def q4_0_to_aos(t: Q4_0Tensor) -> torch.Tensor:
    """Planar container -> AoS block bytes u8 [rows, nb, 18]."""
    packed = _np(t.packed, np.uint8)
    rows, kh = packed.shape
    aos = np.empty((rows, kh * 2 // QK, 18), np.uint8)
    _load().qgt_q4_0_planar_to_aos(packed, _f16_bits(t.d), rows, kh * 2, aos)
    return torch.from_numpy(aos)


def q4_k_from_aos(aos):
    """AoS block_q4_K bytes [rows, nsb, 144] -> ``Q4_KTensor``."""
    from .formats.kquants import QK_K, Q4_KTensor

    aos = _aos(aos, 144)
    rows, nsb, _ = aos.shape
    k = nsb * QK_K
    packed = np.zeros((rows, k // 2), np.uint8)
    d = np.empty((rows, nsb), np.uint16)
    dmin = np.empty((rows, nsb), np.uint16)
    ls = np.empty((rows, nsb * 8), np.uint8)
    lm = np.empty((rows, nsb * 8), np.uint8)
    _load().qgt_q4_k_aos_to_planar(aos, rows, k, packed, d, dmin, ls, lm)
    return Q4_KTensor(*_t(d.view(np.float16), dmin.view(np.float16), ls, lm,
                          packed))


def q5_k_from_aos(aos):
    """AoS block_q5_K bytes [rows, nsb, 176] -> ``Q5_KTensor``."""
    from .formats.kquants import QK_K, Q5_KTensor

    aos = _aos(aos, 176)
    rows, nsb, _ = aos.shape
    k = nsb * QK_K
    packed = np.zeros((rows, k // 2), np.uint8)
    qh = np.zeros((rows, k // 8), np.uint8)
    d = np.empty((rows, nsb), np.uint16)
    dmin = np.empty((rows, nsb), np.uint16)
    ls = np.empty((rows, nsb * 8), np.uint8)
    lm = np.empty((rows, nsb * 8), np.uint8)
    _load().qgt_q5_k_aos_to_planar(aos, rows, k, packed, qh, d, dmin, ls, lm)
    return Q5_KTensor(*_t(d.view(np.float16), dmin.view(np.float16), ls, lm,
                          packed, qh))


def q6_k_from_aos(aos):
    """AoS block_q6_K bytes [rows, nsb, 210] -> ``Q6_KTensor``."""
    from .formats.kquants import QK_K, Q6_KTensor

    aos = _aos(aos, 210)
    rows, nsb, _ = aos.shape
    k = nsb * QK_K
    d = np.empty((rows, nsb), np.uint16)
    sc = np.empty((rows, nsb * 16), np.int8)
    qs = np.empty((rows, k), np.int8)
    _load().qgt_q6_k_aos_to_soa(aos, rows, k, d, sc, qs)
    return Q6_KTensor(*_t(d.view(np.float16), sc, qs))


def q2_k_from_aos(aos):
    """AoS block_q2_K bytes [rows, nsb, 84] -> ``Q2_KTensor``."""
    from .formats.kquants import QK_K, Q2_KTensor

    aos = _aos(aos, 84)
    rows, nsb, _ = aos.shape
    k = nsb * QK_K
    d = np.empty((rows, nsb), np.uint16)
    dmin = np.empty((rows, nsb), np.uint16)
    sc = np.empty((rows, nsb * 16), np.uint8)
    mn = np.empty((rows, nsb * 16), np.uint8)
    qs = np.empty((rows, k), np.int8)
    _load().qgt_q2_k_aos_to_soa(aos, rows, k, d, dmin, sc, mn, qs)
    return Q2_KTensor(*_t(d.view(np.float16), dmin.view(np.float16), sc, mn,
                          qs))


def q3_k_from_aos(aos):
    """AoS block_q3_K bytes [rows, nsb, 110] -> ``Q3_KTensor``."""
    from .formats.kquants import QK_K, Q3_KTensor

    aos = _aos(aos, 110)
    rows, nsb, _ = aos.shape
    k = nsb * QK_K
    d = np.empty((rows, nsb), np.uint16)
    sc = np.empty((rows, nsb * 16), np.int8)
    qs = np.empty((rows, k), np.int8)
    _load().qgt_q3_k_aos_to_soa(aos, rows, k, d, sc, qs)
    return Q3_KTensor(*_t(d.view(np.float16), sc, qs))


__all__ = [
    "available",
    "kquants_available",
    "quantize_q4_0",
    "quantize_q8_0",
    "quantize_q8_1",
    "dequantize",
    "q4_0_from_aos",
    "q4_0_to_aos",
    "q4_k_from_aos",
    "q5_k_from_aos",
    "q6_k_from_aos",
    "q6k_available",
    "q2_k_from_aos",
    "q3_k_from_aos",
    "k16_available",
    "NativeUnavailable",
    "SOURCE",
    "CXX_FLAGS",
    "OPENMP",
    "library",
]
