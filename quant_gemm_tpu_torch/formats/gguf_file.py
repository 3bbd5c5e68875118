"""GGUF v3 container reader and writer (the port's own copy).

Counterpart of the JAX package's ``formats/gguf_file.py``: the same
parsing of the header, metadata and tensor table, the same ``raw`` view of
a tensor's bytes (a numpy memmap, so a multi-GB file pages in lazily), and
a writer that lays files out the same way.  :meth:`GGUFFile.load` moves a
tensor's bytes to a torch device and decodes them there into the port's
containers:

    magic 'GGUF' | version u32 | n_tensors u64 | n_kv u64
    kv*: key(str) type(u32) value          (str = u64 len + bytes)
    tensor-info*: name(str) n_dims(u32) dims(u64*) ggml_type(u32) offset(u64)
    padding to `general.alignment` (default 32) | tensor data blob

Types read and written: f32, f16, q4_0, q4_1, q5_0, q5_1, q8_0
(:mod:`.blocks` containers) and q4_K, q5_K, q6_K, q2_K, q3_K
(:mod:`.kquants`); iq4_nl and iq4_xs tensors are read (into a
``Q8_0Tensor`` and a ``kquants.EffectiveQ80``, as the JAX package reads
them) and written from their bytes (:class:`RawTensor`).  q8_1, the
other ggml type of the table, raises ``NotImplementedError`` with its
name.
"""

from __future__ import annotations

import functools
import struct
from typing import Any, BinaryIO

import numpy as np
import torch

from ..utils import resolve_device
from . import kquants
from .blocks import (QK, Q4_0Tensor, Q4_1Tensor, Q5_0Tensor, Q5_1Tensor,
                     Q8_0Tensor, Q8_1Tensor)
from .quant import pack_planar_4bit, unpack_planar_4bit

MAGIC = b"GGUF"
VERSION = 3
DEFAULT_ALIGNMENT = 32

GGML_TYPES = {0: "f32", 1: "f16", 2: "q4_0", 3: "q4_1", 6: "q5_0", 7: "q5_1",
              8: "q8_0", 9: "q8_1", 10: "q2_K", 11: "q3_K", 12: "q4_K",
              13: "q5_K", 14: "q6_K", 20: "iq4_nl", 23: "iq4_xs"}
GGML_IDS = {v: k for k, v in GGML_TYPES.items()}

#: bytes per block and elements per block of the types this module reads
_BLOCK = {"f32": (4, 1), "f16": (2, 1), "q4_0": (18, QK), "q4_1": (20, QK),
          "q5_0": (22, QK), "q5_1": (24, QK), "q8_0": (34, QK),
          "iq4_nl": (kquants.IQ4_NL_BLOCK_BYTES, QK),
          "iq4_xs": (kquants.IQ4_XS_BLOCK_BYTES, kquants.QK_K),
          **{n: (c[0], kquants.QK_K) for n, c in kquants.CODECS.items()}}

# GGUF metadata value types
_KV_FMT = {0: "<B", 1: "<b", 2: "<H", 3: "<h", 4: "<I", 5: "<i", 6: "<f",
           7: "<?", 10: "<Q", 11: "<q", 12: "<d"}
_KV_STRING = 8
_KV_ARRAY = 9


def _read_str(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8")


def _write_str(f: BinaryIO, s: str) -> None:
    b = s.encode("utf-8")
    f.write(struct.pack("<Q", len(b)))
    f.write(b)


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype in _KV_FMT:
        fmt = _KV_FMT[vtype]
        return struct.unpack(fmt, f.read(struct.calcsize(fmt)))[0]
    if vtype == _KV_STRING:
        return _read_str(f)
    if vtype == _KV_ARRAY:
        (etype,) = struct.unpack("<I", f.read(4))
        (n,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, etype) for _ in range(n)]
    raise ValueError(f"unknown GGUF kv type {vtype}")


def _kv_type_of(v: Any) -> int:
    if isinstance(v, bool):
        return 7
    if isinstance(v, int):
        return 11  # i64
    if isinstance(v, float):
        return 12  # f64
    if isinstance(v, str):
        return _KV_STRING
    if isinstance(v, (list, tuple)):
        return _KV_ARRAY
    raise TypeError(type(v))


def _write_value(f: BinaryIO, v: Any) -> None:
    t = _kv_type_of(v)
    if t == _KV_STRING:
        _write_str(f, v)
    elif t == _KV_ARRAY:
        # homogeneous array, as llama.cpp writes them: strings, f32 when
        # any entry is a float, else i32 (also for an empty array)
        if v and any(isinstance(e, str) for e in v):
            if not all(isinstance(e, str) for e in v):
                raise TypeError(f"mixed str/non-str metadata array: {v!r}")
            etype = _KV_STRING
        elif any(isinstance(e, (float, np.floating)) for e in v):
            etype = 6
        else:
            etype = 5
        f.write(struct.pack("<I", etype))
        f.write(struct.pack("<Q", len(v)))
        for e in v:
            if etype == _KV_STRING:
                _write_str(f, e)
            elif etype == 6:
                f.write(struct.pack("<f", float(e)))
            else:
                f.write(struct.pack("<i", int(e)))
    else:
        f.write(struct.pack(_KV_FMT[t], v))


def _readable(qtype: str) -> None:
    if qtype not in _BLOCK:
        raise NotImplementedError(
            f"GGUF tensor type {qtype} is not ported (the port reads "
            f"{', '.join(_BLOCK)})")


def tensor_nbytes(qtype: str, n_elems: int) -> int:
    _readable(qtype)
    nbytes, per = _BLOCK[qtype]
    if n_elems % per:
        raise ValueError(f"{n_elems} elements are not whole {qtype} blocks")
    return n_elems // per * nbytes


# -- 32-element block codecs (ggml-common.h block_q4_0 .. block_q8_0) on
# torch tensors.  A block is its f16 d, then (q4_1, q5_1) its f16 m, then
# (q5) its 4-byte qh, bit j the fifth bit of code j, then its codes: 16
# bytes with byte j = code j | code j+16 << 4 (the low four bits), or 32
# int8 codes (q8_0).  A q5 block's qh bytes are the planar container's
# bytes 4b .. 4b+3 unchanged (bit c % 8 of byte c // 8 is code c's).

#: per-32 GGUF type -> (container, has m, has qh)
_PER32 = {"q4_0": (Q4_0Tensor, False, False),
          "q4_1": (Q4_1Tensor, True, False),
          "q5_0": (Q5_0Tensor, False, True),
          "q5_1": (Q5_1Tensor, True, True)}


def _per32_from_bytes(qt: str, raw: torch.Tensor):
    """u8 [N, K/32, bytes] -> the planar container of ``qt``."""
    cls, has_m, has_qh = _PER32[qt]
    n, nb, _ = raw.shape
    fields = {"d": kquants._f16(raw, 0)}
    at = 2
    if has_m:
        fields["m"] = kquants._f16(raw, 2)
        at = 4
    if has_qh:
        fields["qh"] = raw[:, :, at:at + 4].reshape(n, nb * 4)
        at += 4
    qs = raw[:, :, at:at + 16]
    codes = torch.cat([qs & 0x0F, qs >> 4], dim=-1).reshape(n, nb * QK)
    return cls(packed=pack_planar_4bit(codes), **fields)


def _per32_to_bytes(qt: str, t) -> torch.Tensor:
    _, has_m, has_qh = _PER32[qt]
    n = t.packed.shape[0]
    q = unpack_planar_4bit(t.packed).reshape(n, -1, QK)
    nb = q.shape[1]
    parts = [kquants._f16_bytes(t.d.reshape(n, nb))]
    if has_m:
        parts.append(kquants._f16_bytes(t.m.reshape(n, nb)))
    if has_qh:
        parts.append(t.qh.reshape(n, nb, 4).to(torch.uint8))
    parts.append(q[..., :16] | (q[..., 16:] << 4))
    return torch.cat(parts, dim=-1)


def _q8_0_from_bytes(raw: torch.Tensor) -> Q8_0Tensor:
    n, nb, _ = raw.shape
    qs = raw[:, :, 2:34].contiguous().view(torch.int8).reshape(n, nb * QK)
    return Q8_0Tensor(qs, kquants._f16(raw, 0))


def _q8_0_to_bytes(t: Q8_0Tensor) -> torch.Tensor:
    n = t.qs.shape[0]
    q = t.qs.to(torch.int8).contiguous().view(torch.uint8).reshape(n, -1, QK)
    return torch.cat([kquants._f16_bytes(t.d.reshape(n, q.shape[1])), q],
                     dim=-1)


def _q8_1_from_bytes(raw: torch.Tensor) -> Q8_1Tensor:
    n, nb, _ = raw.shape
    qs = raw[:, :, 4:36].contiguous().view(torch.int8).reshape(n, nb * QK)
    return Q8_1Tensor(qs, kquants._f16(raw, 0), kquants._f16(raw, 2))


def _q8_1_to_bytes(t: Q8_1Tensor) -> torch.Tensor:
    n = t.qs.shape[0]
    q = t.qs.to(torch.int8).contiguous().view(torch.uint8).reshape(n, -1, QK)
    nb = q.shape[1]
    return torch.cat([kquants._f16_bytes(t.d.reshape(n, nb)),
                      kquants._f16_bytes(t.s.reshape(n, nb)), q], dim=-1)


_DECODE = {"q8_0": _q8_0_from_bytes,
           "iq4_nl": kquants.from_bytes_iq4_nl,
           "iq4_xs": kquants.from_bytes_iq4_xs,
           **{qt: functools.partial(_per32_from_bytes, qt) for qt in _PER32},
           **{n: c[1] for n, c in kquants.CODECS.items()}}
_ENCODE = {"q8_0": _q8_0_to_bytes,
           **{qt: functools.partial(_per32_to_bytes, qt) for qt in _PER32},
           **{n: c[2] for n, c in kquants.CODECS.items()}}
#: container type -> GGUF type name, for the writer
_GGUF_TYPE = {Q8_0Tensor: "q8_0",
              **{c[0]: qt for qt, c in _PER32.items()},
              **kquants.GGUF_TYPE}


def to_block_bytes(t) -> torch.Tensor:
    """A per-32 container (q4_0, q4_1, q5_0, q5_1, q8_0, q8_1) of ``[...,
    K]`` -> its ggml block bytes ``uint8 [..., K/32, B]`` (B the format's
    ``block_bytes``), on its device."""
    qt = t.spec.name
    codes = t.qs if hasattr(t, "qs") else t.packed
    flat = type(t)(*(x.reshape(-1, x.shape[-1]) for x in t))
    raw = (_q8_1_to_bytes if qt == "q8_1" else _ENCODE[qt])(flat)
    return raw.reshape(*codes.shape[:-1], *raw.shape[1:])


def from_block_bytes(raw: torch.Tensor, qtype: str):
    """ggml block bytes ``uint8 [..., nb, B]`` -> the per-32 container of
    ``qtype`` (q4_0, q4_1, q5_0, q5_1, q8_0, q8_1) of ``[..., nb * 32]``."""
    lead = raw.shape[:-2]
    flat = raw.reshape(-1, *raw.shape[-2:])
    t = (_q8_1_from_bytes if qtype == "q8_1" else _DECODE[qtype])(flat)
    return type(t)(*(x.reshape(*lead, x.shape[-1]) for x in t))


class GGUFFile:
    """Parsed GGUF container: ``metadata`` dict + lazy tensor access."""

    def __init__(self, path):
        self.path = path
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, dict] = {}  # name -> {shape, qtype, offset}
        with open(path, "rb") as f:
            magic = f.read(4)
            if magic != MAGIC:
                raise ValueError(f"not a GGUF file (magic {magic!r})")
            (version,) = struct.unpack("<I", f.read(4))
            if version not in (2, 3):
                raise ValueError(f"unsupported GGUF version {version}")
            n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
            for _ in range(n_kv):
                key = _read_str(f)
                (vtype,) = struct.unpack("<I", f.read(4))
                self.metadata[key] = _read_value(f, vtype)
            for _ in range(n_tensors):
                name = _read_str(f)
                (nd,) = struct.unpack("<I", f.read(4))
                dims = struct.unpack(f"<{nd}Q", f.read(8 * nd))
                ggml_type, offset = struct.unpack("<IQ", f.read(12))
                if ggml_type not in GGML_TYPES:
                    raise ValueError(f"unsupported ggml type {ggml_type} for "
                                     f"{name}")
                # GGUF dims are reversed (ne[0] = innermost = K)
                self.tensors[name] = {"shape": tuple(reversed(dims)),
                                      "qtype": GGML_TYPES[ggml_type],
                                      "offset": offset}
            align = int(self.metadata.get("general.alignment",
                                          DEFAULT_ALIGNMENT))
            self._data_start = (f.tell() + align - 1) // align * align
        self._mm = None

    def close(self) -> None:
        """Release the memory map (loaded tensors are copies of it)."""
        self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def raw(self, name: str) -> np.ndarray:
        """Zero-copy view of one tensor's payload bytes (memmap-backed; it
        aliases the file until :meth:`close`)."""
        info = self.tensors[name]
        nbytes = tensor_nbytes(info["qtype"], int(np.prod(info["shape"])))
        if self._mm is None:
            self._mm = np.memmap(self.path, np.uint8, mode="r")
        off = self._data_start + info["offset"]
        return np.asarray(self._mm[off:off + nbytes])

    def load(self, name: str, device="cuda"):
        """One tensor on ``device``: a float tensor (f32/f16) or a block
        container (q4_0, q4_1, q5_0, q5_1, q8_0, q4_K, q5_K, q6_K, q2_K,
        q3_K; iq4_nl as a Q8_0Tensor, iq4_xs as a ``kquants.
        EffectiveQ80``), decoded there."""
        info = self.tensors[name]
        shape, qt = info["shape"], info["qtype"]
        _readable(qt)
        dev = resolve_device(device)
        buf = torch.from_numpy(np.array(self.raw(name))).to(dev)
        if qt in ("f32", "f16"):
            dt = torch.float32 if qt == "f32" else torch.float16
            return buf.view(dt).reshape(shape)
        if len(shape) != 2:
            raise ValueError(f"{name}: block tensors are 2-D, got {shape}")
        nbytes, per = _BLOCK[qt]
        return _DECODE[qt](buf.reshape(shape[0], shape[1] // per, nbytes))


class RawTensor:
    """A tensor's serialized ggml blocks for :func:`write_gguf`, written
    verbatim: ``data`` the payload (bytes, or a uint8 tensor on any
    device) of ``qtype`` blocks for a tensor of ``shape`` (the JAX
    package's ``RawTensor``; how the port writes iq4_nl / iq4_xs)."""

    def __init__(self, qtype: str, shape: tuple, data):
        if qtype not in GGML_IDS:
            raise ValueError(f"unknown ggml type {qtype!r}")
        self.qtype, self.shape = qtype, tuple(shape)
        self.data = (data if isinstance(data, torch.Tensor)
                     else torch.frombuffer(bytearray(data), dtype=torch.uint8))
        want = tensor_nbytes(qtype, int(np.prod(self.shape)))
        if self.data.numel() != want:
            raise ValueError(f"{qtype} {self.shape} takes {want} bytes, got "
                             f"{self.data.numel()}")


def _info(t):
    """(GGUF type, shape) of one tensor to write."""
    if isinstance(t, RawTensor):
        return t.qtype, t.shape
    if isinstance(t, torch.Tensor):
        qt = {torch.float32: "f32", torch.float16: "f16"}.get(t.dtype)
        if qt is None:
            raise TypeError(f"write_gguf writes f32/f16 tensors, not "
                            f"{t.dtype}")
        return qt, tuple(t.shape)
    qt = _GGUF_TYPE.get(type(t))
    if qt is None:
        raise NotImplementedError(f"write_gguf: {type(t).__name__} is not a "
                                  "ported format")
    codes = t.qs if hasattr(t, "qs") else t.packed
    return qt, (codes.shape[0], t.k)


def _encode(t, qt: str) -> np.ndarray:
    """The serialized bytes of one tensor (encoded on its device)."""
    if isinstance(t, RawTensor):
        data = t.data
    elif isinstance(t, torch.Tensor):
        data = t.contiguous().view(torch.uint8)
    else:
        data = _ENCODE[qt](t)
    return data.cpu().contiguous().numpy()


def write_gguf(path, tensors: dict, metadata: dict | None = None) -> None:
    """Write float tensors and block containers to a GGUF v3 file.

    ``tensors``: {name: float32/float16 tensor | a per-32 container
    (Q4_0Tensor, Q4_1Tensor, Q5_0Tensor, Q5_1Tensor, Q8_0Tensor) | a
    K-quant container (Q4_KTensor, Q5_KTensor, Q6_KTensor, Q2_KTensor,
    Q3_KTensor) | a :class:`RawTensor`} of torch tensors on any device;
    each is encoded on its device and written in turn."""
    metadata = dict(metadata or {})
    metadata.setdefault("general.alignment", DEFAULT_ALIGNMENT)
    align = int(metadata["general.alignment"])

    def padded(n):
        return (n + align - 1) // align * align

    table = [(name, *_info(t)) for name, t in tensors.items()]
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", VERSION))
        f.write(struct.pack("<QQ", len(table), len(metadata)))
        for k, v in metadata.items():
            _write_str(f, k)
            f.write(struct.pack("<I", _kv_type_of(v)))
            _write_value(f, v)
        offset = 0
        for name, qt, shape in table:
            _write_str(f, name)
            dims = tuple(reversed(shape))
            f.write(struct.pack("<I", len(dims)))
            f.write(struct.pack(f"<{len(dims)}Q", *dims))
            f.write(struct.pack("<IQ", GGML_IDS[qt], offset))
            offset += padded(tensor_nbytes(qt, int(np.prod(shape))))
        f.write(b"\0" * (padded(f.tell()) - f.tell()))
        for (name, qt, shape), t in zip(table, tensors.values()):
            data = _encode(t, qt)
            if data.nbytes != tensor_nbytes(qt, int(np.prod(shape))):
                raise AssertionError(f"{name}: encoded {data.nbytes} bytes")
            f.write(memoryview(data.reshape(-1)))
            f.write(b"\0" * (padded(data.nbytes) - data.nbytes))


__all__ = ["GGUFFile", "write_gguf", "RawTensor", "GGML_TYPES",
           "tensor_nbytes", "to_block_bytes", "from_block_bytes"]
