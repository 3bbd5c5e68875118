"""Byte-exact AoS (llama.cpp / GGUF) boundary of the per-32 block
formats under the JAX package's names (``formats/gguf.py``):
:func:`to_bytes` / :func:`from_bytes` are ``gguf_file``'s
:func:`~.gguf_file.to_block_bytes` / :func:`~.gguf_file.from_block_bytes`
(``uint8[..., nb, B]`` block bytes, B the format's ``block_bytes``), on
the tensors' device."""

from __future__ import annotations

from .gguf_file import from_block_bytes as from_bytes
from .gguf_file import to_block_bytes as to_bytes

__all__ = ["to_bytes", "from_bytes"]
