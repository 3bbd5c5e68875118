r"""Tokenizers from a GGUF file's embedded vocabulary (the port's copy of
the JAX package's ``models/tokenizer.py``).

llama.cpp models carry their tokenizer inside the GGUF
(``tokenizer.ggml.{model,tokens,scores,token_type,bos/eos_token_id}``).
:class:`SPMTokenizer` is llama.cpp's ``llm_tokenizer_spm`` (greedy merges
of adjacent symbol pairs by vocab score, byte fallback);
:class:`BPETokenizer` the GPT-2-style byte-level BPE of ``tokenizer.ggml.
model == "gpt2"`` files (Llama-3, Qwen2), with the pretokenizer llama.cpp
selects by ``tokenizer.ggml.pre``; :func:`tokenizer_from_gguf` picks
one.  :func:`encode_with_specials` and :func:`render_chat` serve the chat
path (``jinja2`` is imported only there).

The JAX package splits BPE text with the ``regex`` module's ``\p{L}`` /
``\p{N}`` patterns.  This copy needs no ``regex``: the same patterns are
written for the standard library's ``re`` with the classes spelled out
(:func:`_classes`): letters and numbers from ``unicodedata`` categories
(L*, N*), plus those assigned in the Unicode versions after the
interpreter's database (:data:`_LATER_LETTERS`, :data:`_LATER_NUMBERS`),
and whitespace as Unicode's White_Space property, which ``\s`` matches
in ``regex`` (``re``'s ``\s`` and ``str.isspace`` also take U+001C to
U+001F); the contractions of ``(?i:'s|...)`` as the case pairs ``regex``
folds them to (``'s`` also ``'\u017f``, the long s).  The splits are
equal to JAX's on every string (``tests/test_torch_tokenizer.py``).
"""

from __future__ import annotations

import functools
from typing import Sequence

_SPACE = "▁"  # SentencePiece space marker

# tokenizer.ggml.token_type values (llama.cpp llama_token_type)
TOKEN_NORMAL = 1
TOKEN_UNKNOWN = 2
TOKEN_CONTROL = 3
TOKEN_USER_DEFINED = 4
TOKEN_BYTE = 6

# token types llama.cpp's tokenizer_st_partition treats as matchable
# specials (LLAMA_TOKEN_ATTR_CONTROL | USER_DEFINED | UNKNOWN): GGUFs often
# mark chat markers like <|im_start|> as USER_DEFINED rather than CONTROL.
SPECIAL_TOKEN_TYPES = frozenset(
    (TOKEN_UNKNOWN, TOKEN_CONTROL, TOKEN_USER_DEFINED)
)


class SPMTokenizer:
    def __init__(
        self,
        tokens: Sequence[str],
        scores: Sequence[float],
        token_types: Sequence[int] | None = None,
        bos_id: int = 1,
        eos_id: int = 2,
        unk_id: int = 0,
        add_space_prefix: bool = True,
    ):
        self.tokens = list(tokens)
        self.scores = list(scores)
        self.token_types = (
            list(token_types) if token_types is not None
            else [TOKEN_NORMAL] * len(tokens)
        )
        self.bos_id, self.eos_id, self.unk_id = bos_id, eos_id, unk_id
        self.add_space_prefix = add_space_prefix
        self.vocab = {t: i for i, t in enumerate(self.tokens)}
        # byte-fallback table: token "<0xAB>" (type BYTE) -> byte value
        self.byte_tokens = {}
        for i, (t, tt) in enumerate(zip(self.tokens, self.token_types)):
            if tt == TOKEN_BYTE and len(t) == 6 and t[:3] == "<0x":
                self.byte_tokens[int(t[3:5], 16)] = i

    @classmethod
    def from_gguf(cls, metadata: dict) -> "SPMTokenizer":
        model = metadata.get("tokenizer.ggml.model", "llama")
        if model not in ("llama", "spm"):
            raise ValueError(
                f"tokenizer.ggml.model={model!r} is not SPM — use "
                "tokenizer_from_gguf (routes 'gpt2' to BPETokenizer)"
            )
        tokens = metadata["tokenizer.ggml.tokens"]
        scores = metadata.get("tokenizer.ggml.scores", [0.0] * len(tokens))
        return cls(
            tokens,
            scores,
            metadata.get("tokenizer.ggml.token_type"),
            bos_id=int(metadata.get("tokenizer.ggml.bos_token_id", 1)),
            eos_id=int(metadata.get("tokenizer.ggml.eos_token_id", 2)),
            unk_id=int(metadata.get("tokenizer.ggml.unknown_token_id", 0)),
            add_space_prefix=bool(
                metadata.get("tokenizer.ggml.add_space_prefix", True)
            ),
        )

    # -- encode ------------------------------------------------------------

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        """SPM greedy merge (llm_tokenizer_spm): a heap of candidate
        bigrams ordered by (score, position) over a linked list of symbols
        — O(n log n), matching llama.cpp's result exactly — then byte
        fallback for any symbol not in the vocab."""
        import heapq

        s = text.replace(" ", _SPACE)
        if self.add_space_prefix and not s.startswith(_SPACE):
            s = _SPACE + s
        syms = list(s)
        n = len(syms)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        alive = [True] * n

        heap: list[tuple[float, int, str]] = []

        def push(i):
            j = nxt[i]
            if j >= n:
                return
            tid = self.vocab.get(syms[i] + syms[j])
            if tid is not None:
                heapq.heappush(heap, (-self.scores[tid], i, syms[i] + syms[j]))

        for i in range(n - 1):
            push(i)
        while heap:
            _negsc, i, merged = heapq.heappop(heap)
            j = nxt[i] if i < n else n
            # stale if either side changed since this candidate was pushed
            if i >= n or not alive[i] or j >= n or syms[i] + syms[j] != merged:
                continue
            syms[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] < n:
                prev[nxt[j]] = i
            if prev[i] >= 0:
                push(prev[i])
            push(i)

        out = [self.bos_id] if add_bos else []
        i = 0
        while i < n:
            if not alive[i]:
                i = nxt[i]
                continue
            sym = syms[i]
            tid = self.vocab.get(sym)
            if tid is not None:
                out.append(tid)
            else:
                for b in sym.encode("utf-8"):  # byte fallback
                    out.append(self.byte_tokens.get(b, self.unk_id))
            i = nxt[i]
        return out

    # -- decode ------------------------------------------------------------

    def decode(self, ids: Sequence[int]) -> str:
        """Token ids -> text: byte tokens collect into raw bytes, normal
        pieces concatenate with the space marker restored.  The leading
        space is stripped ONLY when the first decoded piece carries the
        add_space_prefix marker (so decoding a continuation — ids that
        don't start a text — keeps its real leading space)."""
        chunks: list[bytes] = []
        first_piece = None
        for tid in ids:
            if not 0 <= tid < len(self.tokens):
                continue
            tt = self.token_types[tid]
            if tt == TOKEN_CONTROL:
                continue  # <s>, </s>, ...
            t = self.tokens[tid]
            if tt == TOKEN_BYTE and len(t) == 6 and t[:3] == "<0x":
                chunks.append(bytes([int(t[3:5], 16)]))
                if first_piece is None:
                    first_piece = ""
            else:
                chunks.append(t.replace(_SPACE, " ").encode("utf-8"))
                if first_piece is None:
                    first_piece = t
        text = b"".join(chunks).decode("utf-8", errors="replace")
        strip = (self.add_space_prefix and first_piece is not None
                 and first_piece.startswith(_SPACE))
        return text[1:] if strip and text.startswith(" ") else text


__all__ = ["SPMTokenizer", "TOKEN_NORMAL", "TOKEN_UNKNOWN", "TOKEN_CONTROL",
           "TOKEN_USER_DEFINED", "SPECIAL_TOKEN_TYPES",
           "TOKEN_BYTE"]


# ---------------------------------------------------------------------------
# GPT-2-style byte-level BPE (tokenizer.ggml.model == "gpt2": Llama-3,
# Qwen-class GGUFs). llama.cpp: llm_tokenizer_bpe with per-model
# pretokenizer regexes selected by tokenizer.ggml.pre.
# ---------------------------------------------------------------------------


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_B2U = _bytes_to_unicode()
_U2B = {u: b for b, u in _B2U.items()}

# The classes below are built for these two Unicode versions: the
# ``unicodedata`` of Python 3.12 gives the categories, and the tables add
# what the ``regex`` module's \p{L} / \p{N} held on top of it in its
# release 2026.7.19 (Unicode 17.0).  tests/test_torch_tokenizer.py fails
# when either differs.
UNIDATA_VERSION = "15.0.0"
REGEX_UNICODE_VERSION = "17.0.0"
# the letters and numbers of Unicode 15.1 to 17.0 (after unicodedata's
# 15.0): code point ranges, inclusive
_LATER_LETTERS = (
    (0x088F, 0x088F), (0x0C5C, 0x0C5C), (0x0CDC, 0x0CDC), (0x1C89, 0x1C8A),
    (0xA7CB, 0xA7CF), (0xA7D2, 0xA7D2), (0xA7D4, 0xA7D4), (0xA7DA, 0xA7DC),
    (0xA7F1, 0xA7F1), (0x105C0, 0x105F3), (0x10940, 0x10959),
    (0x10D4A, 0x10D65), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC7),
    (0x11380, 0x11389), (0x1138B, 0x1138B), (0x1138E, 0x1138E),
    (0x11390, 0x113B5), (0x113B7, 0x113B7), (0x113D1, 0x113D1),
    (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x11DB0, 0x11DDB),
    (0x13460, 0x143FA), (0x16100, 0x1611D), (0x16D40, 0x16D6C),
    (0x16EA0, 0x16EB8), (0x16EBB, 0x16ED3), (0x16FF2, 0x16FF3),
    (0x187F8, 0x187FF), (0x18CFF, 0x18CFF), (0x18D09, 0x18D1E),
    (0x18D80, 0x18DF2), (0x1E5D0, 0x1E5ED), (0x1E5F0, 0x1E5F0),
    (0x1E6C0, 0x1E6DE), (0x1E6E0, 0x1E6E2), (0x1E6E4, 0x1E6E5),
    (0x1E6E7, 0x1E6ED), (0x1E6F0, 0x1E6F4), (0x1E6FE, 0x1E6FF),
    (0x2B73A, 0x2B73F), (0x2CEA2, 0x2CEAD), (0x2EBF0, 0x2EE5D),
    (0x323B0, 0x33479),
)
_LATER_NUMBERS = (
    (0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9),
    (0x11DE0, 0x11DE9), (0x16130, 0x16139), (0x16D70, 0x16D79),
    (0x16FF4, 0x16FF6), (0x1CCF0, 0x1CCF9), (0x1E5F1, 0x1E5FA),
)
# Unicode's White_Space property: what \s matches in ``regex``
_WHITESPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
               (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
               (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))


def _set(ranges) -> str:
    """The inside of an ``re`` character class of the ranges."""
    return "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}"
                   for a, b in ranges)


def _runs(pred, extra) -> list:
    """Inclusive code point ranges where ``pred(category)`` holds, with
    ``extra`` ranges added."""
    import unicodedata

    out, start = [], None
    for cp in range(0x110001):
        ok = cp < 0x110000 and pred(unicodedata.category(chr(cp)))
        if ok and start is None:
            start = cp
        elif not ok and start is not None:
            out.append((start, cp - 1))
            start = None
    return sorted(out + list(extra))


@functools.lru_cache(maxsize=1)
def _classes() -> dict:
    """``re`` class bodies: letters ``L``, numbers ``N``, whitespace
    ``S`` (built once per process, about a second)."""
    return {"L": _set(_runs(lambda c: c[0] == "L", _LATER_LETTERS)),
            "N": _set(_runs(lambda c: c[0] == "N", _LATER_NUMBERS)),
            "S": _set(_WHITESPACE)}


# pretokenizer patterns (llama.cpp llm_tokenizer_bpe per tokenizer.ggml.pre;
# the JAX package's regex patterns) with {L}, {N}, {S} for the classes
_CONTRACTIONS = "'s|'t|'re|'ve|'m|'ll|'d"
# (?i:'s|'t|'re|'ve|'m|'ll|'d) as regex folds it
_CONTRACTIONS_I = ("'[sS\\u017f]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]"
                   "|'[dD]")
_PRE_PATTERNS = {
    "gpt2": (_CONTRACTIONS + "| ?[{L}]+| ?[{N}]+| ?[^{S}{L}{N}]+"
             "|[{S}]+(?![^{S}])|[{S}]+"),
    "llama3": (_CONTRACTIONS_I + "|[^\\r\\n{L}{N}]?[{L}]+|[{N}]{{1,3}}"
               "| ?[^{S}{L}{N}]+[\\r\\n]*|[{S}]*[\\r\\n]+|[{S}]+(?![^{S}])"
               "|[{S}]+"),
}
_PRE_PATTERNS["llama-bpe"] = _PRE_PATTERNS["llama3"]
_PRE_PATTERNS["default"] = _PRE_PATTERNS["gpt2"]
# qwen2 (Qwen2/2.5 family): llama3's pattern with single-digit numbers
# (llama.cpp llm_tokenizer_bpe LLAMA_VOCAB_PRE_TYPE_QWEN2)
_PRE_PATTERNS["qwen2"] = (
    _CONTRACTIONS_I + "|[^\\r\\n{L}{N}]?[{L}]+|[{N}]| ?[^{S}{L}{N}]+[\\r\\n]*"
    "|[{S}]*[\\r\\n]+|[{S}]+(?![^{S}])|[{S}]+")
# these GGUF `pre` tags use the plain GPT-2 split in llama.cpp
for _alias in ("starcoder", "gpt-2", "jina-es", "jina-de", "olmo"):
    _PRE_PATTERNS[_alias] = _PRE_PATTERNS["gpt2"]


@functools.lru_cache(maxsize=None)
def pretokenizer(pre: str):
    """The compiled ``re`` pattern of ``tokenizer.ggml.pre`` = ``pre``
    (its ``findall`` is the split)."""
    import re

    pat = _PRE_PATTERNS.get(pre)
    if pat is None:
        raise ValueError(
            f"tokenizer.ggml.pre={pre!r} has no implemented "
            f"pretokenizer; known: {sorted(_PRE_PATTERNS)}")
    return re.compile(pat.format(**_classes()))


class BPETokenizer:
    """Byte-level BPE with GGUF merge ranks (Llama-3 / GPT-2 vocabs)."""

    def __init__(
        self,
        tokens: Sequence[str],
        merges: Sequence[str],
        token_types: Sequence[int] | None = None,
        bos_id: int = 0,
        eos_id: int = 0,
        pre: str = "gpt2",
        add_bos: bool = True,
    ):
        self.tokens = list(tokens)
        self.token_types = (
            list(token_types) if token_types is not None
            else [TOKEN_NORMAL] * len(tokens)
        )
        self.vocab = {t: i for i, t in enumerate(self.tokens)}
        self.ranks = {}
        for r, m in enumerate(merges):
            a, _, b = m.partition(" ")
            self.ranks[(a, b)] = r
        self.bos_id, self.eos_id = bos_id, eos_id
        self.add_bos = add_bos
        self._pat = pretokenizer(pre)

    @classmethod
    def from_gguf(cls, metadata: dict) -> "BPETokenizer":
        return cls(
            metadata["tokenizer.ggml.tokens"],
            metadata.get("tokenizer.ggml.merges", []),
            metadata.get("tokenizer.ggml.token_type"),
            bos_id=int(metadata.get("tokenizer.ggml.bos_token_id", 0)),
            eos_id=int(metadata.get("tokenizer.ggml.eos_token_id", 0)),
            pre=metadata.get("tokenizer.ggml.pre", "gpt2"),
            add_bos=bool(metadata.get("tokenizer.ggml.add_bos_token", True)),
        )

    def _bpe_word(self, word: list[str]) -> list[str]:
        while len(word) > 1:
            best_rank, best_i = None, -1
            for i in range(len(word) - 1):
                r = self.ranks.get((word[i], word[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            word[best_i : best_i + 2] = [word[best_i] + word[best_i + 1]]
        return word

    def encode(self, text: str, add_bos: bool | None = None) -> list[int]:
        ids = [self.bos_id] if (self.add_bos if add_bos is None else add_bos) else []
        for piece in self._pat.findall(text):
            word = [_B2U[b] for b in piece.encode("utf-8")]
            for sym in self._bpe_word(word):
                tid = self.vocab.get(sym)
                if tid is not None:
                    ids.append(tid)
                else:  # letter-by-letter fallback (every byte is in vocab
                    ids.extend(self.vocab.get(c, 0) for c in sym)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        chars = []
        for tid in ids:
            if not 0 <= tid < len(self.tokens):
                continue
            if self.token_types[tid] == TOKEN_CONTROL:
                continue
            chars.append(self.tokens[tid])
        out = bytearray()
        for c in "".join(chars):
            b = _U2B.get(c)
            if b is None:  # not a byte-unicode char (e.g. special token text)
                out += c.encode("utf-8")
            else:
                out.append(b)
        return out.decode("utf-8", errors="replace")


def tokenizer_from_gguf(metadata: dict):
    """Build the right tokenizer for a GGUF: SPM ('llama') or BPE ('gpt2')."""
    model = metadata.get("tokenizer.ggml.model", "llama")
    if model in ("llama", "spm"):
        return SPMTokenizer.from_gguf(metadata)
    if model == "gpt2":
        return BPETokenizer.from_gguf(metadata)
    raise ValueError(f"unknown tokenizer.ggml.model {model!r}")


def encode_with_specials(tok, text: str) -> list[int]:
    """Tokenize chat-template output: special (control) tokens appearing
    as literal text map to their single token ids; the segments between
    them run through the normal pipeline WITHOUT bos/space-prefix
    injection (the template supplies bos itself).

    Without this, '<s>[INST]...' would re-tokenize the '<s>' as byte
    fallbacks / regex fragments and a second BOS would be prepended —
    corrupted model input (llama.cpp parses specials the same way)."""
    import re

    specials = {t: i for i, (t, tt) in
                enumerate(zip(tok.tokens, tok.token_types))
                if tt in SPECIAL_TOKEN_TYPES}
    if not specials:
        return tok.encode(text, add_bos=False)
    pat = re.compile("|".join(
        re.escape(t) for t in sorted(specials, key=len, reverse=True)))
    ids: list[int] = []
    posn = 0
    for m in pat.finditer(text):
        if m.start() > posn:
            ids.extend(tok.encode(text[posn:m.start()], add_bos=False))
        ids.append(specials[m.group(0)])
        posn = m.end()
    if posn < len(text):
        ids.extend(tok.encode(text[posn:], add_bos=False))
    return ids


__all__ += ["BPETokenizer", "tokenizer_from_gguf", "pretokenizer"]


def render_chat(metadata: dict, messages: list[dict],
                add_generation_prompt: bool = True) -> str:
    """Render a chat through the GGUF-embedded Jinja template
    (``tokenizer.chat_template`` — llama.cpp's --chat path).

    ``messages``: [{"role": "user", "content": "..."}, ...].
    """
    template = metadata.get("tokenizer.chat_template")
    if not template:
        raise ValueError("GGUF carries no tokenizer.chat_template")
    try:
        import jinja2
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "render_chat needs jinja2 (the chat template is Jinja)"
        ) from e

    env = jinja2.Environment(  # noqa: S701 — text templating, not HTML
        loader=jinja2.BaseLoader(), keep_trailing_newline=True
    )
    env.globals["raise_exception"] = lambda msg: (_ for _ in ()).throw(
        jinja2.TemplateError(msg)
    )

    def _get(name, default=""):
        tid = metadata.get(f"tokenizer.ggml.{name}_token_id")
        toks = metadata.get("tokenizer.ggml.tokens")
        return toks[int(tid)] if tid is not None and toks else default

    return env.from_string(template).render(
        messages=messages,
        add_generation_prompt=add_generation_prompt,
        bos_token=_get("bos", "<s>"),
        eos_token=_get("eos", "</s>"),
    )


__all__ += ["render_chat", "encode_with_specials"]
