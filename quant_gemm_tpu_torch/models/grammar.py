"""GBNF grammar-constrained sampling (llama.cpp --grammar / JSON mode):
the port's copy of the JAX package's ``models/grammar.py``, a host-side
engine with no framework in it.

llama.cpp's grammar engine (llama-grammar.cpp) parses GBNF — a BNF dialect
with literals, char classes, alternation, grouping, and repetition — and
constrains sampling by walking a set of pushdown stacks over the CODE
POINTS of each candidate token's text piece.  This is that engine,
host-side (grammar work is branchy string processing; the device step
stays as it is and the mask applies between steps):

* :func:`parse_gbnf` — GBNF text -> rule table ({name: [alternates]},
  each alternate a list of symbols; repetition operators rewrite into
  auxiliary rules exactly like llama.cpp's parser).
* :class:`GrammarMatcher` — incremental recognizer: a state is a set of
  stacks of pending symbols; ``advance(text)`` consumes characters,
  ``allows(text)`` tests a candidate continuation, ``can_finish`` is the
  accept state (EOS legality).
* :class:`GrammarSampler` — per-request wrapper: ``filter_logits`` masks
  every token whose piece cannot extend the current state (llama.cpp
  llama_grammar_apply_impl), ``accept(token)`` advances.

Reference grammar semantics: github.com/ggml-org/llama.cpp
grammars/README.md.  JSON_GBNF below mirrors grammars/json.gbnf.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np

# -- symbols ------------------------------------------------------------------
# ("char", ((lo, hi), ...), negated)  match one code point against ranges
# ("ref", rule_name)                  match the named rule


class _Parser:
    """GBNF text -> {rule: [[symbol, ...], ...]} with repetition rewritten."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.rules: dict[str, list] = {}
        self._aux = 0

    # -- lexing helpers
    def _ws(self, newlines: bool = False):
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c == "#":  # comment to end of line
                nl = self.text.find("\n", self.pos)
                self.pos = len(self.text) if nl < 0 else nl
            elif c in " \t" or (newlines and c in "\r\n"):
                self.pos += 1
            else:
                break

    def _name(self) -> str:
        m = re.match(r"[A-Za-z0-9_-]+", self.text[self.pos:])
        if not m:
            raise ValueError(f"expected rule name at {self.pos}: "
                             f"{self.text[self.pos:self.pos+20]!r}")
        self.pos += m.end()
        return m.group(0)

    def _char(self) -> str:
        """One (possibly escaped) character inside a literal/class."""
        c = self.text[self.pos]
        self.pos += 1
        if c != "\\":
            return c
        e = self.text[self.pos]
        self.pos += 1
        if e in 'nrt"[]\\-^':
            return {"n": "\n", "r": "\r", "t": "\t"}.get(e, e)
        if e in "xuU":
            width = {"x": 2, "u": 4, "U": 8}[e]
            h = self.text[self.pos:self.pos + width]
            self.pos += width
            return chr(int(h, 16))
        raise ValueError(f"bad escape \\{e}")

    # -- grammar constructs
    def _aux_rule(self, alternates) -> str:
        name = f"aux-{self._aux}"
        self._aux += 1
        self.rules[name] = alternates
        return name

    def _repeat(self, sym, lo: int, hi: int | None):
        """{lo,hi} (hi=None means unbounded) -> symbols via aux rules."""
        out = [sym] * lo
        if hi is None:
            star = self._aux_rule([])
            self.rules[star] = [[sym, ("ref", star)], []]
            out.append(("ref", star))
        else:
            for _ in range(hi - lo):
                opt = self._aux_rule([[sym], []])
                out.append(("ref", opt))
        return out

    def _primary(self):
        """literal | char class | ( group ) | rule ref -> ONE symbol."""
        c = self.text[self.pos]
        if c == '"':
            self.pos += 1
            chars = []
            while self.text[self.pos] != '"':
                chars.append(self._char())
            self.pos += 1
            syms = [("char", ((ord(ch), ord(ch)),), False) for ch in chars]
            if len(syms) == 1:
                return syms[0]
            return ("ref", self._aux_rule([syms]))
        if c == "[":
            self.pos += 1
            neg = self.text[self.pos] == "^"
            if neg:
                self.pos += 1
            ranges = []
            while self.text[self.pos] != "]":
                lo = self._char()
                if (self.text[self.pos] == "-"
                        and self.text[self.pos + 1] != "]"):
                    self.pos += 1
                    hi = self._char()
                    ranges.append((ord(lo), ord(hi)))
                else:
                    ranges.append((ord(lo), ord(lo)))
            self.pos += 1
            return ("char", tuple(ranges), neg)
        if c == "(":
            self.pos += 1
            alts = self._alternates(nested=True)
            self._ws(newlines=True)
            if self.text[self.pos] != ")":
                raise ValueError(f"expected ) at {self.pos}")
            self.pos += 1
            return ("ref", self._aux_rule(alts))
        if c == ".":  # any char
            self.pos += 1
            return ("char", ((0, 0x10FFFF),), False)
        return ("ref", self._name())

    def _sequence(self, nested: bool = False) -> list:
        syms = []
        while True:
            # inside parens newlines are plain whitespace; at rule depth
            # a newline ends the sequence (llama.cpp parse_space(nested))
            self._ws(newlines=nested)
            if self.pos >= len(self.text):
                break
            c = self.text[self.pos]
            if c in "|)" or (not nested and c in "\r\n"):
                break
            # a rule definition ahead ("name ::=") ends this sequence
            m = re.match(r"[A-Za-z0-9_-]+\s*::=", self.text[self.pos:])
            if m:
                break
            sym = self._primary()
            self._ws()
            reps = []
            while (self.pos < len(self.text)
                   and self.text[self.pos] in "*+?{"):
                reps.append(self.text[self.pos])
                if self.text[self.pos] == "{":
                    end = self.text.index("}", self.pos)
                    reps[-1] = self.text[self.pos:end + 1]
                    self.pos = end + 1
                else:
                    self.pos += 1
                self._ws()
            for rep in reps:
                if rep == "*":
                    seq = self._repeat(sym, 0, None)
                elif rep == "+":
                    seq = self._repeat(sym, 1, None)
                elif rep == "?":
                    seq = self._repeat(sym, 0, 1)
                else:
                    m2 = re.match(r"\{(\d+)(,(\d*)?)?\}", rep)
                    if not m2:
                        raise ValueError(f"bad repetition {rep!r}")
                    lo = int(m2.group(1))
                    if m2.group(2) is None:
                        hi = lo
                    else:
                        hi = int(m2.group(3)) if m2.group(3) else None
                    seq = self._repeat(sym, lo, hi)
                sym = (("ref", self._aux_rule([seq]))
                       if len(seq) != 1 else seq[0])
            syms.append(sym)
        return syms

    def _alternates(self, nested: bool = False) -> list:
        alts = [self._sequence(nested)]
        while True:
            # a newline ends the rule UNLESS the next non-space token is a
            # "|" continuation (json.gbnf formats alternates one per line)
            mark = self.pos
            self._ws(newlines=True)
            if self.pos < len(self.text) and self.text[self.pos] == "|":
                self.pos += 1
                alts.append(self._sequence(nested))
            else:
                self.pos = mark
                return alts

    def parse(self) -> dict:
        while True:
            self._ws(newlines=True)
            if self.pos >= len(self.text):
                break
            name = self._name()
            self._ws()
            if self.text[self.pos:self.pos + 3] != "::=":
                raise ValueError(f"expected ::= after {name!r}")
            self.pos += 3
            self._ws(newlines=True)  # body may start on the next line
            alts = self._alternates()
            self.rules.setdefault(name, []).extend(alts)
        if "root" not in self.rules:
            raise ValueError("grammar has no root rule")
        return self.rules


def parse_gbnf(text: str) -> dict:
    return _Parser(text).parse()


# -- incremental matcher ------------------------------------------------------


def _char_match(sym, cp: int) -> bool:
    _, ranges, neg = sym
    hit = any(lo <= cp <= hi for lo, hi in ranges)
    return hit != neg


_EXPAND_BUDGET = 4096  # work items per expansion: left-recursion guard


def _utf8_split(buf: bytes):
    """Split bytes into (complete code points, trailing partial sequence).

    Returns (list_of_cps, partial_bytes) or (None, None) on INVALID UTF-8
    — a candidate piece with broken encoding can never match.  A trailing
    prefix of a valid multi-byte sequence is legal (llama.cpp's
    partial_utf8 carry: byte-fallback tokens split code points across
    tokens)."""
    cps: list[int] = []
    i, n = 0, len(buf)
    while i < n:
        b0 = buf[i]
        if b0 < 0x80:
            cps.append(b0)
            i += 1
            continue
        if b0 >= 0xF8 or 0x80 <= b0 < 0xC0:
            return None, None  # invalid lead byte
        need = 2 if b0 < 0xE0 else 3 if b0 < 0xF0 else 4
        if i + need > n:
            tail = buf[i:]
            if all(0x80 <= b < 0xC0 for b in tail[1:]):
                return cps, tail  # plausible partial sequence
            return None, None
        seq = buf[i:i + need]
        if not all(0x80 <= b < 0xC0 for b in seq[1:]):
            return None, None
        cp = _utf8_cp(seq)
        if (cp < _UTF8_MIN[need] or cp > 0x10FFFF
                or 0xD800 <= cp <= 0xDFFF):
            return None, None  # overlong / out-of-range / surrogate
        cps.append(cp)
        i += need
    return cps, b""


_UTF8_MIN = {2: 0x80, 3: 0x800, 4: 0x10000}


def _utf8_cp(seq: bytes) -> int:
    need = len(seq)
    cp = seq[0] & (0x7F >> need)
    for b in seq[1:]:
        cp = (cp << 6) | (b & 0x3F)
    return cp


def _partial_range(partial: bytes):
    """The [lo, hi] code-point range a partial UTF-8 sequence can still
    become (llama.cpp llama_grammar_match_partial_char)."""
    b0 = partial[0]
    need = 2 if b0 < 0xE0 else 3 if b0 < 0xF0 else 4
    value = b0 & (0x7F >> need)
    for b in partial[1:]:
        value = (value << 6) | (b & 0x3F)
    rem = need - len(partial)
    lo = value << (6 * rem)
    hi = ((value + 1) << (6 * rem)) - 1
    # overlong encodings can never complete to a valid code point: the
    # range floor is the encoding length's minimum (rejects 0xC0/0xC1
    # leads outright — their whole range sits below the floor)
    lo = max(lo, _UTF8_MIN[need])
    hi = min(hi, 0x10FFFF)
    if hi < lo:
        return None
    return lo, hi


def _char_match_range(sym, lo: int, hi: int) -> bool:
    """Could SOME code point in [lo, hi] match this char symbol?"""
    _, ranges, neg = sym
    if not neg:
        return any(a <= hi and lo <= b for a, b in ranges)
    # negated: true iff [lo, hi] is not fully covered by the ranges
    ivs = sorted((max(a, lo), min(b, hi))
                 for a, b in ranges if a <= hi and b >= lo)
    cur = lo
    for a, b in ivs:
        if a > cur:
            return True
        cur = max(cur, b + 1)
    return cur <= hi


class GrammarMatcher:
    """A set of symbol stacks over the rule table (llama.cpp
    llama_grammar stacks).  Top of stack = NEXT symbol to match; stacks
    are expanded so every top is a char symbol (or the stack is empty =
    accept).  Matching is BYTE-oriented with a partial-UTF-8 carry
    (llama.cpp decode_utf8 semantics): token pieces may split a code
    point, and the grammar sees whole code points only."""

    def __init__(self, rules: dict, stacks=None):
        self.rules = rules
        if stacks is None:
            stacks = self._expand((("ref", "root"),))
        self.stacks: set[tuple] = stacks
        self.partial: bytes = b""

    def _expand(self, stack: tuple) -> set[tuple]:
        """Expand leading refs until the top is a char symbol / empty."""
        out: set[tuple] = set()
        work = [stack]
        seen = set()
        budget = _EXPAND_BUDGET
        while work:
            budget -= 1
            if budget < 0:
                raise ValueError(
                    "grammar expansion budget exceeded — the grammar is "
                    "LEFT-RECURSIVE or pathologically ambiguous (llama.cpp "
                    "rejects left recursion too)")
            s = work.pop()
            if s in seen:
                continue
            seen.add(s)
            if not s or s[0][0] == "char":
                out.add(s)
                continue
            _, name = s[0]
            rest = s[1:]
            for alt in self.rules[name]:
                work.append(tuple(alt) + rest)
        return out

    def _advance_char(self, stacks: set, cp: int) -> set:
        nxt: set[tuple] = set()
        for s in stacks:
            if s and s[0][0] == "char" and _char_match(s[0], cp):
                nxt |= self._expand(s[1:])
        return nxt

    def _advance_bytes(self, stacks: set, partial: bytes, data: bytes):
        """(stacks, partial) after consuming data, or (None, None)."""
        cps, new_partial = _utf8_split(partial + data)
        if cps is None:
            return None, None
        for cp in cps:
            stacks = self._advance_char(stacks, cp)
            if not stacks:
                return None, None
        if new_partial:
            # a pending partial is legal only if some completion of it
            # could match a current char alternative (llama.cpp
            # llama_grammar_match_partial_char) — otherwise any lead
            # byte would count as "legal" and desync constrained decoding
            rng = _partial_range(new_partial)
            if rng is None:
                return None, None
            lo, hi = rng
            if not any(s and s[0][0] == "char"
                       and _char_match_range(s[0], lo, hi)
                       for s in stacks):
                return None, None
        return stacks, new_partial

    def advance(self, text) -> bool:
        """Consume text (str or bytes); False (state unchanged) if it
        cannot match."""
        data = text.encode("utf-8") if isinstance(text, str) else text
        stacks, partial = self._advance_bytes(self.stacks, self.partial,
                                              data)
        if stacks is None:
            return False
        self.stacks, self.partial = stacks, partial
        return True

    def allows(self, text) -> bool:
        """Can this text (str or bytes) extend the state? (not mutated)"""
        data = text.encode("utf-8") if isinstance(text, str) else text
        stacks, _ = self._advance_bytes(self.stacks, self.partial, data)
        return stacks is not None

    @property
    def can_finish(self) -> bool:
        """True when the input so far is a complete sentence (EOS legal):
        an empty stack exists and no partial code point is pending."""
        return not self.partial and any(not s for s in self.stacks)


def piece_bytes(tok, tid: int) -> bytes | None:
    """The RAW bytes a token contributes to the output stream, context-
    free — NOT ``tok.decode([tid])``, which strips SPM leading-space
    markers and mangles split multi-byte UTF-8 into U+FFFD (either would
    desync the grammar from the real decoded text).  Specials return
    None (never grammar-legal)."""
    from .tokenizer import _SPACE, _U2B, SPECIAL_TOKEN_TYPES, TOKEN_BYTE

    if not 0 <= tid < len(tok.tokens):
        return None
    tt = tok.token_types[tid]
    if tt in SPECIAL_TOKEN_TYPES:
        return None
    t = tok.tokens[tid]
    if hasattr(tok, "byte_tokens"):  # SPM
        if tt == TOKEN_BYTE and len(t) == 6 and t[:3] == "<0x":
            return bytes([int(t[3:5], 16)])
        return t.replace(_SPACE, " ").encode("utf-8")
    # byte-level BPE: piece chars map through the GPT-2 byte table
    out = bytearray()
    for c in t:
        b = _U2B.get(c)
        if b is None:
            out += c.encode("utf-8")
        else:
            out.append(b)
    return bytes(out)


class GrammarSampler:
    """Per-request grammar state + logits filter over a tokenizer vocab."""

    def __init__(self, gbnf: str, tok, eos_id: int | None = None):
        self.matcher = GrammarMatcher(parse_gbnf(gbnf))
        self.tok = tok
        self.eos_id = eos_id if eos_id is not None else tok.eos_id
        # piece cache: token id -> raw bytes (specials map to None =
        # never grammar-legal, except EOS which is handled explicitly)
        self._pieces: dict[int, bytes | None] = {}

    def _piece(self, tid: int):
        if tid not in self._pieces:
            try:
                data = piece_bytes(self.tok, tid)
            except Exception:  # noqa: BLE001
                data = None
            self._pieces[tid] = data if data else None
        return self._pieces[tid]

    def filter_logits(self, logits: np.ndarray) -> np.ndarray:
        """-inf every token whose piece cannot extend the state; EOS stays
        legal only at an accept state (llama_grammar_apply_impl)."""
        out = np.array(logits, np.float32, copy=True)
        for tid in range(out.shape[-1]):
            if tid == self.eos_id:
                if not self.matcher.can_finish:
                    out[tid] = -np.inf
                continue
            piece = self._piece(tid)
            if piece is None or not self.matcher.allows(piece):
                out[tid] = -np.inf
        return out

    def accept(self, tid: int) -> None:
        if tid == self.eos_id:
            return
        piece = self._piece(tid)
        if piece is None or not self.matcher.advance(piece):
            raise ValueError(
                f"token {tid} ({piece!r}) violates the grammar state")


# llama.cpp grammars/json.gbnf (public grammar, reproduced for JSON mode)
JSON_GBNF = r"""
root   ::= object
value  ::= object | array | string | number | ("true" | "false" | "null") ws

object ::=
  "{" ws (
            string ":" ws value
    ("," ws string ":" ws value)*
  )? "}" ws

array  ::=
  "[" ws (
            value
    ("," ws value)*
  )? "]" ws

string ::=
  "\"" (
    [^"\\\x7F\x00-\x1F] |
    "\\" (["\\bfnrt] | "u" [0-9a-fA-F]{4})
  )* "\"" ws

number ::= ("-"? ([0-9] | [1-9] [0-9]{0,15})) ("." [0-9]+)? ([eE] [-+]? [0-9]{1,4})? ws

ws ::= | " " | "\n" [ \t]{0,20}
"""


__all__ = ["parse_gbnf", "GrammarMatcher", "GrammarSampler", "JSON_GBNF"]
