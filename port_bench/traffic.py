"""The one traffic generator: closed-loop clients running sessions.

A traffic mix is a JSON file of parameters (``traffic/<mix>.json``).
Every mix is a set of sessions: a session opens with one of the mix's
shared system prompts (or none) and runs one or more turns; a turn's
prompt is the session's whole history (system prompt, earlier user turns
and the answers served to them) plus the new user turn, and the answer is
``output`` tokens, decoded greedily to the end (no EOS).  A mix of single
requests is a mix of one-turn sessions with no system prompt.

The shapes come from a pool of ``pool`` sessions that does not depend on
the seed: each length is a quantile of its distribution on an evenly
spaced grid, paired with the others by fixed permutations, so every seed
serves the same set of sizes.  The pool is handed out in one fixed
cyclic order from its first session; the seed chooses every token id
(and the weights).  So every seed runs the same schedule of sizes, and a
window's sizes do not depend on the seed.  Clients take the next session
from that one sequence as they become free, so a schedule in steps is
the same for every seed whatever the speed of the system under test.

Keys of a mix file: ``clients``; ``pool``; ``turns`` [min, max];
``system_prompts`` and ``system_tokens``; ``prompt_tokens`` (the user
turn) and ``output_tokens``, each ``{"dist": "uniform", "min", "max"}`` in
tokens, both ends included, or ``{"dist": "log_normal", "median",
"sigma", "min", "max"}`` (the log of the length normal, clipped to
``min..max``); ``lead_in_finished``
(requests that finish before the window opens); ``check`` (what the
comparison with the reference samples, see ``check.py``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent

#: salts of the seed-independent stratification, one per quantity
_SALT_TURNS, _SALT_SYSTEM, _SALT_PROMPT, _SALT_OUTPUT = 11, 12, 13, 14


def load(name: str, root: Path = ROOT) -> dict:
    """The mix ``traffic/<name>.json`` under ``root``."""
    with open(root / "traffic" / f"{name}.json") as f:
        mix = json.load(f)
    mix.setdefault("turns", [1, 1])
    mix.setdefault("system_prompts", 0)
    mix.setdefault("system_tokens", 0)
    mix.setdefault("lead_in_finished", 0)
    return mix


def quantile(dist: dict, u: float) -> int:
    """The length at quantile ``u`` in (0, 1) of ``dist``: ``uniform`` over
    the integers ``min..max``, or ``log_normal`` (the log of the length
    normal about log ``median`` with deviation ``sigma``), clipped to
    ``min..max``."""
    lo, hi = int(dist["min"]), int(dist["max"])
    kind = dist["dist"]
    if kind == "uniform":
        x = lo + u * (hi - lo + 1)
    elif kind == "log_normal":
        z = statistics.NormalDist().inv_cdf(u)
        x = round(float(dist["median"]) * math.exp(float(dist["sigma"]) * z))
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return min(max(int(x), lo), hi)


def grid(n: int, salt: int) -> np.ndarray:
    """``n`` evenly spaced quantiles ``(i + 0.5) / n`` in an order fixed by
    ``salt``."""
    perm = np.random.default_rng(salt).permutation(n)
    return (perm + 0.5) / n


@dataclasses.dataclass(frozen=True)
class Shape:
    """A session's sizes: its system prompt (index, or None) and its turns'
    (user tokens, output tokens)."""

    system: Optional[int]
    turns: tuple


def pool(mix: dict) -> list:
    """The mix's sessions, the same for every seed, in the cyclic order
    they are handed out in."""
    n = int(mix["pool"])
    tmin, tmax = mix["turns"]
    n_turns = [quantile({"dist": "uniform", "min": tmin, "max": tmax}, u)
               for u in grid(n, _SALT_TURNS)]
    total = sum(n_turns)
    users = [quantile(mix["prompt_tokens"], u)
             for u in grid(total, _SALT_PROMPT)]
    outs = [quantile(mix["output_tokens"], u)
            for u in grid(total, _SALT_OUTPUT)]
    k = int(mix["system_prompts"])
    systems = (np.random.default_rng(_SALT_SYSTEM).permutation(n) % k
               if k else [None] * n)
    shapes, at = [], 0
    for i, t in enumerate(n_turns):
        turns = tuple(zip(users[at:at + t], outs[at:at + t]))
        at += t
        shapes.append(Shape(None if systems[i] is None else int(systems[i]),
                            turns))
    return shapes


def extent(mix: dict) -> tuple:
    """(the shortest first prompt, the longest context) of the mix's pool:
    a session's context at its end is its system prompt, every user turn
    and every answer."""
    shapes = pool(mix)
    system = int(mix["system_tokens"])

    def sys_len(s: Shape) -> int:
        return 0 if s.system is None else system

    lo = min(sys_len(s) + s.turns[0][0] for s in shapes)
    hi = max(sys_len(s) + sum(u + o for u, o in s.turns) for s in shapes)
    return lo, hi


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, *salt])


class Session:
    """One session handed to a client: its shape and its token ids."""

    def __init__(self, shape: Shape, system_ids: list, rng):
        self.shape = shape
        self.system_ids = system_ids
        self.rng = rng
        self.turn = 0
        self.history: list = []

    def prompt(self, vocab: int) -> list:
        """The prompt of the current turn: the history, then the new user
        turn's ids."""
        user = self.rng.integers(0, vocab, self.shape.turns[self.turn][0])
        if self.turn == 0:
            self.history = list(self.system_ids)
        return self.history + user.tolist()

    def max_new(self) -> int:
        return self.shape.turns[self.turn][1]

    def answered(self, prompt: list, answer: list) -> bool:
        """Record the current turn's answer; True while turns are left."""
        self.history = list(prompt) + list(answer)
        self.turn += 1
        return self.turn < len(self.shape.turns)


class Traffic:
    """The seeded sequence of sessions of a mix, for a model of ``vocab``
    token ids."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.shapes = pool(mix)
        srng = _rng(seed, 1)
        self.system_ids = [srng.integers(0, vocab, mix["system_tokens"])
                           .tolist() for _ in range(mix["system_prompts"])]
        self.handed = 0

    def next_session(self) -> Session:
        k = self.handed
        shape = self.shapes[k % len(self.shapes)]
        self.handed += 1
        system = [] if shape.system is None else self.system_ids[shape.system]
        return Session(shape, system, _rng(self.seed, 3, k))


__all__ = ["load", "quantile", "grid", "Shape", "pool", "extent", "Session",
           "Traffic"]
