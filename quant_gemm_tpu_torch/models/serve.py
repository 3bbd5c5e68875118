"""Continuous-batching serving loop over the quantized Llama forward.

Counterpart of ``quant_gemm_tpu/models/serve.py::Server`` for the serving
slice: a fixed pool of slots whose sequences advance independently; a new
request is prefilled in bucket-padded chunks while the other slots keep
decoding, and every decode step runs all slots as one batched T = 1
forward (M = n_slots in every GEMM).  Inactive slots run masked garbage
whose cache writes land at their clamped stale position, as in JAX.

Options outside the slice raise ``NotImplementedError``: the q8 cache,
sliding window / ring caches, ``context_shift``, grammar sampling,
``n_probs``, ``prefill_a16``, ``w_down_a16`` and prompt caching
(``cache_prompt=True``).  Prefill chunks must stay under 64 tokens (the
dense-attention path; flash prefill is not ported).
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import Optional

import numpy as np
import torch

from ..utils import resolve_device, round_up
from . import llama, sampling

PENALTY_WINDOW = 64  # recent tokens a slot's repeat penalty sees
BIAS_SLOTS = 8  # sparse logit-bias entries per request


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    repeat_penalty: float = 1.0
    logit_bias: Optional[dict] = None
    seed: Optional[int] = None
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


class Server:
    """Continuous-batching decoder over fixed slots (greedy by default)."""

    def __init__(
        self,
        qparams,
        cfg: llama.LlamaConfig,
        n_slots: int = 8,
        act_mode: str = "q8_1",
        prefill_a16: bool = False,
        prefill_bucket: int = 16,
        eos_id: Optional[int] = None,
        cache_qtype: str = "bf16",
        max_prefill_chunk: Optional[int] = None,
        context_shift: bool = False,
        cache_prompt: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if prefill_a16:
            raise NotImplementedError("prefill_a16 is not ported")
        if context_shift:
            raise NotImplementedError("context_shift is not ported")
        if cache_prompt:
            raise NotImplementedError("cache_prompt (prefix reuse) is not "
                                      "ported; pass cache_prompt=False")
        if act_mode != "q8_1":
            raise NotImplementedError(f"act_mode {act_mode!r} is not ported")
        llama.check_config(cfg)
        if qparams["embed"].device != self.device:
            raise ValueError(f"qparams live on {qparams['embed'].device}, "
                             f"the server on {self.device}")
        self.qparams = qparams
        self.cfg = cfg
        self.n_slots = n_slots
        self.act_mode = act_mode
        self.bucket = prefill_bucket
        self.eos_id = eos_id
        self.max_chunk = max_prefill_chunk or prefill_bucket * 8
        if round_up(self.max_chunk, self.bucket) > llama.PREFILL_T_MAX:
            raise NotImplementedError(
                f"prefill chunks of {round_up(self.max_chunk, self.bucket)} "
                "tokens need flash prefill (T >= 64), which is not ported; "
                "pass max_prefill_chunk=48")
        self.cache = llama.KVCache.init(cfg, n_slots, cache_qtype,
                                        device=self.device)
        self.slots: list[Optional[Request]] = [None] * n_slots
        self.queue: list[Request] = []
        self.finished: dict[int, Request] = {}
        self._next_rid = 0
        self._rope = llama.rope_for(cfg, self.device)
        self._pending_tok = np.zeros(n_slots, np.int64)
        self._hpos = np.zeros(n_slots, np.int64)  # host mirror of cache.pos
        self._temps = np.zeros(n_slots, np.float32)
        self._topk = np.zeros(n_slots, np.int64)
        self._topp = np.ones(n_slots, np.float32)
        self._minp = np.zeros(n_slots, np.float32)
        self._rpen = np.ones(n_slots, np.float32)
        self._recent = np.full((n_slots, PENALTY_WINDOW), -1, np.int64)
        self._bias_ids = np.full((n_slots, BIAS_SLOTS), -1, np.int64)
        self._bias_vals = np.zeros((n_slots, BIAS_SLOTS), np.float32)
        self._gens: list[Optional[torch.Generator]] = [None] * n_slots
        self._n_steps = 0
        self._n_tokens = 0
        self._n_decode_tokens = 0
        self._n_prefill_tokens = 0
        self._prefill_s = 0.0
        # the latest decode steps' host seconds (bounded for long runs)
        self._step_s: collections.deque = collections.deque(maxlen=65536)

    # -- request lifecycle ---------------------------------------------------

    def submit(self, prompt: list, max_new: int = 16,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               min_p: float = 0.0, repeat_penalty: float = 1.0,
               logit_bias: Optional[dict] = None, seed: Optional[int] = None,
               grammar=None, n_probs: int = 0,
               cache_prompt: bool = True) -> int:
        """Queue a request; returns its id.  ``cache_prompt`` is the
        per-request opt-out of a server-level option that is off here."""
        if grammar is not None:
            raise NotImplementedError("grammar sampling is not ported")
        if n_probs:
            raise NotImplementedError("n_probs (top logprobs) is not ported")
        if not prompt:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if logit_bias and len(logit_bias) > BIAS_SLOTS:
            raise ValueError(f"at most {BIAS_SLOTS} logit biases per request")
        r = Request(self._next_rid, list(prompt), max_new,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    min_p=min_p, repeat_penalty=repeat_penalty,
                    logit_bias=logit_bias, seed=seed)
        self._next_rid += 1
        self.queue.append(r)
        return r.rid

    def _prefill(self, slot: int, prompt: list) -> torch.Tensor:
        """Chunked prefill of one request straight into its slot (a view
        of the server cache: no per-request cache copy); returns the last
        prompt position's logits."""
        c1 = llama.KVCache(self.cache.k[:, slot:slot + 1],
                           self.cache.v[:, slot:slot + 1],
                           torch.zeros(1, dtype=torch.int32,
                                       device=self.device))
        off = 0
        while off < len(prompt):
            part = prompt[off: off + self.max_chunk]
            t = max(self.bucket, round_up(len(part), self.bucket))
            padded = np.zeros((1, t), np.int64)
            padded[0, : len(part)] = part
            # the padded tail writes garbage past the real tokens; pos
            # advances only by the real length so the next chunk overwrites
            logits, c1 = llama.forward(
                self.qparams, self.cfg,
                torch.as_tensor(padded, device=self.device), c1,
                act_mode=self.act_mode, rope_cache=self._rope)
            last = logits[0, len(part) - 1]
            c1.pos = torch.full((1,), off + len(part), dtype=torch.int32,
                                device=self.device)
            off += len(part)
        self.cache.pos[slot] = len(prompt)
        return last

    def _admit(self) -> None:
        while self.queue:
            free = [s for s in range(self.n_slots) if self.slots[s] is None]
            if not free:
                return
            s = free[0]
            r = self.queue.pop(0)
            t0 = time.perf_counter()
            last_logits = self._prefill(s, r.prompt)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(r.seed if r.seed is not None else r.rid)
            self._gens[s] = gen
            self._temps[s] = r.temperature
            self._topk[s] = r.top_k
            self._topp[s] = r.top_p
            self._minp[s] = r.min_p
            self._rpen[s] = r.repeat_penalty
            self._bias_ids[s] = -1
            self._bias_vals[s] = 0.0
            for j, (tid, bv) in enumerate(sorted((r.logit_bias or {}).items())):
                self._bias_ids[s, j] = int(tid)
                self._bias_vals[s, j] = float(bv)
            self._recent[s] = -1
            tail = r.prompt[-PENALTY_WINDOW:]
            self._recent[s, PENALTY_WINDOW - len(tail):] = tail
            sl = slice(s, s + 1)
            tok = int(sampling.sample(
                last_logits[None], [gen], self._temps[sl], self._topk[sl],
                self._topp[sl], self._minp[sl], self._recent[sl],
                self._rpen[sl], self._bias_ids[sl], self._bias_vals[sl])[0])
            self._prefill_s += time.perf_counter() - t0
            r.generated.append(tok)
            self._n_prefill_tokens += len(r.prompt)
            self._n_tokens += 1
            if (len(r.generated) >= r.max_new
                    or (self.eos_id is not None and tok == self.eos_id)):
                r.done = True
                self.finished[r.rid] = r
                continue
            self._pending_tok[s] = tok
            self._hpos[s] = len(r.prompt)
            self._recent[s] = np.roll(self._recent[s], -1)
            self._recent[s, -1] = tok
            self.slots[s] = r

    def step(self) -> dict[int, int]:
        """Admit queued requests, run one batched decode step; returns
        {request_id: new_token} for slots that produced a token."""
        self._admit()
        active = [s for s in range(self.n_slots) if self.slots[s] is not None]
        if not active:
            return {}
        t0 = time.perf_counter()
        tokens = torch.as_tensor(self._pending_tok[:, None],
                                 device=self.device)
        logits, self.cache = llama.forward(
            self.qparams, self.cfg, tokens, self.cache,
            act_mode=self.act_mode, rope_cache=self._rope)
        nxt = sampling.sample(
            logits[:, -1], self._gens, self._temps, self._topk, self._topp,
            self._minp, self._recent, self._rpen, self._bias_ids,
            self._bias_vals).cpu().numpy()
        self._step_s.append(time.perf_counter() - t0)
        self._hpos += 1  # every slot's cache.pos advanced by one
        self._n_steps += 1
        self._n_tokens += len(active)
        self._n_decode_tokens += len(active)
        out = {}
        for s in active:
            r = self.slots[s]
            tok = int(nxt[s])
            r.generated.append(tok)
            self._pending_tok[s] = tok
            self._recent[s] = np.roll(self._recent[s], -1)
            self._recent[s, -1] = tok
            out[r.rid] = tok
            if (len(r.generated) >= r.max_new
                    or (self.eos_id is not None and tok == self.eos_id)
                    or self._hpos[s] >= self.cfg.max_seq - 1):
                r.done = True
                self.finished[r.rid] = r
                self.slots[s] = None
        return out

    def stats(self) -> dict:
        """Serving counters, plus host-clock seconds spent in prefill
        (admission, first token included) and in decode steps; both end
        in a device-to-host read, so they cover the device work."""
        return {
            "decode_steps": self._n_steps,
            "generated_tokens": self._n_tokens,
            "prefill_tokens": self._n_prefill_tokens,
            "active_slots": sum(s is not None for s in self.slots),
            "queued": len(self.queue),
            "finished": len(self.finished),
            "tokens_per_step": (self._n_decode_tokens / self._n_steps
                                if self._n_steps else 0.0),
            "decode_tokens": self._n_decode_tokens,
            "prefill_seconds": self._prefill_s,
            "decode_seconds": sum(self._step_s),
            "decode_step_ms_median": (statistics.median(self._step_s) * 1e3
                                      if self._step_s else 0.0),
        }

    def run_until_done(self, max_steps: int = 10_000) -> dict[int, list]:
        """Drain the queue; returns {request_id: generated tokens}."""
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                break
            self.step()
        return {rid: r.generated for rid, r in self.finished.items()}


__all__ = ["Server", "Request"]
