"""Continuous-batching serving loop over the quantized Llama forward.

Counterpart of ``quant_gemm_tpu/models/serve.py::Server`` with its
defaults: a fixed pool of slots whose sequences advance independently; a
new request is prefilled in bucket-padded chunks of up to
``prefill_bucket * 8`` tokens (chunks of 64 or more take K5) straight into
its slot while the other slots keep decoding, and every decode step runs
all slots as one batched T = 1 forward (M = n_slots in every GEMM).
Inactive slots run masked garbage whose cache writes land at their
clamped stale position, as in JAX.  With ``cache_prompt`` (the default, as
llama.cpp's) a request goes to the free slot whose cache already holds the
longest prefix of its prompt, and only the rest is prefilled.  The cache
is bf16 or, with ``cache_qtype="q8"``, int8 with per-token scales; the
model may have a sliding window.

A ring cache (``cfg.ring``) holds O(window) slots per request, so a
request may run past the ring; its prefill chunk is clamped to a bucket
multiple within ``ring_chunk`` and prompt caching is off (a wrapped slot
no longer holds its prompt from position 0), as in JAX.  With
``context_shift`` (linear caches only) a slot reaching ``max_seq - 1``
keeps its newest ``window`` (or ``max_seq // 2``) tokens
(``llama.shift_context``) and generation goes on; otherwise such a
request finishes there.

On the card each decode step and each prefill chunk is replayed from a
CUDA graph, the counterpart of JAX's jitted ``_decode_step`` and
``_prefill_step`` (``quant_gemm_tpu/models/serve.py:47-81``): one graph
per decode ``s_hi`` (256, 512 or None, as JAX compiles at most three
``attn_s_hi`` programs) and one per chunk length, keyed also on the
module settings that choose the route (:func:`graph_key`), all in one
memory pool.  The
first call of a key runs eagerly on a side stream (the kernels' builds
and occupancy queries happen there) and gives that step's result; then
the key is captured and every later call replays it.  The graph reads
its tokens from a static device buffer, writes the cache and
``cache.pos`` in place and leaves its logits in a static output; sampling
stays eager after the replay (JAX samples inside its jit).  As JAX
prefills a one-slot cache and inserts it (``serve.py:180-215``), the
Server prefills into a one-slot staging cache: the slot is copied into
it first where a reused prefix continues (JAX's extract), and the
staging cache is copied into the slot after the last chunk (JAX's
insert), so the chunk graphs never bake a slot's address in.
:data:`CUDA_GRAPHS` = False runs the steps eagerly on the card too (the
counterpart of ``jax.disable_jit()``); on the CPU the Server always runs
eagerly.  A capture that fails raises: nothing falls back to eager.

Grammar-constrained requests (a :class:`~.grammar.GrammarSampler`) and
``n_probs`` (the top-N log-probabilities of each generated token) run on
the host as in JAX (``quant_gemm_tpu/models/serve.py:118-180``): their
slots' logits rows are read back after the step (eager or replayed) and
the grammar's token replaces the sampled one; a request the grammar
cannot continue finishes with what it has.  The other slots keep the
device sampler.

``act_mode`` is the decode steps' activation mode (``llama.ACT_MODES``:
``"q8_1"`` W4A8, ``"bf16"`` W4A16); ``prefill_a16`` runs the prefill
chunks in ``"bf16"`` while decode stays ``"q8_1"`` (JAX ``serve.py:
281-282``).  A graph's key names its mode, so a chunk graph of one mode
never replays for the other.  :class:`Graphs` (the captures, their pool
and their replays) also serves ``models/speculative.py``.

The loop's work is in spans of :mod:`..tracing` (recorded inside a
profiler window or after ``tracing.start()``): ``serve.step`` around
:meth:`Server.step`; ``serve.admit`` around one request's admission, from
the slot pick to its first token (with its ``rid``, ``slot`` and
``reused`` prompt tokens), holding a ``serve.prefill.chunk`` per chunk
(padding, upload, replay) and its ``serve.sample``; ``serve.decode``
around the batched decode step, holding ``serve.decode.replay`` and
``serve.sample`` (the sampler and its read-back).  Every
:class:`Request` carries its times on ``tracing.now()``: ``t_submit``,
``t_admit`` (slot picked), ``t_first`` (first token sampled), and
``reused``, the prompt tokens taken from its slot's cache.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..kernels import gemm_megalayer, registry
from ..utils import resolve_device, round_up
from ..ops import attention
from . import llama, sampling

PENALTY_WINDOW = 64  # recent tokens a slot's repeat penalty sees
BIAS_SLOTS = 8  # sparse logit-bias entries per request

#: replay each decode step and prefill chunk from a CUDA graph on the card
#: (read per call); False runs them eagerly, as ``jax.disable_jit()``
CUDA_GRAPHS = True


def graph_key(kind: str, size, act_mode: str = "q8_1") -> tuple:
    """The key of a captured step: ``kind`` "decode" with its ``s_hi``
    or "chunk" with its length, its activation mode, and every module
    setting whose route a graph bakes in, read now:
    ``registry.FUSED_DECODE`` (K6), ``gemm_megalayer.ENABLE_QKV`` and
    ``ENABLE_TAIL`` (K2, K8), ``registry.DECODE_M_MAX`` (K1/K7 against
    K4) and ``llama.FLASH_PREFILL_T_MIN`` (K5 against the dense prefill
    attention)."""
    return (kind, size, act_mode, registry.FUSED_DECODE,
            gemm_megalayer.ENABLE_QKV, gemm_megalayer.ENABLE_TAIL,
            registry.DECODE_M_MAX, llama.FLASH_PREFILL_T_MIN)


@dataclasses.dataclass
class Graph:
    """A captured step: the graph, its static output, the launches one
    replay makes by counter (what the counters moved during the capture,
    which ran nothing), the seconds of its eager first call and capture,
    and its replays."""

    graph: object
    out: torch.Tensor
    launches: dict
    capture_s: float
    replays: int = 0


class Graphs:
    """The captured steps of one caller on ``device``, by key, in one
    memory pool: :meth:`run` calls a step eagerly (on the CPU, or with
    :data:`CUDA_GRAPHS` off), or on the card captures it at its key's
    first call and replays it after."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graphs: dict[tuple, Graph] = {}
        self._pool = None

    def captured(self) -> bool:
        return CUDA_GRAPHS and self.device.type == "cuda"

    def run(self, key: tuple, fn) -> torch.Tensor:
        """``fn()`` eagerly, or replayed from the graph of ``key`` (its
        static output, valid until the next replay of that graph)."""
        if not self.captured():
            return fn()
        g = self.graphs.get(key)
        if g is None:
            return self._capture(key, fn)
        g.graph.replay()
        g.replays += 1
        return g.out

    def _capture(self, key: tuple, fn) -> torch.Tensor:
        """Run ``fn`` eagerly on a side stream (this step's result: the
        kernels' builds and occupancy queries happen here, outside the
        capture), then capture it into the pool as ``self.graphs[key]``.
        Raises if the capture fails."""
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn()
        cur.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = registry.counters()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            static = fn()
        moved = {k: v - before[k] for k, v in registry.counters().items()
                 if v != before[k]}
        self.graphs[key] = Graph(graph, static, moved,
                                 time.perf_counter() - t0)
        return out

    def replay_launches(self) -> dict:
        """By counter, what to add to the counters' moves to get the
        launches the card ran: a capture counts one step's launches
        without running them (the eager first call of its key ran that
        step, counted), and each replay runs them unseen."""
        out: collections.Counter = collections.Counter()
        for g in self.graphs.values():
            for name, n in g.launches.items():
                out[name] += n * (g.replays - 1)
        return dict(out)


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
    grammar: Optional[object] = None  # models.grammar.GrammarSampler
    n_probs: int = 0  # top-N logprobs per generated token (llama.cpp)
    cache_prompt: bool = True  # per-request prefix-reuse opt-out
    generated: list = dataclasses.field(default_factory=list)
    probs: list = dataclasses.field(default_factory=list)  # per-token top-N
    done: bool = False
    # on :func:`tracing.now` (ns): queued, slot picked (before the
    # prefill), first token sampled
    t_submit: Optional[int] = None
    t_admit: Optional[int] = None
    t_first: Optional[int] = None
    reused: int = 0  # prompt tokens taken from the slot's cache

    def np_rng(self):
        """The request's numpy generator for host-side (grammar)
        sampling, seeded by ``seed`` or else its id, as in JAX."""
        if not hasattr(self, "_np_rng"):
            self._np_rng = np.random.default_rng(
                self.seed if self.seed is not None else self.rid)
        return self._np_rng


def _adjusted_logits(logits_np: np.ndarray, r: Request,
                     recent: Optional[np.ndarray]) -> np.ndarray:
    """The device sampler's chain before sampling, on the host (JAX
    ``_adjusted_logits``): logit bias, then the repeat penalty over the
    recent window (positive logits divide, negative multiply)."""
    x = logits_np.astype(np.float64, copy=True)
    for tid, bv in (r.logit_bias or {}).items():
        x[int(tid)] += float(bv)
    if r.repeat_penalty != 1.0 and recent is not None:
        seen = np.unique(recent[recent >= 0]).astype(np.int64)
        x[seen] = np.where(x[seen] > 0, x[seen] / r.repeat_penalty,
                           x[seen] * r.repeat_penalty)
    return x


def _top_logprobs(logits_np: np.ndarray, n: int) -> list:
    """[(token id, log-probability)] of the top ``n`` of one position's
    logits (JAX ``_top_logprobs``)."""
    x = logits_np.astype(np.float64)
    x = x - x.max()
    lse = np.log(np.exp(x).sum())
    top = np.argsort(-x)[:n]
    return [(int(t), float(x[t] - lse)) for t in top]


def _grammar_sample(logits_np: np.ndarray, r: Request,
                    recent: Optional[np.ndarray] = None) -> int:
    """Constrained sampling on the host (JAX ``_grammar_sample``): bias
    and repeat penalty, the grammar's mask, then min-p, temperature,
    top-k and top-p over the tokens left; greedy at temperature 0, else
    from the request's numpy generator.  Raises ``ValueError`` when the
    grammar allows no token."""
    adj = _adjusted_logits(logits_np, r, recent)
    masked = r.grammar.filter_logits(adj)
    if not np.isfinite(masked).any():
        raise ValueError(
            f"grammar rejected every token (request {r.rid}) — the "
            "grammar cannot be continued with this vocabulary")
    if r.temperature <= 0:
        return int(np.argmax(masked))
    if 0.0 < r.min_p <= 1.0:
        # llama.cpp min-p: threshold on the raw (pre-temperature) dist
        masked = np.where(masked >= masked.max() + np.log(r.min_p),
                          masked, -np.inf)
    x = masked / r.temperature
    if r.top_k:
        k = min(int(r.top_k), int(np.isfinite(x).sum()))
        if k > 0:
            kth = np.sort(x)[-k]
            x = np.where(x >= kth, x, -np.inf)
    x = x - x[np.isfinite(x)].max()
    p = np.exp(np.where(np.isfinite(x), x, -np.inf))
    p /= p.sum()
    if 0.0 < r.top_p < 1.0:
        order = np.argsort(-p)
        csum = np.cumsum(p[order])
        cut = np.searchsorted(csum, r.top_p) + 1
        keep = order[:cut]
        mask = np.zeros_like(p)
        mask[keep] = p[keep]
        p = mask / mask.sum()
    return int(r.np_rng().choice(len(p), p=p))


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
        cache_prompt: bool = True,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if act_mode not in llama.ACT_MODES:
            raise ValueError(f"act_mode must be one of {llama.ACT_MODES}, "
                             f"not {act_mode!r}")
        llama.check_config(cfg)
        if cfg.ring and context_shift:
            raise ValueError("a ring cache does not shift (llama."
                             "shift_context); its generation is bounded by "
                             "max_seq, the RoPE table's size")
        if cfg.ring and prefill_bucket > cfg.ring_chunk:
            raise ValueError(f"prefill_bucket {prefill_bucket} exceeds "
                             f"ring_chunk {cfg.ring_chunk}")
        if qparams["embed"].device != self.device:
            raise ValueError(f"qparams live on {qparams['embed'].device}, "
                             f"the server on {self.device}")
        self.qparams = qparams
        self.cfg = cfg
        self.n_slots = n_slots
        self.act_mode = act_mode
        self.prefill_mode = ("bf16" if prefill_a16 and act_mode == "q8_1"
                             else act_mode)
        self.bucket = prefill_bucket
        self.eos_id = eos_id
        self.max_chunk = max_prefill_chunk or prefill_bucket * 8
        if cfg.ring:
            # every forward call, bucket padding included, stays within
            # ring_chunk tokens
            self.max_chunk = min(self.max_chunk, cfg.ring_chunk
                                 // prefill_bucket * prefill_bucket)
        self.cache_prompt = cache_prompt and not cfg.ring
        self.context_shift = context_shift
        self._shift_keep = max(cfg.window or cfg.max_seq // 2, 1)
        self.cache_qtype = cache_qtype
        self.cache = llama.KVCache.init(cfg, n_slots, cache_qtype,
                                        device=self.device)
        # the one-slot cache every prefill runs on, made at first use
        self._stage: Optional[llama.KVCache] = None
        # static device buffers the steps read their tokens from
        self._tokens = torch.zeros(n_slots, 1, dtype=torch.int64,
                                   device=self.device)
        self._chunk_tokens: dict[int, torch.Tensor] = {}
        self._routes: dict[tuple, tuple] = {}  # graph key -> llama.routes
        self._graphs = Graphs(self.device)
        #: the captured steps by :func:`graph_key`
        self.graphs = self._graphs.graphs
        self.slots: list[Optional[Request]] = [None] * n_slots
        self.queue: list[Request] = []
        self.finished: dict[int, Request] = {}
        self._next_rid = 0
        self._rope = llama.rope_for(cfg, qparams, self.device)
        self._pending_tok = np.zeros(n_slots, np.int64)
        # host mirror of cache.pos, every slot's (decode advances them all)
        self._hpos = np.zeros(n_slots, np.int64)
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
        # prompt-prefix cache: per slot, the tokens its cache rows
        # currently hold from position 0
        self._history: list[list[int]] = [[] for _ in range(n_slots)]
        self._n_cached_tokens = 0
        self._prefill_s = 0.0
        self._decode_s = 0.0

    # -- request lifecycle ---------------------------------------------------

    def submit(self, prompt: list, max_new: int = 16,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               min_p: float = 0.0, repeat_penalty: float = 1.0,
               logit_bias: Optional[dict] = None, seed: Optional[int] = None,
               grammar=None, n_probs: int = 0,
               cache_prompt: bool = True) -> int:
        """Queue a request; returns its id.  ``grammar``: a
        :class:`~.grammar.GrammarSampler` that constrains its tokens;
        ``n_probs``: report the top-N log-probabilities of each generated
        token (``Request.probs``, of the distribution it is sampled from);
        ``cache_prompt=False`` opts this request out of prefix reuse."""
        if not prompt:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if logit_bias and len(logit_bias) > BIAS_SLOTS:
            raise ValueError(f"at most {BIAS_SLOTS} logit biases per request")
        r = Request(self._next_rid, list(prompt), max_new,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    min_p=min_p, repeat_penalty=repeat_penalty,
                    logit_bias=logit_bias, seed=seed, grammar=grammar,
                    n_probs=int(n_probs), cache_prompt=bool(cache_prompt),
                    t_submit=tracing.now())
        self._next_rid += 1
        self.queue.append(r)
        return r.rid

    # -- the steps, eager or replayed ----------------------------------------

    def _forward(self, key: tuple, tokens: torch.Tensor,
                 cache: llama.KVCache, s_hi=None):
        """The step of ``key`` as a call: the forward of the static
        ``tokens`` on ``cache`` in the key's activation mode, with its
        routes decided once per key; returns the logits."""
        mode = key[2]
        route = self._routes.get(key)
        if route is None:
            route = self._routes[key] = llama.routes(
                self.qparams, self.cfg, *tokens.shape, act_mode=mode)
        return lambda: llama.forward(
            self.qparams, self.cfg, tokens, cache, act_mode=mode,
            rope_cache=self._rope, s_hi=s_hi, route=route)[0]

    def _run(self, key: tuple, fn) -> torch.Tensor:
        return self._graphs.run(key, fn)

    def replay_launches(self) -> dict:
        """:meth:`Graphs.replay_launches` of this Server's graphs."""
        return self._graphs.replay_launches()

    def _chunk(self, tokens: list, t: int, cache: llama.KVCache,
               rid: int = -1):
        """One bucket-padded prefill chunk of ``tokens`` (length <= t) on
        ``cache`` through the static [1, t] buffer, for request ``rid``;
        returns the logits of its last real token."""
        with tracing.span("serve.prefill.chunk", rid):
            buf = self._chunk_tokens.get(t)
            if buf is None:
                buf = self._chunk_tokens[t] = torch.zeros(
                    1, t, dtype=torch.int64, device=self.device)
            padded = np.zeros((1, t), np.int64)
            padded[0, : len(tokens)] = tokens
            buf.copy_(torch.from_numpy(padded))
            key = graph_key("chunk", t, self.prefill_mode)
            logits = self._run(key, self._forward(key, buf, cache))
            return logits[0, len(tokens) - 1].clone()

    def _staging(self) -> llama.KVCache:
        if self._stage is None:
            self._stage = llama.KVCache.init(self.cfg, 1, self.cache_qtype,
                                             device=self.device)
        return self._stage

    def _prefill(self, slot: int, prompt: list, start: int = 0,
                 rid: int = -1):
        """Chunked prefill of ``prompt[start:]`` into its slot, whose
        first ``start`` rows already hold the prompt's prefix, through
        the staging cache: the slot copied in where ``start`` > 0 (else
        the staging cache's rows from an earlier prefill stay, past
        ``pos`` and so masked, as a fresh cache's zeros are), the chunks
        run, and the staging cache copied into the slot, as JAX extracts
        and inserts it (``rid``: the request's, for the chunks' spans).
        Returns the last prompt position's logits."""
        c = self.cache
        one = slice(slot, slot + 1)
        slab = [t[:, one] for t in c.buffers()]
        c1 = self._staging()
        if start:
            for dst, src in zip(c1.buffers(), slab):
                dst.copy_(src)
        c1.pos.fill_(start)
        off = start
        while off < len(prompt):
            part = prompt[off: off + self.max_chunk]
            t = max(self.bucket, round_up(len(part), self.bucket))
            # the padded tail writes garbage past the real tokens; pos
            # advances only by the real length so the next chunk overwrites
            last = self._chunk(part, t, c1, rid)
            c1.pos.fill_(off + len(part))
            off += len(part)
        for dst, src in zip(slab, c1.buffers()):
            dst.copy_(src)
        self.cache.pos[slot] = len(prompt)
        return last

    @staticmethod
    def _common_prefix(a: list, b: list) -> int:
        n = 0
        for x, y in zip(a, b):
            if x != y:
                break
            n += 1
        return n

    def _pick_slot(self, prompt: list, want_cache: bool = True):
        """Free slot with the longest materialized shared prefix (ties ->
        first free); returns (slot, reuse_len)."""
        free = [s for s in range(self.n_slots) if self.slots[s] is None]
        if not free:
            return None, 0
        if not (self.cache_prompt and want_cache):
            return free[0], 0
        best, best_n = free[0], 0
        for s in free:
            # the last prompt token is always evaluated (its logits seed
            # generation), and reuse below a bucket is not worth it
            n = min(self._common_prefix(self._history[s], prompt),
                    len(prompt) - 1)
            if n > best_n:
                best, best_n = s, n
        return best, (best_n if best_n >= self.bucket else 0)

    def _admit(self) -> None:
        """Admit queued requests in order while a slot is free."""
        while self.queue and None in self.slots:
            r = self.queue.pop(0)
            with tracing.span("serve.admit", r.rid) as sp:
                s, reuse = self._pick_slot(r.prompt, r.cache_prompt)
                sp.note(slot=s, reused=reuse)
                self._admit_to(r, s, reuse)

    def _admit_to(self, r: Request, s: int, reuse: int) -> None:
        """Prefill ``r`` into the free slot ``s``, whose cache holds its
        first ``reuse`` prompt tokens, and sample its first token."""
        r.t_admit = tracing.now()
        r.reused = reuse
        last_logits = self._prefill(s, r.prompt, reuse, r.rid)
        self._hpos[s] = len(r.prompt)
        self._n_cached_tokens += reuse
        self._history[s] = list(r.prompt)
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
        with tracing.span("serve.sample", r.rid):
            if r.n_probs or r.grammar is not None:
                host = last_logits.cpu().numpy()
            if r.n_probs:
                # the distribution the token is sampled from (after bias
                # and penalty), as JAX reports it
                r.probs.append(_top_logprobs(
                    _adjusted_logits(host, r, self._recent[s]), r.n_probs))
            if r.grammar is not None:
                try:
                    tok = _grammar_sample(host, r, self._recent[s])
                    r.grammar.accept(tok)
                except ValueError:
                    # no token continues the grammar: finish empty
                    self._prefill_s += (tracing.now() - r.t_admit) / 1e9
                    r.done = True
                    self.finished[r.rid] = r
                    return
            else:
                sl = slice(s, s + 1)
                tok = int(sampling.sample(
                    last_logits[None], [gen], self._temps[sl],
                    self._topk[sl], self._topp[sl], self._minp[sl],
                    self._recent[sl], self._rpen[sl], self._bias_ids[sl],
                    self._bias_vals[sl])[0])
        r.t_first = tracing.now()
        self._prefill_s += (r.t_first - r.t_admit) / 1e9
        r.generated.append(tok)
        self._n_prefill_tokens += len(r.prompt) - reuse
        self._n_tokens += 1
        if (len(r.generated) >= r.max_new
                or (self.eos_id is not None and tok == self.eos_id)):
            r.done = True
            self.finished[r.rid] = r
            return
        self._pending_tok[s] = tok
        self._recent[s] = np.roll(self._recent[s], -1)
        self._recent[s, -1] = tok
        self.slots[s] = r

    def step(self) -> dict[int, int]:
        """Admit queued requests, run one batched decode step; returns
        {request_id: new_token} for slots that produced a token."""
        with tracing.span("serve.step"):
            self._admit()
            active = [s for s in range(self.n_slots)
                      if self.slots[s] is not None]
            if not active:
                return {}
            if (self.context_shift
                    and self._hpos.max() >= self.cfg.max_seq - 1):
                llama.shift_context(self.cache, self.cfg, self._shift_keep,
                                    rope_cache=self._rope)
                # every slot's rows moved: no prefix starts at position 0
                self._history = [[] for _ in range(self.n_slots)]
                self._hpos = self.cache.pos.cpu().numpy().astype(np.int64)
            with tracing.span("serve.decode"):
                return self._decode(active)

    def _decode(self, active: list) -> dict[int, int]:
        """One batched decode step of every slot; the tokens of the
        ``active`` ones, by request id."""
        t0 = time.perf_counter()
        self._tokens.copy_(torch.from_numpy(self._pending_tok[:, None]))
        # K3's static bound from the batch's longest slot, capped by the
        # window, as the JAX Server picks its attn_s_hi
        max_ctx = int(max(self._hpos[s] for s in active))
        if self.cfg.window:
            max_ctx = min(max_ctx, self.cfg.window)
        s_hi = attention.decode_s_hi(max_ctx)
        key = graph_key("decode", s_hi, self.act_mode)
        with tracing.span("serve.decode.replay"):
            logits = self._run(key, self._forward(key, self._tokens,
                                                  self.cache, s_hi))
        with tracing.span("serve.sample"):
            nxt = sampling.sample(
                logits[:, -1], self._gens, self._temps, self._topk,
                self._topp, self._minp, self._recent, self._rpen,
                self._bias_ids, self._bias_vals).cpu().numpy()
            dead = self._host_sampled(active, logits, nxt)
        self._decode_s += time.perf_counter() - t0
        self._hpos += 1  # every slot's cache.pos advanced by one
        self._n_steps += 1
        self._n_tokens += len(active)
        self._n_decode_tokens += len(active)
        out = {}
        for s in active:
            if s in dead:
                continue  # the grammar finished it this step
            r = self.slots[s]
            tok = int(nxt[s])
            r.generated.append(tok)
            # the token fed this step was written into the slot's cache
            self._history[s].append(int(self._pending_tok[s]))
            self._pending_tok[s] = tok
            self._recent[s] = np.roll(self._recent[s], -1)
            self._recent[s, -1] = tok
            out[r.rid] = tok
            if (len(r.generated) >= r.max_new
                    or (self.eos_id is not None and tok == self.eos_id)
                    or (not self.context_shift
                        and self._hpos[s] >= self.cfg.max_seq - 1)):
                r.done = True
                self.finished[r.rid] = r
                self.slots[s] = None
        return out

    def _host_sampled(self, active: list, logits: torch.Tensor,
                      nxt: np.ndarray) -> set:
        """The host side of a decode step (JAX ``serve.py:545-585``):
        record the ``n_probs`` slots' top log-probabilities and replace
        the grammar slots' tokens in ``nxt`` by the grammar's (the
        device's pick never reached the cache).  Reads only those slots'
        logits rows.  Returns the slots whose request the grammar
        finished (released)."""
        gslots = [s for s in active if self.slots[s].grammar is not None]
        pslots = [s for s in active if self.slots[s].n_probs]
        if not (gslots or pslots):
            return set()
        rows = sorted(set(gslots) | set(pslots))
        host = dict(zip(rows, logits[rows, -1].cpu().numpy()))
        for s in pslots:
            r = self.slots[s]
            r.probs.append(_top_logprobs(
                _adjusted_logits(host[s], r, self._recent[s]), r.n_probs))
        dead = set()
        for s in gslots:
            r = self.slots[s]
            try:
                tok = _grammar_sample(host[s], r, self._recent[s])
                r.grammar.accept(tok)
                nxt[s] = tok
            except ValueError:
                # the vocabulary cannot continue the grammar: finish the
                # request with what it has, not the serving loop
                r.done = True
                self.finished[r.rid] = r
                self.slots[s] = None
                dead.add(s)
        return dead

    def cancel(self, rid: int) -> bool:
        """Stop a request early (a stop string matched, or the client went
        away): it moves to ``finished`` with what it generated so far.
        Returns False when no running or queued request has this id."""
        for s in range(self.n_slots):
            r = self.slots[s]
            if r is not None and r.rid == rid:
                r.done = True
                self.finished[rid] = r
                self.slots[s] = None
                return True
        for i, r in enumerate(self.queue):
            if r.rid == rid:
                r.done = True
                self.finished[rid] = self.queue.pop(i)
                return True
        return False

    def stats(self) -> dict:
        """Serving counters, plus host-clock seconds spent in prefill
        (admission, first token included) and in decode steps; both end
        in a device-to-host read, so they cover the device work.  The
        graphs' first calls and captures are inside those seconds;
        ``capture_seconds`` is their sum."""
        return {
            "graphs": len(self.graphs),
            "graph_replays": sum(g.replays for g in self.graphs.values()),
            "capture_seconds": sum(g.capture_s
                                   for g in self.graphs.values()),
            "decode_steps": self._n_steps,
            "generated_tokens": self._n_tokens,
            "prefill_tokens": self._n_prefill_tokens,
            "active_slots": sum(s is not None for s in self.slots),
            "queued": len(self.queue),
            "finished": len(self.finished),
            "tokens_per_step": (self._n_decode_tokens / self._n_steps
                                if self._n_steps else 0.0),
            "decode_tokens": self._n_decode_tokens,
            "cached_prompt_tokens": self._n_cached_tokens,
            "prefill_seconds": self._prefill_s,
            "decode_seconds": self._decode_s,
        }

    def run_until_done(self, max_steps: int = 10_000) -> dict[int, list]:
        """Drain the queue; returns {request_id: generated tokens}."""
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                break
            self.step()
        return {rid: r.generated for rid, r in self.finished.items()}


__all__ = ["Server", "Request", "Graph", "Graphs", "graph_key",
           "CUDA_GRAPHS"]
