"""Speculative decoding over the quantized Llama forward.

Counterpart of ``quant_gemm_tpu/models/speculative.py``: a small draft
model proposes ``k`` tokens per round from its own KV cache; the target
scores the whole proposal in one [B, k + 1] block forward, and the
longest agreeing prefix plus one token of the target's own (the
correction on a mismatch, a bonus when everything matched) is accepted.
Greedy acceptance gives the target's own greedy decode wherever near-tied
logits argmax the same way in the T = 1 step and the T = k + 1 block
(different compute paths: at B (k + 1) > ``registry.DECODE_M_MAX`` the
block's GEMMs take K4 where the draft's take K1), as JAX says of its own.

Per round, with pos0 the target cache's ``pos`` (the index of the last
accepted token ``last``, not yet written):

    block   = [last, props[0..k-1]]          written at pos0 .. pos0+k
    lg[i]   verifies props[i] for i < k; lg[k] is the bonus prediction
    m       = longest matching prefix; emit props[:m] + one more token
    rewind  both caches' ``pos`` to pos0 + m + 1

The draft runs k + 1 forwards, so the last proposal's k/v is written
before a fully accepted round moves ``pos`` past it.  A rejected suffix
stays in the caches, masked by ``pos`` and overwritten by the next round;
the rewind writes ``pos`` in place, the storage the captured steps read.
``max_seq`` of both models must hold prompt + steps + k + 1 positions.

On the card the draft's T = 1 step (one graph per K3 bound ``s_hi``, as
the Server's decode) and the target's verify block replay from CUDA
graphs (``serve.Graphs``); the prompt's prefill runs once, eagerly.
Rounds are stepped on the host, as acceptance is data-dependent.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.attention import decode_s_hi
from . import llama, sampling, serve


def _argmax(logits: torch.Tensor) -> np.ndarray:
    return torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int64)


def _spec_decode(qp_target, cfg_target, qp_draft, cfg_draft, prompt, steps,
                 k, act_mode, graphs, first_token, propose, judge):
    """The draft-verify rounds both accept rules share.

    ``first_token(lg [B, V]) -> np [B]``: the first generated token.
    ``propose(lg [B, V], i, state) -> np [B]``: the draft's token i.
    ``judge(props [B, k], lg_t [B, k+1, V], state) -> (accepted [B],
    next_tok [B])``.  ``state``: a fresh dict per round."""
    if cfg_target.vocab != cfg_draft.vocab:
        raise ValueError(f"target vocab {cfg_target.vocab} != draft vocab "
                         f"{cfg_draft.vocab}")
    dev = qp_target["embed"].device
    prompt = (prompt if isinstance(prompt, torch.Tensor)
              else torch.as_tensor(np.asarray(prompt))).to(dev, torch.int64)
    b, t0 = prompt.shape
    for name, cfg in (("target", cfg_target), ("draft", cfg_draft)):
        if cfg.max_seq < t0 + steps + k + 1:
            raise ValueError(f"the {name}'s max_seq {cfg.max_seq} does not "
                             f"hold prompt + steps + k + 1 = "
                             f"{t0 + steps + k + 1} positions")
    graphs = graphs if graphs is not None else serve.Graphs(dev)
    models = {
        "target": (qp_target, cfg_target, llama.KVCache.init(
            cfg_target, b, device=dev), llama.rope_for(cfg_target,
                                                       qp_target, dev)),
        "draft": (qp_draft, cfg_draft, llama.KVCache.init(
            cfg_draft, b, device=dev), llama.rope_for(cfg_draft, qp_draft,
                                                      dev))}
    # the static inputs the captured steps read
    tok_d = torch.zeros(b, 1, dtype=torch.int64, device=dev)
    block = torch.zeros(b, k + 1, dtype=torch.int64, device=dev)
    route_of: dict = {}

    def run(which, kind, size, tokens, s_hi=None):
        qp, cfg, cache, rope = models[which]
        key = serve.graph_key(kind, size, act_mode)
        if key not in route_of:
            route_of[key] = llama.routes(qp, cfg, *tokens.shape,
                                         act_mode=act_mode)
        return graphs.run(key, lambda: llama.forward(
            qp, cfg, tokens, cache, act_mode=act_mode, rope_cache=rope,
            s_hi=s_hi, route=route_of[key])[0])

    for which in ("target", "draft"):
        qp, cfg, cache, rope = models[which]
        logits, _ = llama.forward(qp, cfg, prompt, cache, act_mode=act_mode,
                                  rope_cache=rope)
        if which == "target":
            first = np.asarray(first_token(logits[:, -1]), np.int64)
    target_calls = 1
    out = [[int(first[s])] for s in range(b)]
    last = first
    hpos = np.full(b, t0, np.int64)  # host mirror of both caches' pos
    window = cfg_draft.window
    while min(len(o) for o in out) < steps:
        state: dict = {}
        props = np.zeros((b, k), np.int64)
        tok_d.copy_(torch.from_numpy(last[:, None].copy()))
        for i in range(k + 1):
            # K3's bound covers this step's newest position, pos0 + i
            ctx = int(hpos.max()) + i
            s_hi = decode_s_hi(min(ctx, window) if window else ctx)
            lg = run("draft", "draft", s_hi, tok_d, s_hi)
            if i == k:
                break
            props[:, i] = propose(lg[:, -1], i, state)
            tok_d.copy_(torch.from_numpy(props[:, i:i + 1].copy()))
        block.copy_(torch.from_numpy(
            np.concatenate([last[:, None], props], axis=1)))
        lg_t = run("target", "verify", k + 1, block)  # [B, k+1, V]
        target_calls += 1
        accepted, nxt = judge(props, lg_t, state)
        for s in range(b):
            out[s].extend(int(t) for t in props[s, : accepted[s]])
            out[s].append(int(nxt[s]))
        hpos = hpos + np.asarray(accepted, np.int64) + 1
        new_pos = torch.from_numpy(hpos.astype(np.int32)).to(dev)
        for which in ("target", "draft"):
            models[which][2].pos.copy_(new_pos)
        last = np.array([o[-1] for o in out], np.int64)
    toks = torch.tensor([o[:steps] for o in out], dtype=torch.int64,
                        device=dev)
    rate = float(np.mean([len(o) for o in out])) / target_calls
    return toks, rate


def best_rate(steps: int, k: int) -> float:
    """Tokens per target call when every proposal is accepted: the
    prompt's call gives the first token, each round k + 1 more, until
    ``steps`` (4.71 for 64 tokens at k = 4, not k + 1)."""
    rounds = -(-(steps - 1) // (k + 1))
    return (1 + (k + 1) * rounds) / (1 + rounds)


def speculative_greedy_decode(qp_target: dict, cfg_target, qp_draft: dict,
                              cfg_draft, prompt, steps: int, *, k: int = 4,
                              act_mode: str = "q8_1",
                              graphs: Optional[serve.Graphs] = None):
    """Generate ``steps`` tokens per row of ``prompt`` [B, T0]; returns
    (tokens int64 [B, steps], tokens per target call): plain decode is
    1.0, a draft the target always agrees with reaches k + 1.
    ``graphs``: the :class:`~.serve.Graphs` to capture into (default a
    new one), for a caller that reads its replays."""

    def first_token(lg):
        return _argmax(lg)

    def propose(lg, i, state):
        return _argmax(lg)

    def judge(props, lg_t, state):
        greedy_t = _argmax(lg_t)  # [B, k+1]
        b = props.shape[0]
        accepted = np.zeros(b, np.int64)
        nxt = np.zeros(b, np.int64)
        for s in range(b):
            m = 0
            while m < k and greedy_t[s, m] == props[s, m]:
                m += 1
            accepted[s] = m
            # m < k: the target's correction; m == k: a bonus token
            nxt[s] = greedy_t[s, m]
        return accepted, nxt

    return _spec_decode(qp_target, cfg_target, qp_draft, cfg_draft, prompt,
                        steps, k, act_mode, graphs, first_token, propose,
                        judge)


def accept_or_residual(p_t: np.ndarray, p_d: np.ndarray, x: int,
                       u: float) -> tuple:
    """One step of speculative rejection sampling (Leviathan et al.): the
    draft proposed ``x ~ p_d``; accept it when ``u < min(1, p_t[x] /
    p_d[x])``, else return the residual ``max(0, p_t - p_d)``
    (normalised) to draw the replacement from.  The output distribution
    is exactly ``p_t``:

        P(y) = p_d(y) min(1, p_t(y) / p_d(y)) + P(reject) residual(y)
    """
    ratio = float(p_t[x]) / max(float(p_d[x]), 1e-30)
    if u < min(1.0, ratio):
        return True, None
    res = np.maximum(p_t - p_d, 0.0)
    z = res.sum()
    if z <= 0:  # p_t == p_d numerically: a rejection was ~impossible
        return False, p_t / max(p_t.sum(), 1e-30)
    return False, res / z


def speculative_sample_decode(qp_target: dict, cfg_target, qp_draft: dict,
                              cfg_draft, prompt, steps: int, *, k: int = 4,
                              temperature: float = 1.0, top_k: int = 0,
                              top_p: float = 1.0, seed: int = 0,
                              act_mode: str = "q8_1",
                              graphs: Optional[serve.Graphs] = None):
    """Speculative decoding with sampling: rejection sampling at each
    proposal keeps the output distribution exactly the target's
    (:func:`accept_or_residual`); both models' distributions take the
    same temperature / top-k / top-p.  Row s draws from numpy's
    ``default_rng(SeedSequence([seed, s]))``, as in JAX.  ``temperature
    <= 0`` is :func:`speculative_greedy_decode`.  Returns (tokens [B,
    steps], tokens per target call)."""
    if temperature <= 0:
        return speculative_greedy_decode(
            qp_target, cfg_target, qp_draft, cfg_draft, prompt, steps, k=k,
            act_mode=act_mode, graphs=graphs)
    b = len(prompt)
    v = cfg_target.vocab
    dev = qp_target["embed"].device

    def probs_of(logits):  # [R, V] -> the filtered sampling distribution
        r = logits.shape[0]
        scaled = logits.to(torch.float32) / max(temperature, 1e-6)
        kept = sampling.filter_logits(
            scaled, torch.full((r,), top_k, dtype=torch.int64, device=dev),
            torch.full((r,), top_p, dtype=torch.float32, device=dev))
        return torch.softmax(kept, dim=-1).cpu().numpy()

    rngs = [np.random.default_rng(np.random.SeedSequence([seed, s]))
            for s in range(b)]

    def first_token(lg):
        p0 = probs_of(lg)
        return np.array([rngs[s].choice(v, p=p0[s]) for s in range(b)])

    def propose(lg, i, state):
        pd = state.setdefault("pd", np.zeros((b, k, v), np.float32))
        pd[:, i] = probs_of(lg)
        return np.array([rngs[s].choice(v, p=pd[s, i]) for s in range(b)])

    def judge(props, lg_t, state):
        pd = state["pd"]
        pt = probs_of(lg_t.reshape(b * (k + 1), v)).reshape(b, k + 1, v)
        accepted = np.zeros(b, np.int64)
        nxt = np.zeros(b, np.int64)
        for s in range(b):
            m = 0
            chosen = None
            while m < k:
                ok, res = accept_or_residual(pt[s, m], pd[s, m],
                                             int(props[s, m]),
                                             float(rngs[s].random()))
                if not ok:
                    chosen = int(rngs[s].choice(v, p=res))
                    break
                m += 1
            if chosen is None:  # all accepted: the bonus from the target
                chosen = int(rngs[s].choice(v, p=pt[s, k]))
            accepted[s] = m
            nxt[s] = chosen
        return accepted, nxt

    return _spec_decode(qp_target, cfg_target, qp_draft, cfg_draft, prompt,
                        steps, k, act_mode, graphs, first_token, propose,
                        judge)


__all__ = ["speculative_greedy_decode", "speculative_sample_decode",
           "accept_or_residual", "best_rate"]
