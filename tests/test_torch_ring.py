"""The ring KV cache and ``context_shift`` of the port against the JAX
package, on the CPU.

The ring holds token g at slot ``g % R``: window 48 and ``ring_chunk`` 64
give R = 128 (``LlamaConfig.ring_capacity``), and a prompt of 160 tokens
prefilled in chunks of 16, 64, 64 and 16 wraps it, the third chunk
straddling the ring's edge through K5 (T = 64), the last wrapped on the
dense path (T < 64).  JAX's Pallas kernels run in interpret mode.

Tolerances:

* K3 / K5 plain ring forms against JAX's kernels: ``atol=1e-5`` (both
  float32 from the same inputs, softmax sums in another order; the rule
  of ``tests/test_torch_attention.py``);
* logits of ``forward``, each side quantizing its own activations: the
  free-run limits of ``tests/test_torch_model.py``, ``max|delta| <= 2e-2
  * max|logits|`` and NMSE <= 2e-4 (Q8_1 codes flip at .5 ties between
  XLA's and PyTorch's float32 rounding);
* the port's ring run against its own linear windowed run: ``2e-2 *
  max|logits|``, as JAX holds its two (``tests/test_ring_cache.py``): the
  attention sets are equal, the tile orders differ;
* ``shift_context``: bit-equal to JAX's on both caches (the rotation is
  the same float32 expression, the requantization bit-equal
  ``_quant_kv``);
* greedy transcripts (ring Server, ``context_shift`` Server): at every
  step JAX's token is the port's argmax along JAX's transcript, or within
  twice the logit tolerance of it (the near-tie rule of
  ``tests/test_torch_model.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_gemm_tpu.models import llama as jl
from quant_gemm_tpu.models import serve as js
from quant_gemm_tpu.ops import attention as jattn
from quant_gemm_tpu_torch.models import convert
from quant_gemm_tpu_torch.models import llama as tl
from quant_gemm_tpu_torch.models import serve as ts
from quant_gemm_tpu_torch.ops.attention import (flash_decode_plain,
                                                flash_prefill,
                                                flash_prefill_plain)

ATOL = 1e-5
LOGIT_TOL = 2e-2
NMSE_TOL = 2e-4
R, W = 128, 48
BASE = dict(vocab=64, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=256, window=W)
JRING = jl.LlamaConfig(max_seq=512, ring=True, ring_chunk=64, **BASE)
TRING = tl.LlamaConfig(**JRING._asdict())
TLIN = TRING._replace(ring=False)
CHUNKS = (16, 64, 64, 16)  # 160 tokens: K5 straddles slot R at 80..143


@pytest.fixture(scope="module")
def models():
    params = jl.init_params(JRING, seed=3)
    return (jl.quantize_params(params),
            tl.quantize_params(params, device="cpu"))


def _assert_logits_close(got, want, tol=LOGIT_TOL, nmse=NMSE_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    if nmse is not None:
        assert ((got - want) ** 2).sum() <= nmse * (want ** 2).sum()


def _kv(rng, shape, quant):
    """k, v (and scales) as torch tensors and as JAX arrays."""
    if not quant:
        x = torch.from_numpy(rng.standard_normal((2, *shape))
                             .astype(np.float32)).to(torch.bfloat16)
        j = jnp.asarray(x.float().numpy(), jnp.bfloat16)
        return (x[0], x[1], None, None), (j[0], j[1], None, None)
    codes = rng.integers(-127, 128, (2, *shape)).astype(np.int8)
    sc = rng.uniform(0.005, 0.03, (2, *shape[:-1])).astype(np.float32)
    return ((*torch.from_numpy(codes), *torch.from_numpy(sc)),
            (*jnp.asarray(codes), *jnp.asarray(sc)))


@pytest.mark.parametrize("current", [True, False])
@pytest.mark.parametrize("quant", [False, True])
def test_flash_decode_ring_plain_matches_jax(quant, current):
    """Positions before the wrap (5, 47), at it (127, 128) and past it
    (150, 300), over the JAX ring buffer (R slots and its write margin,
    which neither attends), stacked cache with ``layer=``."""
    rng = np.random.default_rng(0)
    b, kv, rep, hd = 6, 2, 2, 64
    q = rng.standard_normal((b, kv, rep, hd)).astype(np.float32)
    tc, jc = _kv(rng, (2, b, kv, R + 32, hd), quant)
    pos = np.array([5, 47, 127, 128, 150, 300], np.int32)
    cur = torch.from_numpy(rng.standard_normal((2, b, kv, 1, hd))
                           .astype(np.float32)).to(torch.bfloat16)
    jcur = jnp.asarray(cur.float().numpy(), jnp.bfloat16)
    tk = dict(k_current=cur[0], v_current=cur[1]) if current else {}
    jk = dict(k_current=jcur[0], v_current=jcur[1]) if current else {}
    got = flash_decode_plain(torch.from_numpy(q), tc[0], tc[1],
                             torch.from_numpy(pos), k_scale=tc[2],
                             v_scale=tc[3], layer=1, window=W, ring=R, **tk)
    want = jattn.flash_decode(jnp.asarray(q), jc[0], jc[1], jnp.asarray(pos),
                              k_scale=jc[2], v_scale=jc[3], layer=1,
                              window=W, ring=R, **jk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("quant", [False, True])
def test_flash_prefill_ring_plain_matches_jax(quant):
    """A 32-token chunk at pos0 112 (straddling slot R), 0 and 200 (past
    the wrap)."""
    rng = np.random.default_rng(1)
    b, kv, rep, t, hd = 3, 2, 2, 32, 64
    q = rng.standard_normal((b, kv, t * rep, hd)).astype(np.float32)
    tc, jc = _kv(rng, (b, kv, R + 32, hd), quant)
    pos0 = np.array([112, 0, 200], np.int32)
    got = flash_prefill(torch.from_numpy(q), tc[0], tc[1],
                        torch.from_numpy(pos0), rep=rep, k_scale=tc[2],
                        v_scale=tc[3], window=W, ring=R)
    want = jattn.flash_prefill(jnp.asarray(q), jc[0], jc[1],
                               jnp.asarray(pos0), rep=rep, k_scale=jc[2],
                               v_scale=jc[3], window=W, ring=R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def _chunked(forward, cache, toks, n_decode=3):
    """Prefill ``toks`` [B, 160] in CHUNKS, then ``n_decode`` decode steps
    on fixed tokens; each call's logits."""
    outs, off = [], 0
    for t in CHUNKS:
        out, cache = forward(toks[:, off:off + t], cache)
        outs.append(np.asarray(out))
        off += t
    rng = np.random.default_rng(7)
    for _ in range(n_decode):
        nt = rng.integers(0, BASE["vocab"], (toks.shape[0], 1))
        out, cache = forward(nt.astype(np.int32), cache)
        outs.append(np.asarray(out))
    return outs, cache


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(2).integers(
        0, BASE["vocab"], (2, sum(CHUNKS))).astype(np.int32)


def _port_run(qt, cfg, toks, cache):
    return _chunked(lambda t, c: tl.forward(qt, cfg, torch.from_numpy(t), c),
                    cache, toks)


@pytest.mark.parametrize("qtype", ["bf16", "q8"])
def test_ring_forward_matches_jax(models, tokens, qtype):
    """Chunked prefill across the wrap, then 3 decode steps past it, both
    started from one JAX ring cache (``convert.cache_from_jax(...,
    ring=R)`` drops its write margin); the caches end equal on the rows
    written (NMSE of the values, the same rows set)."""
    qj, qt = models
    cj = jl.KVCache.init(JRING, 2, qtype)
    ct = convert.cache_from_jax(jax.tree_util.tree_map(np.asarray, cj),
                                device="cpu", ring=R)
    assert ct.k.shape[3] == R and cj.k.shape[3] == R + JRING.ring_chunk
    outs_j, cj = _chunked(lambda t, c: jl.jit_forward(qj, JRING,
                                                      jnp.asarray(t), c),
                          cj, tokens)
    outs_t, ct = _port_run(qt, TRING, tokens, ct)
    for got, want in zip(outs_t, outs_j):
        _assert_logits_close(got, want)
    cj = convert.cache_from_jax(jax.tree_util.tree_map(np.asarray, cj),
                                device="cpu", ring=R)
    assert torch.equal(cj.pos, ct.pos)
    for a, b, sa, sb in ((cj.k, ct.k, cj.ks, ct.ks), (cj.v, ct.v, cj.vs,
                                                      ct.vs)):
        a, b = a.float(), b.float()
        if sa is not None:
            a, b = a * sa[..., None], b * sb[..., None]
        assert torch.equal((a != 0).any(-1), (b != 0).any(-1))
        assert ((a - b) ** 2).sum() <= NMSE_TOL * (a ** 2).sum()


@pytest.mark.parametrize("qtype", ["bf16", "q8"])
def test_ring_matches_linear_window(models, tokens, qtype):
    """The port's ring run equals its own linear windowed run on the same
    tokens to ``2e-2 * max|logits|`` (JAX's rule for its two)."""
    _, qt = models
    ring, _ = _port_run(qt, TRING, tokens,
                        tl.KVCache.init(TRING, 2, qtype, device="cpu"))
    lin, _ = _port_run(qt, TLIN, tokens,
                       tl.KVCache.init(TLIN, 2, qtype, device="cpu"))
    for got, want in zip(ring, lin):
        _assert_logits_close(got, want, nmse=None)


def test_ring_buffer_is_r_slots_and_chunks_are_bounded(models):
    """O(window) memory: exactly R slots (no write margin), whatever
    max_seq is; a call longer than ring_chunk and a K5 chunk that would
    overrun the ring raise."""
    _, qt = models
    assert TRING.ring_capacity == R
    assert tl.LlamaConfig(window=4096, ring=True).ring_capacity == 4608
    c = tl.KVCache.init(TRING, 2, "q8", device="cpu")
    assert c.k.shape == (2, 2, 2, R, 32) and c.ks.shape == c.k.shape[:-1]
    with pytest.raises(ValueError):
        tl.forward(qt, TRING, torch.zeros(1, 65, dtype=torch.long),
                   tl.KVCache.init(TRING, 1, device="cpu"))
    q = torch.zeros(1, 2, 2 * 96, 64)
    k = torch.zeros(1, 2, R, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # window 48 + T 96 > R
        flash_prefill_plain(q, k, k, torch.zeros(1, dtype=torch.int32),
                            rep=2, window=W, ring=R)


def _random_cache(qtype, pos, seed=4):
    """A JAX linear cache holding random rows below each slot's pos."""
    rng = np.random.default_rng(seed)
    cfg = JRING._replace(ring=False, max_seq=64)
    cj = jl.KVCache.init(cfg, len(pos), qtype)
    held = (np.arange(64)[None, :] < np.asarray(pos)[:, None])[None, :, None]
    if qtype == "bf16":
        kv = [jnp.asarray(np.where(held[..., None], rng.standard_normal(
            cj.k.shape), 0), jnp.bfloat16) for _ in range(2)]
        return cfg, jl.KVCache(*kv, jnp.asarray(pos, jnp.int32))
    codes = [jnp.asarray(np.where(held[..., None], rng.integers(
        -127, 128, cj.k.shape), 0), jnp.int8) for _ in range(2)]
    scales = [jnp.asarray(np.where(held, rng.uniform(0.01, 0.05, cj.ks.shape),
                                   0), jnp.float32) for _ in range(2)]
    return cfg, jl.KVCache(*codes, jnp.asarray(pos, jnp.int32), *scales)


@pytest.mark.parametrize("qtype", ["bf16", "q8"])
def test_shift_context_matches_jax(qtype):
    """Slots at pos 63 and 40 with trigger 0 and keep 16 (delta 47 and 24),
    one at 10 (delta 0; the q8 keys requantized as JAX does): bit-equal to
    JAX's ``shift_context``."""
    cfg, cj = _random_cache(qtype, [63, 40, 10])
    ct = convert.cache_from_jax(jax.tree_util.tree_map(np.asarray, cj),
                                device="cpu")
    tcfg = tl.LlamaConfig(**cfg._asdict())
    want = jl.shift_context(cj, cfg, 16, trigger=0)
    got = tl.shift_context(ct, tcfg, 16, trigger=0)
    want = convert.cache_from_jax(jax.tree_util.tree_map(np.asarray, want),
                                  device="cpu")
    assert got.pos.tolist() == want.pos.tolist() == [16, 16, 10]
    for name in ("k", "v", "ks", "vs"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), name


def test_shift_context_noop_below_trigger():
    """At the default trigger (max_seq - 1) a slot below it keeps its
    bf16 cache bit for bit, and a ring cache refuses to shift."""
    cfg, cj = _random_cache("bf16", [30, 63])
    ct = convert.cache_from_jax(jax.tree_util.tree_map(np.asarray, cj),
                                device="cpu")
    before = ct.clone()
    tl.shift_context(ct, tl.LlamaConfig(**cfg._asdict()), 8)
    assert ct.pos.tolist() == [30, 8]
    assert torch.equal(ct.k[:, 0], before.k[:, 0])
    assert torch.equal(ct.v[:, 0], before.v[:, 0])
    assert torch.equal(ct.v[:, 1, :, :8], before.v[:, 1, :, 55:63])
    with pytest.raises(ValueError):
        tl.shift_context(tl.KVCache.init(TRING, 1, device="cpu"), TRING, 8)


def _logits_along(qt, cfg, prompt, toks, chunk, shift_keep=0):
    """The port's next-token logits at every step of the greedy
    transcript ``toks`` of ``prompt``, one request alone through
    :func:`forward`; with ``shift_keep``, shifted as the Server shifts
    (at pos ``max_seq - 1``, before the step)."""
    cache = tl.KVCache.init(cfg, 1, device="cpu")
    for off in range(0, len(prompt), chunk):
        logits, cache = tl.forward(qt, cfg, torch.tensor(
            [prompt[off:off + chunk]]), cache)
    steps = [logits[0, -1]]
    for tok in toks[:-1]:
        if shift_keep and int(cache.pos[0]) >= cfg.max_seq - 1:
            tl.shift_context(cache, cfg, shift_keep)
        logits, cache = tl.forward(qt, cfg, torch.tensor([[tok]]), cache)
        steps.append(logits[0, -1])
    return torch.stack(steps)


def _assert_near_tie_rule(along, toks, own):
    """``toks`` (JAX's transcript) picks the port's argmax of ``along`` at
    every step, or a token within twice the logit tolerance of it; where
    it picks the argmax everywhere, it equals the port's own ``own``."""
    n = len(toks)
    picked = along[torch.arange(n), torch.tensor(toks)]
    slack = along.amax(-1) - picked
    assert (slack <= 2 * LOGIT_TOL * along.abs().amax(-1)).all()
    if not slack.any():
        assert own == toks


def test_ring_server_matches_jax_server(models):
    """Two interleaved greedy requests on the ring at the Server's
    defaults: chunk 128 clamped to 64 (ring_chunk, a bucket multiple),
    prompt caching off; a 150-token prompt (64 + 64 + 22, padded to 32)
    wraps the ring in prefill and a 30-token one crosses it decoding."""
    qj, qt = models
    rng = np.random.default_rng(5)
    prompts = [[int(x) for x in rng.integers(0, 64, n)] for n in (150, 30)]
    news = (8, 100)
    srv_j = js.Server(qj, JRING, n_slots=2)
    srv_t = ts.Server(qt, TRING, n_slots=2, device="cpu")
    assert (srv_t.max_chunk, srv_t.cache_prompt) == (srv_j.max_chunk,
                                                     srv_j.cache_prompt) \
        == (64, False)
    for srv in (srv_j, srv_t):
        for p, n in zip(prompts, news):
            srv.submit(p, max_new=n)
    out_j, out_t = srv_j.run_until_done(), srv_t.run_until_done()
    assert srv_t.stats()["cached_prompt_tokens"] == 0
    for rid, (p, n) in enumerate(zip(prompts, news)):
        assert len(out_t[rid]) == len(out_j[rid]) == n
        along = _logits_along(qt, TRING, p, out_j[rid], 64)
        _assert_near_tie_rule(along, out_j[rid], out_t[rid])


SHIFT_CFG = dict(vocab=64, dim=128, n_layers=1, n_heads=2, n_kv_heads=2,
                 d_ff=256, max_seq=32, window=8)


def test_context_shift_server_matches_jax():
    """``context_shift=True`` generates 40 tokens past a 32-token cache
    (tests/test_serve.py's case), shifting to the window's 8 tokens each
    time a slot reaches max_seq - 1; without it both servers stop at the
    cache's end."""
    jcfg = jl.LlamaConfig(**SHIFT_CFG)
    tcfg = tl.LlamaConfig(**SHIFT_CFG)
    params = jl.init_params(jcfg, seed=30)
    qj = jl.quantize_params(params)
    qt = tl.quantize_params(params, device="cpu")
    prompt = [5, 9, 3, 7]
    runs = {}
    for shift in (True, False):
        srv_j = js.Server(qj, jcfg, n_slots=1, context_shift=shift)
        srv_t = ts.Server(qt, tcfg, n_slots=1, context_shift=shift,
                          device="cpu")
        rids = [srv.submit(prompt, max_new=40) for srv in (srv_j, srv_t)]
        runs[shift] = [srv.run_until_done()[rid]
                       for srv, rid in zip((srv_j, srv_t), rids)]
    (tj, tt), (sj, st) = runs[True], runs[False]
    assert len(tj) == len(tt) == 40
    assert len(sj) == len(st) < 40
    along = _logits_along(qt, tcfg, prompt, tj, 16, shift_keep=8)
    _assert_near_tie_rule(along, tj, tt)
    assert tt[:len(st) - 1] == st[:len(st) - 1]


def test_ring_with_context_shift_or_without_window_is_rejected(models):
    _, qt = models
    with pytest.raises(ValueError):
        ts.Server(qt, TRING, context_shift=True, device="cpu")
    with pytest.raises(ValueError):
        ts.Server(qt, TRING._replace(window=0), device="cpu")
    with pytest.raises(ValueError):
        tl.KVCache.init(TRING._replace(window=0), 1, device="cpu")
