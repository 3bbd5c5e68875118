"""What the Server's captured steps rest on, held to the JAX package on
the CPU (CUDA graphs themselves run only on the card:
``tests/test_torch_cuda.py``), at a small Llama (2 layers, dim 128).

* ``forward`` and ``shift_context`` write ``cache.pos`` in place (the
  same storage) with JAX's values;
* the Server's prefill through the one-slot staging cache (the slot
  copied in where a prefix is reused, the chunks run, copied back) gives
  the cache and logits of chunks run straight on a view of the slot bit
  for bit, with and without prefix reuse and over a staging cache an
  earlier prompt left rows in, bf16 and q8; against JAX's
  ``Server._prefill`` the logits within ``max|delta| <= 2e-2 *
  max|logits|`` and NMSE <= 2e-4, the rows written exactly where JAX
  writes them and their (dequantized) values within that NMSE (the
  Q8_1 tie flips of ``tests/test_torch_model.py``);
* the Server with its static token buffer and staging cache against the
  JAX Server: greedy transcripts under the near-tie rule (JAX's token is
  the port's argmax along its transcript, or within twice the logit
  tolerance of it) on the linear cache with prefix reuse, the ring and
  context shift;
* :func:`serve.graph_key` separates the three decode ``s_hi`` and every
  module setting that chooses the route; on the CPU the Server captures nothing and
  decides its routes once per key;
* the activation quantizers: ``registry.dispatch`` on CPU tensors takes
  the torch twins (the launches do not move), and the wrappers' plain
  versions equal JAX's quantizer bit for bit, also at .5 ties, on
  all-zero blocks and where the f16 scale saturates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_gemm_tpu.formats import jax_quant as jq
from quant_gemm_tpu.models import llama as jl
from quant_gemm_tpu.models import serve as js
from quant_gemm_tpu_torch.kernels import act_quant, gemm_megalayer, registry
from quant_gemm_tpu_torch.models import convert
from quant_gemm_tpu_torch.models import llama as tl
from quant_gemm_tpu_torch.models import serve as ts
from quant_gemm_tpu_torch.ops.attention import decode_s_hi
from quant_gemm_tpu_torch.utils import round_up

LOGIT_TOL = 2e-2
NMSE_TOL = 2e-4
BASE = dict(vocab=64, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=256)
JLIN = jl.LlamaConfig(max_seq=128, **BASE)
TLIN = tl.LlamaConfig(**JLIN._asdict())
JRING = jl.LlamaConfig(max_seq=512, window=48, ring=True, ring_chunk=64,
                       **BASE)
TRING = tl.LlamaConfig(**JRING._asdict())


@pytest.fixture(scope="module")
def models():
    params = jl.init_params(JLIN, seed=7)
    return jl.quantize_params(params), tl.quantize_params(params,
                                                          device="cpu")


def _assert_logits_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    assert ((got - want) ** 2).sum() <= NMSE_TOL * (want ** 2).sum()


# -- cache.pos in place ------------------------------------------------------


@pytest.mark.parametrize("qtype", ["bf16", "q8"])
def test_forward_keeps_pos_storage(models, qtype):
    """A prefill chunk and two decode steps: the cache comes back as the
    same object, ``pos`` in the same storage, holding JAX's values."""
    qj, qt = models
    toks = np.random.default_rng(1).integers(0, 64, (2, 18)).astype(np.int32)
    cj = jl.KVCache.init(JLIN, 2, qtype)
    ct = tl.KVCache.init(TLIN, 2, qtype, device="cpu")
    ptr = ct.pos.data_ptr()
    for t in (toks[:, :16], toks[:, 16:17], toks[:, 17:]):
        _, cj = jl.jit_forward(qj, JLIN, jnp.asarray(t), cj)
        _, got = tl.forward(qt, TLIN, torch.from_numpy(t), ct)
        assert got is ct and ct.pos.data_ptr() == ptr
        assert ct.pos.dtype == torch.int32
        assert ct.pos.tolist() == np.asarray(cj.pos).tolist()
    assert ct.pos.tolist() == [18, 18]


@pytest.mark.parametrize("qtype", ["bf16", "q8"])
def test_shift_context_keeps_pos_storage(qtype):
    """Slots at 63, 40 and 10 shifted to keep 16 with trigger 0, then at
    the default trigger: ``pos`` keeps its storage and takes JAX's
    values."""
    cfg = jl.LlamaConfig(max_seq=64, **BASE)
    tcfg = tl.LlamaConfig(**cfg._asdict())
    cj = jl.KVCache.init(cfg, 3, qtype)._replace(
        pos=jnp.asarray([63, 40, 10], jnp.int32))
    ct = convert.cache_from_jax(jax.tree_util.tree_map(np.asarray, cj),
                                device="cpu")
    ptr = ct.pos.data_ptr()
    for trigger, keep in ((0, 16), (None, 8)):
        cj = jl.shift_context(cj, cfg, keep, trigger=trigger)
        got = tl.shift_context(ct, tcfg, keep, trigger=trigger)
        assert got is ct and ct.pos.data_ptr() == ptr
        assert ct.pos.tolist() == np.asarray(cj.pos).tolist()
    assert ct.pos.tolist() == [16, 16, 10]


# -- prefill through the staging cache ---------------------------------------


def _rows(k, scale=None):
    """float32 values of cache rows (codes times scales for q8)."""
    x = np.asarray(k, np.float32)
    return x if scale is None else x * np.asarray(scale)[..., None]


def _view_prefill(srv, slot, prompt, start):
    """``prompt[start:]`` prefilled as ``srv`` chunks it, straight on a
    view of the slot in ``srv.cache`` (no staging cache), the head on the
    rows the Server reads (none of a middle chunk, the last real token of
    the last); returns the last prompt position's logits."""
    c, one = srv.cache, slice(slot, slot + 1)
    view = tl.KVCache(
        c.k[:, one], c.v[:, one], torch.full((1,), start, dtype=torch.int32),
        *((c.ks[:, one], c.vs[:, one]) if c.quantized else ()))
    off = start
    while off < len(prompt):
        part = prompt[off: off + srv.max_chunk]
        t = max(srv.bucket, round_up(len(part), srv.bucket))
        padded = torch.zeros(1, t, dtype=torch.int64)
        padded[0, : len(part)] = torch.tensor(part)
        rows = (torch.tensor([[len(part) - 1]])
                if off + len(part) == len(prompt)
                else torch.zeros(1, 0, dtype=torch.int64))
        logits, _ = tl.forward(srv.qparams, srv.cfg, padded, view,
                               rope_cache=srv._rope, out_rows=rows)
        last = logits[0, -1] if rows.numel() else None
        view.pos.fill_(off + len(part))
        off += len(part)
    c.pos[slot] = len(prompt)
    return last


@pytest.mark.parametrize("qtype", ["bf16", "q8"])
def test_staged_prefill_equals_the_view_path_and_jax(models, qtype):
    """A 48-token prompt into slot 1 (chunks of 32 + 16), then a second
    prompt sharing its first 32 tokens, prefilled from position 32 on
    the reused rows, then a 20-token prompt into slot 0 from position 0
    (the staging cache still holding the second prompt's rows, past its
    ``pos``): the Server's staged prefill and chunks run straight on a
    view of the slot give the same logits bit for bit, the same whole
    cache after the first two and the same rows below ``pos`` after the
    third; JAX's ``_prefill`` (a fresh one-slot cache, then the
    extracted slot) within the stated tolerance."""
    qj, qt = models
    rng = np.random.default_rng(2)
    a = rng.integers(0, 64, 48).tolist()
    b = a[:32] + rng.integers(0, 64, 16).tolist()
    c = rng.integers(0, 64, 20).tolist()
    kw = dict(n_slots=2, max_prefill_chunk=32, cache_qtype=qtype,
              device="cpu")
    staged, viewed = ts.Server(qt, TLIN, **kw), ts.Server(qt, TLIN, **kw)
    s1, s2 = staged._prefill(1, a, 0), staged._prefill(1, b, 32)
    v1, v2 = _view_prefill(viewed, 1, a, 0), _view_prefill(viewed, 1, b, 32)
    cs, cv = staged.cache, viewed.cache
    assert torch.equal(v1, s1) and torch.equal(v2, s2)
    for x, y in zip(cv.buffers(), cs.buffers()):
        assert torch.equal(x, y)
    assert cv.pos.tolist() == cs.pos.tolist() == [0, 48]
    assert torch.equal(_view_prefill(viewed, 0, c, 0),
                       staged._prefill(0, c, 0))
    for x, y in zip(cv.buffers(), cs.buffers()):
        assert torch.equal(x[:, 0, :, :20], y[:, 0, :, :20])
    assert cv.pos.tolist() == cs.pos.tolist() == [20, 48]

    srv_j = js.Server(qj, JLIN, n_slots=2, max_prefill_chunk=32,
                      cache_qtype=qtype)
    k, v, (ks, vs), lj = srv_j._prefill(a)
    _assert_logits_close(s1.numpy(), lj)
    c1 = jl.KVCache(k[:, None], v[:, None], jnp.zeros((1,), jnp.int32),
                    *((ks[:, None], vs[:, None]) if ks is not None else ()))
    k, v, (ks, vs), lj = srv_j._prefill(b, c1, 32)
    _assert_logits_close(s2.numpy(), lj)
    q8 = cs.quantized
    for want, got, wsc, gsc in ((k, cs.k, ks, cs.ks), (v, cs.v, vs, cs.vs)):
        w = _rows(want, wsc if q8 else None)[:, :, :48]
        g = _rows(got[:, 1].float(), gsc[:, 1] if q8 else None)[:, :, :48]
        np.testing.assert_array_equal((w != 0).any(-1), (g != 0).any(-1))
        assert ((w - g) ** 2).sum() <= NMSE_TOL * (w ** 2).sum()


# -- the Server against the JAX Server ---------------------------------------


def _logits_along(qt, cfg, prompt, toks, chunk, shift_keep=0):
    """The port's next-token logits at every step of the greedy
    transcript ``toks`` of ``prompt``, one request alone through
    ``forward``; with ``shift_keep``, shifted as the Server shifts."""
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
    n = len(toks)
    picked = along[torch.arange(n), torch.tensor(toks)]
    slack = along.amax(-1) - picked
    assert (slack <= 2 * LOGIT_TOL * along.abs().amax(-1)).all()
    if not slack.any():
        assert own == toks


SHIFT = dict(vocab=64, dim=128, n_layers=1, n_heads=2, n_kv_heads=2,
             d_ff=256, max_seq=32, window=8)


@pytest.mark.parametrize("case", ["linear", "ring", "shift"])
def test_staged_server_matches_jax_server(models, case):
    """The Server with its static token buffer and staging cache
    against the JAX Server, greedy: linear, two
    interleaved requests and a third reusing the first one's leading 32
    tokens; the ring at its defaults (chunk clamped to 64), a 150-token
    prompt wrapping it in prefill and a 30-token one crossing it
    decoding; ``context_shift`` past a 32-token cache."""
    qj, qt = models
    rng = np.random.default_rng(9)
    if case == "linear":
        jcfg, tcfg, chunk, kw = JLIN, TLIN, 32, dict(max_prefill_chunk=32)
        a = rng.integers(0, 64, 48).tolist()
        prompts = [a, rng.integers(0, 64, 20).tolist(),
                   a[:32] + rng.integers(0, 64, 16).tolist()]
        news = (5, 9, 4)
    elif case == "ring":
        jcfg, tcfg, chunk, kw = JRING, TRING, 64, {}
        prompts = [rng.integers(0, 64, n).tolist() for n in (150, 30)]
        news = (6, 90)
    else:
        jcfg, tcfg = jl.LlamaConfig(**SHIFT), tl.LlamaConfig(**SHIFT)
        params = jl.init_params(jcfg, seed=30)
        qj, qt = jl.quantize_params(params), tl.quantize_params(
            params, device="cpu")
        chunk, kw = 16, dict(context_shift=True)
        prompts, news = [[5, 9, 3, 7]], (40,)
    srv_j = js.Server(qj, jcfg, n_slots=2, **kw)
    srv_t = ts.Server(qt, tcfg, n_slots=2, device="cpu", **kw)
    for srv in (srv_j, srv_t):
        for p, n in zip(prompts, news):
            srv.submit(p, max_new=n)
    out_j, out_t = srv_j.run_until_done(), srv_t.run_until_done()
    reused = srv_t.stats()["cached_prompt_tokens"]
    assert reused == srv_j._n_cached_tokens
    assert (reused >= 32) if case == "linear" else reused == 0
    assert srv_t.graphs == {}
    for rid, (p, n) in enumerate(zip(prompts, news)):
        assert len(out_t[rid]) == len(out_j[rid]) == n
        along = _logits_along(qt, tcfg, p, out_j[rid], chunk,
                              shift_keep=8 if case == "shift" else 0)
        _assert_near_tie_rule(along, out_j[rid], out_t[rid])


# -- graph keys and routes ---------------------------------------------------


def test_graph_key_follows_s_hi_and_the_route_switches(monkeypatch):
    decode = [ts.graph_key("decode", decode_s_hi(n)) for n in (48, 300, 900)]
    assert [k[1] for k in decode] == [256, 512, None]
    assert len(set(decode)) == 3
    base = decode[0]
    monkeypatch.setattr(registry, "FUSED_DECODE", True)
    fused = ts.graph_key("decode", 256)
    monkeypatch.setattr(gemm_megalayer, "ENABLE_TAIL", True)
    tail = ts.graph_key("decode", 256)
    monkeypatch.setattr(registry, "FUSED_DECODE", False)
    tail_only = ts.graph_key("decode", 256)
    monkeypatch.setattr(gemm_megalayer, "ENABLE_TAIL", False)
    monkeypatch.setattr(registry, "DECODE_M_MAX", 8)
    m_max = ts.graph_key("decode", 256)
    monkeypatch.setattr(tl, "FLASH_PREFILL_T_MIN", 128)
    t_min = ts.graph_key("decode", 256)
    keys = (base, fused, tail, tail_only, m_max, t_min)
    assert len(set(keys)) == 6
    assert ts.graph_key("chunk", 256) != t_min
    for key in keys:
        assert all(type(x) in (str, int, bool, type(None)) for x in key)
        assert hash(key) == hash(tuple(key))


def test_cpu_server_is_eager_and_decides_routes_once(models, monkeypatch):
    """On the CPU the Server captures nothing, even with CUDA_GRAPHS on,
    and walks the layers' K2/K8 rules once per key, not per step."""
    _, qt = models
    calls = []
    routes = tl.routes
    monkeypatch.setattr(tl, "routes", lambda *a, **kw: calls.append(a[2:])
                        or routes(*a, **kw))
    assert ts.CUDA_GRAPHS
    srv = ts.Server(qt, TLIN, n_slots=2, device="cpu")
    srv.submit(list(range(1, 40)), max_new=6)
    srv.submit(list(range(3, 30)), max_new=5)
    srv.run_until_done()
    st = srv.stats()
    assert srv.graphs == {} and st["graphs"] == st["graph_replays"] == 0
    assert srv.replay_launches() == {}
    assert st["decode_steps"] >= 5
    # one decode key (s_hi 256) and the two chunk lengths (48, 32)
    assert sorted(calls) == [(1, 32), (1, 48), (2, 1)]


# -- the activation quantizers -----------------------------------------------


def _edge_rows(m, k, seed):
    """float32 [m, k]: normal rows, with per row one all-zero block, one
    block of .5 ties (amax 127, so d = 1 and the codes land on halves)
    and one whose amax / 127 saturates f16 (and its sum with it)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    nb = k // 32
    for r in range(m):
        b0, b1, b2 = (3 * r) % nb, (3 * r + 1) % nb, (3 * r + 2) % nb
        x[r, 32 * b0:32 * b0 + 32] = 0.0
        ties = rng.integers(-120, 120, 32) + 0.5
        ties[rng.integers(0, 32)] = 127.0
        x[r, 32 * b1:32 * b1 + 32] = ties
        x[r, 32 * b2:32 * b2 + 32] = np.abs(rng.standard_normal(32)) * 1e7
    return x


@pytest.mark.parametrize("m, k", [(1, 2048), (8, 4096), (13, 1056)])
def test_act_quant_plain_versions_bit_equal_to_jax(m, k):
    x = _edge_rows(m, k, seed=m)
    got = act_quant.quantize_q8_1(torch.from_numpy(x))
    want = jq.quantize_q8_1(jnp.asarray(x))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.isinf(np.asarray(want.s, np.float32)).sum() == 0
    assert (np.asarray(want.d, np.float32) == 65504.0).any()
    fold = (np.asarray(want.qs, np.float32)
            * np.repeat(np.asarray(want.d, np.float32), 32, axis=-1))
    assert torch.equal(act_quant.quantize_fold_q8_1(torch.from_numpy(x)),
                       torch.from_numpy(fold).to(torch.bfloat16))


@pytest.mark.parametrize("m, qtype", [(8, "q4_0"), (48, "q4_0"),
                                      (8, "q6_k")])
def test_dispatch_on_cpu_tensors_takes_the_twins(monkeypatch, m, qtype):
    """Decode (K1, K7 routes) and prefill (K4 route) quantize through the
    twin ``registry.quantize_q8_1`` on CPU tensors, once per GEMM, and
    the launch counters stay put; the result equals ``ops=PLAIN``'s."""
    rng = np.random.default_rng(m)
    w = tl._preparer(qtype, torch.device("cpu"))(
        (rng.standard_normal((96, 256)) / 16).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((m, 256)).astype(np.float32))
    calls, twin = [], registry.quantize_q8_1
    monkeypatch.setattr(registry, "quantize_q8_1",
                        lambda a: calls.append(tuple(a.shape)) or twin(a))
    before = registry.counters()
    got = registry.dispatch(w, x, quantize_act=True)
    moved = {k: v - before[k] for k, v in registry.counters().items()
             if v != before[k]}
    assert calls == [(m, 256)]
    assert moved == {}
    assert torch.equal(got, registry.dispatch(w, x, quantize_act=True,
                                              ops=registry.PLAIN))
