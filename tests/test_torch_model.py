"""The port's model, weight converter and server against the JAX package,
on the CPU, at a small Llama where the JAX decode path takes its norm_qkv
megakernel (dim 512) and GQA (8 heads over 2 kv heads).

Tolerances:

* ``qparams_from_jax``: bit-equal to quantizing the same float weights in
  the port (both are exact integer / f16 results); JAX's q4_k and q6_k
  weights carried across serve the same logits as JAX's forward, within
  the free-run bounds below;
* logits with JAX's Q8_1 activation codes fed to the port (every
  quantizer call of the JAX forward recorded and replayed): ``max|delta|
  <= 1e-5 * max|logits|`` — only the float32 summation order differs;
* logits, each side quantizing its own activations: ``max|delta| <= 2e-2
  * max|logits|`` and NMSE <= 2e-4.  XLA's CPU reductions and element ops
  differ from PyTorch's in the last float32 bit, which moves up to three
  Q8_1 codes per quantizer call across a .5 rounding tie (each by one;
  ``test_forward_with_jax_codes_matches_jax`` counts them), and such a
  code moves the logits by up to about 1e-2 * max|logits| on this model.
  Over 30 prefill and decode cases (``python tests/torch_jax_gap.py``), 6
  measured below 2e-7 * max|logits| and 24 from 8.9e-4 to 1.42e-2, NMSE
  up to 1.29e-4;
* greedy transcripts: the port's server equals its own solo decode of each
  request exactly, and at every step of the JAX server's transcript the
  token JAX picked is the port's argmax, or within twice the logit
  tolerance of it (a near-tie either side may break its own way); a
  server that reused a cached prompt prefix is held to its cold run by
  the same rule;
* ``_quant_kv`` (the q8 cache's codes and scales): bit-equal to JAX's;
* the q8 cache after a forward from the same cache: the dequantized
  values ``k * ks`` within ``NMSE_TOL``, the rows written exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_gemm_tpu.formats import jax_quant as jq
from quant_gemm_tpu.models import llama as jl
from quant_gemm_tpu.models import serve as js
from quant_gemm_tpu_torch.formats.blocks import Q8_1Tensor
from quant_gemm_tpu_torch.kernels import layout, registry
from quant_gemm_tpu_torch.models import convert
from quant_gemm_tpu_torch.models import llama as tl
from quant_gemm_tpu_torch.models import serve as ts

JCFG = jl.LlamaConfig(vocab=256, dim=512, n_layers=2, n_heads=8,
                      n_kv_heads=2, d_ff=1024, max_seq=128)
TCFG = tl.LlamaConfig(**JCFG._asdict())
LOGIT_TOL = 2e-2
NMSE_TOL = 2e-4


@pytest.fixture(scope="module")
def models():
    params = jl.init_params(JCFG, seed=3)
    qj = jl.quantize_params(params)
    qt = tl.quantize_params(params, device="cpu")
    return params, qj, qt


def _assert_logits_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    assert ((got - want) ** 2).sum() <= NMSE_TOL * (want ** 2).sum()


def test_init_params_same_floats_as_jax():
    a, b = jl.init_params(JCFG, seed=5), tl.init_params(TCFG, seed=5)
    np.testing.assert_array_equal(a["lm_head"], b["lm_head"])
    np.testing.assert_array_equal(a["layers"][1]["w_down"],
                                  b["layers"][1]["w_down"])


def test_qparams_from_jax_bit_equal(models):
    _, qj, qt = models
    qc = convert.qparams_from_jax(jax.tree_util.tree_map(np.asarray, qj),
                                  device="cpu")
    for key in ("embed", "final_norm"):
        assert torch.equal(qc[key], qt[key])
    pairs = [(qc["lm_head"], qt["lm_head"])]
    for lc, lt in zip(qc["layers"], qt["layers"]):
        for name in ("attn_norm", "mlp_norm"):
            assert torch.equal(lc[name], lt[name])
        pairs += [(lc[n], lt[n]) for n in ("wqkv", "wo", "wgu", "w_down")]
    for a, b in pairs:
        assert (a.n, a.k) == (b.n, b.k)
        assert torch.equal(a.qs, b.qs) and torch.equal(a.d, b.d)


@pytest.mark.parametrize("qtype", ["q4_k", "q6_k"])
def test_qparams_from_jax_kquants_match_jax_forward(models, qtype):
    """JAX's K-quant weights (q4_k: effective q4_1 planes through K1/K4;
    q6_k: per-16 weights through K7 and, at prefill, the plain float32
    matmul) carried across: a 16-token prefill and a decode step."""
    params, _, _ = models
    qj = jl.quantize_params(params, qtype)
    qc = convert.qparams_from_jax(jax.tree_util.tree_map(np.asarray, qj),
                                  device="cpu")
    kind = layout.PreparedK16 if qtype == "q6_k" else layout.PreparedWeight
    assert all(isinstance(ly[n], kind) and ly[n].qtype == qtype
               for ly in qc["layers"] for n in ("wqkv", "wo", "wgu",
                                                "w_down"))
    rng = np.random.default_rng(20)
    tokens = rng.integers(0, 256, (2, 16)).astype(np.int32)
    lj, cj = jl.jit_forward(qj, JCFG, jnp.asarray(tokens),
                            jl.KVCache.init(JCFG, 2))
    lt, ct = tl.forward(qc, TCFG, torch.from_numpy(tokens),
                        tl.KVCache.init(TCFG, 2, device="cpu"))
    _assert_logits_close(lt, lj)
    nt = rng.integers(0, 256, (2, 1)).astype(np.int32)
    lj, _ = jl.jit_forward(qj, JCFG, jnp.asarray(nt), cj)
    lt, _ = tl.forward(qc, TCFG, torch.from_numpy(nt), ct)
    _assert_logits_close(lt, lj)


def _prefill_both(models, tokens):
    _, qj, qt = models
    b = tokens.shape[0]
    lj, cj = jl.jit_forward(qj, JCFG, jnp.asarray(tokens),
                            jl.KVCache.init(JCFG, b))
    lt, ct = tl.forward(qt, TCFG, torch.from_numpy(tokens),
                        tl.KVCache.init(TCFG, b, device="cpu"))
    return lj, cj, lt, ct


def _assert_cache_equal(cj, ct):
    """The same cache rows written (exactly), holding the same values up
    to the logit tolerance's NMSE (k/v inherit the Q8_1 tie flips)."""
    np.testing.assert_array_equal(np.asarray(cj.pos), ct.pos.numpy())
    for a, b in ((cj.k, ct.k), (cj.v, ct.v)):
        a, b = np.asarray(a, np.float32), b.float().numpy()
        np.testing.assert_array_equal((a != 0).any(-1), (b != 0).any(-1))
        assert ((a - b) ** 2).sum() <= NMSE_TOL * (a ** 2).sum()


@pytest.mark.parametrize("t", [16, 48, 64, 128])
def test_forward_prefill_matches_jax(models, t):
    """T >= 64 takes K5 (flash prefill) in both."""
    tokens = np.random.default_rng(t).integers(0, 256, (2, t)).astype(np.int32)
    lj, cj, lt, ct = _prefill_both(models, tokens)
    assert lt.shape == (2, t, JCFG.vocab)
    _assert_logits_close(lt, lj)
    _assert_cache_equal(cj, ct)


@pytest.mark.parametrize("t", [16, 48, 128])
def test_forward_with_jax_codes_matches_jax(models, monkeypatch, t):
    """The gap of the test above is Q8_1 tie flips: with every activation
    quantized as JAX quantized it, the logits agree to float32 summation
    order, and the port's own codes of those same inputs differ from
    JAX's by at most one, in a few places (about ten per 96 activation
    rows)."""
    _, qj, qt = models
    tokens = np.random.default_rng(t).integers(0, 256, (2, t)).astype(np.int32)
    recorded = []
    quantize_j = jq.quantize_q8_1

    def record(x):
        recorded.append(quantize_j(x))
        return recorded[-1]

    monkeypatch.setattr(jq, "quantize_q8_1", record)
    # eager, so that every quantizer call hands its arrays to the recorder
    lj, _ = jl.forward(qj, JCFG, jnp.asarray(tokens), jl.KVCache.init(JCFG, 2))
    monkeypatch.undo()
    assert len(recorded) == 4 * JCFG.n_layers + 1
    replay, flips = iter(recorded), []
    quantize_t = registry.quantize_q8_1

    def jax_codes(x):
        want = Q8_1Tensor(*(torch.from_numpy(np.array(a))
                            for a in next(replay)))
        own = quantize_t(x)
        flips.append((own.qs.int() - want.qs.int()).abs())
        return want

    monkeypatch.setattr(registry, "quantize_q8_1", jax_codes)
    lt, _ = tl.forward(qt, TCFG, torch.from_numpy(tokens),
                       tl.KVCache.init(TCFG, 2, device="cpu"))
    assert len(flips) == len(recorded)
    lt, lj = lt.numpy(), np.asarray(lj)
    assert np.abs(lt - lj).max() <= 1e-5 * np.abs(lj).max()
    assert max(int(f.max()) for f in flips) <= 1
    assert sum(int(f.sum()) for f in flips) <= 10 * max(t, 48) // 48


def test_forward_decode_matches_jax(models):
    """Two batched decode steps, one slot moved back to position 30 and
    one past the cache end: its write clamps to the last row, as JAX's
    does."""
    _, qj, qt = models
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (2, 48)).astype(np.int32)
    _, cj, _, ct = _prefill_both(models, tokens)
    pos = np.array([30, JCFG.max_seq + 3], np.int32)
    cj = cj._replace(pos=jnp.asarray(pos))
    ct.pos = torch.from_numpy(pos)
    for step in range(2):
        nt = rng.integers(0, 256, (2, 1)).astype(np.int32)
        dj, cj = jl.jit_forward(qj, JCFG, jnp.asarray(nt), cj)
        dt, ct = tl.forward(qt, TCFG, torch.from_numpy(nt), ct)
        # the overflowing slot (1) attends garbage in both: compare slot 0
        _assert_logits_close(dt[:1], np.asarray(dj)[:1])
        _assert_cache_equal(cj, ct)


def _logits_along(qt, prompt, toks, chunk=48, cfg=TCFG, qtype="bf16"):
    """The port's next-token logits [len(toks), vocab] at every step of a
    greedy transcript ``toks`` of ``prompt``, one request alone through
    :func:`forward` (``chunk``-token prefill chunks, then one decode step
    per token)."""
    cache = tl.KVCache.init(cfg, 1, qtype, device="cpu")
    for off in range(0, len(prompt), chunk):
        part = prompt[off:off + chunk]
        logits, cache = tl.forward(qt, cfg, torch.tensor([part]), cache)
    steps = [logits[0, -1]]
    for tok in toks[:-1]:
        logits, cache = tl.forward(qt, cfg, torch.tensor([[tok]]), cache)
        steps.append(logits[0, -1])
    return torch.stack(steps)


def _assert_near_tie_rule(along, toks, own):
    """``toks`` (another run's greedy transcript) picks the port's argmax
    of ``along`` at every step, or a token within twice the logit
    tolerance of it; where it picks the argmax everywhere, it equals the
    port's own transcript ``own``."""
    n = len(toks)
    picked = along[torch.arange(n), torch.tensor(toks)]
    slack = along.amax(-1) - picked
    assert (slack <= 2 * LOGIT_TOL * along.abs().amax(-1)).all()
    if not slack.any():
        assert own == toks


def test_server_matches_jax_server(models):
    """Two interleaved greedy requests, the first (96 tokens) prefilled in
    two 48-token chunks while the second is decoding (every chunk is 48
    tokens, so JAX compiles one prefill program)."""
    _, qj, qt = models
    rng = np.random.default_rng(6)
    prompts = [[int(x) for x in rng.integers(0, 256, n)] for n in (96, 48)]
    news = (6, 9)
    srv_j = js.Server(qj, JCFG, n_slots=2, max_prefill_chunk=48,
                      prefill_bucket=16, cache_prompt=False)
    srv_t = ts.Server(qt, TCFG, n_slots=2, max_prefill_chunk=48,
                      prefill_bucket=16, cache_prompt=False, device="cpu")
    for srv in (srv_j, srv_t):
        for p, n in zip(prompts, news):
            srv.submit(p, max_new=n)
    out_j, out_t = srv_j.run_until_done(), srv_t.run_until_done()
    for rid, (p, n) in enumerate(zip(prompts, news)):
        assert len(out_t[rid]) == len(out_j[rid]) == n
        # interleaved == solo, every step
        assert _logits_along(qt, p, out_t[rid]).argmax(-1).tolist() \
            == out_t[rid]
        _assert_near_tie_rule(_logits_along(qt, p, out_j[rid]), out_j[rid],
                              out_t[rid])
    st = srv_t.stats()
    assert st["finished"] == 2 and st["prefill_tokens"] == 144
    assert st["generated_tokens"] == sum(news)


def test_server_rejects_options_outside_the_slice(models):
    _, _, qt = models
    # W4A16 prefill and decode are served (slice 15, tests/test_torch_a16.
    # py); an activation mode the JAX package has not is refused
    assert ts.Server(qt, TCFG, device="cpu",
                     prefill_a16=True).prefill_mode == "bf16"
    with pytest.raises(ValueError, match="act_mode"):
        ts.Server(qt, TCFG, device="cpu", act_mode="q4_0")
    # a ring needs a window, and does not shift its context
    with pytest.raises(ValueError):
        ts.Server(qt, TCFG._replace(ring=True), device="cpu")
    with pytest.raises(ValueError):
        ts.Server(qt, TCFG._replace(window=16, ring=True), device="cpu",
                  context_shift=True)
    assert ts.Server(qt, TCFG, device="cpu", act_mode="bf16").act_mode \
        == "bf16"
    # grammar and n_probs are served (slice 14, tests/test_torch_grammar.
    # py); a request still needs a prompt and a token to make
    srv = ts.Server(qt, TCFG, n_slots=1, device="cpu")
    with pytest.raises(ValueError):
        srv.submit([], n_probs=3)
    with pytest.raises(ValueError):
        srv.submit([1, 2], max_new=0, n_probs=3)


def test_seeded_sampling_is_per_request(models):
    """A sampled request's tokens depend on its own seed only, not on
    what shares the batch."""
    _, _, qt = models
    kw = dict(max_new=5, temperature=0.8, top_k=40, top_p=0.9, seed=7)

    def run(extra):
        srv = ts.Server(qt, TCFG, n_slots=2, max_prefill_chunk=48,
                        device="cpu")
        rid = srv.submit([3, 1, 4, 1, 5], **kw)
        if extra:
            srv.submit([9, 2, 6], max_new=5, temperature=1.0, seed=99)
        return srv.run_until_done()[rid]

    alone, shared = run(False), run(True)
    assert alone == shared and len(alone) == 5
    assert all(0 <= t < TCFG.vocab for t in alone)


def test_quant_kv_bit_equal_to_jax():
    """The q8 cache's per-vector codes and scales, including an all-zero
    vector (scale 0, codes 0) and exact .5 ties."""
    x = np.random.default_rng(8).standard_normal((3, 5, 2, 64)) * 4
    x = x.astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 1, 1, :8] = np.float32(127.0) * np.arange(8) / 2  # ties at .5
    x[1, 1, 1, 8] = 127.0
    codes, scale = tl._quant_kv(torch.from_numpy(x))
    jcodes, jscale = jl._quant_kv(jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32


def _assert_q8_cache_close(cj, ct):
    """Dequantized values (codes x scale) within the NMSE tolerance, the
    same rows written (scale set) exactly."""
    np.testing.assert_array_equal(np.asarray(cj.pos), ct.pos.numpy())
    for k, s, tk, tsc in ((cj.k, cj.ks, ct.k, ct.ks),
                          (cj.v, cj.vs, ct.v, ct.vs)):
        s, tsc = np.asarray(s), tsc.numpy()
        np.testing.assert_array_equal(s != 0, tsc != 0)
        a = np.asarray(k, np.float32) * s[..., None]
        b = tk.float().numpy() * tsc[..., None]
        assert ((a - b) ** 2).sum() <= NMSE_TOL * (a ** 2).sum()


def test_forward_q8_cache_matches_jax(models):
    """q8 cache: a 64-token prefill (K5) at ragged offsets into a cache
    that already holds rows, then two decode steps, both forwards started
    from the same JAX cache carried over by ``convert.cache_from_jax``."""
    _, qj, qt = models
    rng = np.random.default_rng(9)
    pos = np.array([16, 9], np.int32)
    cj = jl.KVCache.init(JCFG, 2, "q8")
    held = np.arange(JCFG.max_seq)[None, None, None, :] < pos[None, :, None,
                                                                  None]
    codes = [np.where(held[..., None], rng.integers(-127, 128, cj.k.shape),
                      0).astype(np.int8) for _ in range(2)]
    scales = [np.where(held, rng.uniform(0.01, 0.05, cj.ks.shape),
                       0).astype(np.float32) for _ in range(2)]
    cj = jl.KVCache(*map(jnp.asarray, (*codes, pos, *scales)))
    ct = convert.cache_from_jax(jax.tree_util.tree_map(np.asarray, cj),
                                device="cpu")
    assert ct.quantized and ct.k.dtype == torch.int8
    for t in (64, 1, 1):
        toks = rng.integers(0, 256, (2, t)).astype(np.int32)
        lj, cj = jl.jit_forward(qj, JCFG, jnp.asarray(toks), cj)
        lt, ct = tl.forward(qt, TCFG, torch.from_numpy(toks), ct)
        _assert_logits_close(lt, lj)
        _assert_q8_cache_close(cj, ct)


@pytest.mark.parametrize("t", [16, 64])
def test_forward_window_matches_jax(models, t):
    """A sliding window of 24 (Mistral-style masks) in the dense path
    (T = 16), in K5 (T = 64) and in K3 (two decode steps after it)."""
    _, qj, qt = models
    jcfg, tcfg = JCFG._replace(window=24), TCFG._replace(window=24)
    rng = np.random.default_rng(10 + t)
    toks = rng.integers(0, 256, (2, t)).astype(np.int32)
    lj, cj = jl.jit_forward(qj, jcfg, jnp.asarray(toks),
                            jl.KVCache.init(jcfg, 2))
    lt, ct = tl.forward(qt, tcfg, torch.from_numpy(toks),
                        tl.KVCache.init(tcfg, 2, device="cpu"))
    _assert_logits_close(lt, lj)
    _assert_cache_equal(cj, ct)
    for _ in range(2):
        nt = rng.integers(0, 256, (2, 1)).astype(np.int32)
        dj, cj = jl.jit_forward(qj, jcfg, jnp.asarray(nt), cj)
        dt, ct = tl.forward(qt, tcfg, torch.from_numpy(nt), ct)
        _assert_logits_close(dt, dj)
        _assert_cache_equal(cj, ct)


# the servers' own defaults (bucket 16, chunk 128, prompt caching) need
# room for a 200-token prompt and its continuation
SCFG_J = JCFG._replace(max_seq=256)
SCFG_T = TCFG._replace(max_seq=256)


@pytest.mark.parametrize("qtype", ["bf16", "q8"])
def test_server_defaults_match_jax_server(models, qtype):
    """``Server(qp, cfg)`` at its defaults on both sides: a 200-token
    prompt prefilled in chunks of 128 + 72 (padded to 80; both through
    K5) interleaved with an 80-token one, then a third request sharing
    the first one's leading 128 tokens, admitted to its freed slot and
    reusing them (only two chunk shapes, 128 and 80, for JAX to
    compile)."""
    _, qj, qt = models
    rng = np.random.default_rng(12)
    a = [int(x) for x in rng.integers(0, 256, 200)]
    b = [int(x) for x in rng.integers(0, 256, 80)]
    c = a[:128] + [int(x) for x in rng.integers(0, 256, 72)]
    prompts, news = (a, b, c), (4, 12, 5)
    srv_j = js.Server(qj, SCFG_J, n_slots=2, cache_qtype=qtype)
    srv_t = ts.Server(qt, SCFG_T, n_slots=2, cache_qtype=qtype,
                      device="cpu")
    assert (srv_t.max_chunk, srv_t.cache_prompt) == (128, True)
    for srv in (srv_j, srv_t):
        for p, n in zip(prompts, news):
            srv.submit(p, max_new=n)
    out_j, out_t = srv_j.run_until_done(), srv_t.run_until_done()
    st_j, st_t = srv_j.stats(), srv_t.stats()
    assert st_t["cached_prompt_tokens"] == st_j["cached_prompt_tokens"] \
        == 128
    assert st_t["prefill_tokens"] == st_j["prefill_tokens"] == 352
    for rid, (p, n) in enumerate(zip(prompts, news)):
        assert len(out_t[rid]) == len(out_j[rid]) == n
        along = _logits_along(qt, p, out_t[rid], 128, SCFG_T, qtype)
        assert along.argmax(-1).tolist() == out_t[rid]
        _assert_near_tie_rule(
            _logits_along(qt, p, out_j[rid], 128, SCFG_T, qtype),
            out_j[rid], out_t[rid])


def _serve(qt, cfg, reqs, **kw):
    """One port server over ``reqs`` ([(prompt, max_new)], run one after
    another): the transcripts and the final stats."""
    srv = ts.Server(qt, cfg, n_slots=1, device="cpu", **kw)
    outs = []
    for p, n in reqs:
        rid = srv.submit(p, max_new=n)
        outs.append(srv.run_until_done()[rid])
    return outs, srv.stats()


def _reuse_case(qt, cfg, reqs, min_reused, qtype="bf16", bucket=8):
    """The last request of ``reqs`` served after the others reuses at
    least ``min_reused`` cached tokens, and its transcript is the cold
    server's under the near-tie rule (as the JAX prefix-cache tests)."""
    warm, st = _serve(qt, cfg, reqs, prefill_bucket=bucket,
                      cache_qtype=qtype)
    assert st["cached_prompt_tokens"] >= min_reused, st
    cold, st_cold = _serve(qt, cfg, reqs[-1:], prefill_bucket=bucket,
                           cache_qtype=qtype, cache_prompt=False)
    assert st_cold["cached_prompt_tokens"] == 0
    p = reqs[-1][0]
    along = _logits_along(qt, p, warm[-1], bucket * 8, cfg, qtype)
    _assert_near_tie_rule(along, warm[-1], cold[0])
    return warm, st


def test_prompt_prefix_cache_reuse(models):
    _, _, qt = models
    shared = [int(t) for t in np.random.default_rng(3).integers(1, 100, 24)]
    _reuse_case(qt, TCFG, [(shared + [11, 12], 3),
                           (shared + [11, 12, 40, 41], 4)], 24)


def test_prefix_cache_no_false_reuse(models):
    _, _, qt = models
    _, st = _reuse_case(qt, TCFG, [([3] * 24, 2), ([4] * 24, 2)], 0)
    assert st["cached_prompt_tokens"] == 0
    assert st["prefill_tokens"] == 48


def test_prefix_cache_includes_generated_tokens(models):
    """The reusable prefix runs over the previous request's generated
    tokens too (all but the last, which was never fed back)."""
    _, _, qt = models
    p1 = [int(t) for t in np.random.default_rng(4).integers(1, 100, 16)]
    out1, _ = _serve(qt, TCFG, [(p1, 8)], prefill_bucket=8)
    _, st = _reuse_case(qt, TCFG, [(p1, 8), (p1 + out1[0] + [7, 8], 2)],
                        16 + 7)
    assert st["cached_prompt_tokens"] == 16 + 7


def test_prefix_cache_q8(models):
    """Reuse round-trips the int8 cache's scales; the 100-token prompts
    prefill through K5 (chunk 128 at bucket 16)."""
    _, _, qt = models
    p1 = [int(t) for t in np.random.default_rng(5).integers(1, 100, 100)]
    _reuse_case(qt, TCFG, [(p1, 2), (p1 + [9, 10], 3)], 100, "q8", 16)


def test_cancel_running_and_queued(models):
    _, _, qt = models
    srv = ts.Server(qt, TCFG, n_slots=1, device="cpu")
    running = srv.submit([1, 2, 3], max_new=20)
    queued = srv.submit([4, 5, 6], max_new=20)
    srv.step()
    srv.step()
    assert srv.slots[0].rid == running and srv.queue[0].rid == queued
    assert srv.cancel(queued) and srv.cancel(running)
    assert not srv.cancel(queued) and not srv.cancel(99)
    assert srv.slots == [None] and srv.queue == []
    assert len(srv.finished[running].generated) == 3
    assert srv.finished[queued].generated == []
    assert srv.finished[running].done and srv.finished[queued].done
    assert srv.run_until_done() == {running: srv.finished[running].generated,
                                    queued: []}
