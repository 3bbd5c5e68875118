"""The port's model, weight converter and server against the JAX package,
on the CPU, at a small Llama where the JAX decode path takes its norm_qkv
megakernel (dim 512) and GQA (8 heads over 2 kv heads).

Tolerances:

* ``qparams_from_jax``: bit-equal to quantizing the same float weights in
  the port (both are exact integer / f16 results);
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
  tolerance of it (a near-tie either side may break its own way).
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
from quant_gemm_tpu_torch.kernels import registry
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


@pytest.mark.parametrize("t", [16, 48])
def test_forward_prefill_matches_jax(models, t):
    tokens = np.random.default_rng(t).integers(0, 256, (2, t)).astype(np.int32)
    lj, cj, lt, ct = _prefill_both(models, tokens)
    assert lt.shape == (2, t, JCFG.vocab)
    _assert_logits_close(lt, lj)
    _assert_cache_equal(cj, ct)


@pytest.mark.parametrize("t", [16, 48])
def test_forward_with_jax_codes_matches_jax(models, monkeypatch, t):
    """The gap of the test above is Q8_1 tie flips: with every activation
    quantized as JAX quantized it, the logits agree to float32 summation
    order, and the port's own codes of those same inputs differ from
    JAX's by at most one, in a few places."""
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
    assert sum(int(f.sum()) for f in flips) <= 10


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


def _logits_along(qt, prompt, toks):
    """The port's next-token logits [len(toks), vocab] at every step of a
    greedy transcript ``toks`` of ``prompt``, one request alone through
    :func:`forward` (48-token prefill chunks, then one decode step per
    token)."""
    cache = tl.KVCache.init(TCFG, 1, device="cpu")
    for off in range(0, len(prompt), 48):
        part = prompt[off:off + 48]
        logits, cache = tl.forward(qt, TCFG, torch.tensor([part]), cache)
    steps = [logits[0, -1]]
    for tok in toks[:-1]:
        logits, cache = tl.forward(qt, TCFG, torch.tensor([[tok]]), cache)
        steps.append(logits[0, -1])
    return torch.stack(steps)


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
        along_j = _logits_along(qt, p, out_j[rid])
        picked = along_j[torch.arange(n), torch.tensor(out_j[rid])]
        slack = along_j.amax(-1) - picked
        assert (slack <= 2 * LOGIT_TOL * along_j.abs().amax(-1)).all()
        if not slack.any():  # JAX took the port's argmax at every step
            assert out_t[rid] == out_j[rid]
    st = srv_t.stats()
    assert st["finished"] == 2 and st["prefill_tokens"] == 144
    assert st["generated_tokens"] == sum(news)


def test_server_rejects_options_outside_the_slice(models):
    _, _, qt = models
    for kw in ({"cache_qtype": "q8"}, {"context_shift": True},
               {"prefill_a16": True}, {"cache_prompt": True},
               {"max_prefill_chunk": 128}):
        with pytest.raises(NotImplementedError):
            ts.Server(qt, TCFG, device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        ts.Server(qt, TCFG._replace(window=16), device="cpu")
    srv = ts.Server(qt, TCFG, n_slots=1, max_prefill_chunk=48, device="cpu")
    with pytest.raises(NotImplementedError):
        srv.submit([1, 2], grammar=object())
    with pytest.raises(NotImplementedError):
        srv.submit([1, 2], n_probs=3)


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
