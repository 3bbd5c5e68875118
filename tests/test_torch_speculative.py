"""Speculative decoding in the port against the JAX package, on the CPU,
with JAX's test configurations (``tests/test_speculative.py``: a target of
dim 128 over 2 layers, a draft of dim 64 over 1, vocab 64, q8_0).

Tolerances: the speculative greedy transcript equals the port's own
``greedy_decode`` and JAX's ``speculative_greedy_decode`` under the
near-tie rule (each token is the target's argmax along the transcript, or
within twice the q8_1 logit tolerance 2e-2 * max|logits| of it: the verify
block and the T = 1 step are different compute paths, and both packages
quantize their own activations); where no step is that close, token for
token.  ``accept_or_residual`` keeps the target distribution, checked
analytically to 1e-12 as JAX checks it.  Exact: the rewind (both caches'
``pos`` at the prompt plus the tokens emitted), the max_seq check, the
sampled variant's determinism and greedy collapse, and ``sample_decode``
giving a request's Server tokens for the same seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_gemm_tpu.models import llama as jl
from quant_gemm_tpu.models import speculative as jspec
from quant_gemm_tpu_torch.models import llama as tl
from quant_gemm_tpu_torch.models import serve as ts
from quant_gemm_tpu_torch.models import speculative as tspec

CFG_T = jl.LlamaConfig(vocab=64, dim=128, n_layers=2, n_heads=2,
                       n_kv_heads=2, d_ff=256, max_seq=64)
CFG_D = jl.LlamaConfig(vocab=64, dim=64, n_layers=1, n_heads=2,
                       n_kv_heads=2, d_ff=128, max_seq=64)
T_T, T_D = tl.LlamaConfig(**CFG_T._asdict()), tl.LlamaConfig(
    **CFG_D._asdict())
LOGIT_TOL = 2e-2


@pytest.fixture(scope="module")
def models():
    pt, pd = jl.init_params(CFG_T, seed=0), jl.init_params(CFG_D, seed=1)
    return (tl.quantize_params(pt, "q8_0", device="cpu"),
            tl.quantize_params(pd, "q8_0", device="cpu"),
            jl.quantize_params(pt, "q8_0"), jl.quantize_params(pd, "q8_0"))


def _assert_target_greedy(qp, prompt, got):
    """``got`` [B, steps] is the target's greedy transcript of ``prompt``
    under the near-tie rule, the logits taken along it step by step."""
    prompt = np.asarray(prompt)
    got = np.asarray(got)
    cache = tl.KVCache.init(T_T, len(prompt), device="cpu")
    along = [tl.forward(qp, T_T, torch.from_numpy(prompt).long(),
                        cache)[0][:, -1]]
    for s in range(got.shape[1] - 1):
        along.append(tl.forward(qp, T_T, torch.from_numpy(
            got[:, s:s + 1]).long(), cache)[0][:, -1])
    along = torch.stack(along, dim=1)
    picked = along.gather(-1, torch.from_numpy(got).long()[..., None])[..., 0]
    slack = along.amax(-1) - picked
    assert (slack <= 2 * LOGIT_TOL * along.abs().amax(-1)).all()
    return bool(slack.any())


def test_matches_target_greedy_and_jax(models):
    """Whatever the draft proposes, the output is the target's greedy
    decode; JAX's speculative transcript is too."""
    qt, qd, qj, qjd = models
    prompt = np.asarray([[3, 14, 15, 9], [26, 5, 3, 5]], np.int32)
    want, cache = tl.greedy_decode(qt, T_T, prompt, 12)
    got, rate = tspec.speculative_greedy_decode(qt, T_T, qd, T_D, prompt,
                                                12, k=3)
    assert got.shape == (2, 12) and rate >= 0.5
    near = _assert_target_greedy(qt, prompt, got)
    if not near:
        assert got.tolist() == want.tolist()
    jgot, jrate = jspec.speculative_greedy_decode(
        qj, CFG_T, qjd, CFG_D, jnp.asarray(prompt), 12, k=3)
    near = _assert_target_greedy(qt, prompt, np.asarray(jgot)) or near
    if not near:
        assert np.asarray(jgot).tolist() == got.tolist()


def test_self_draft_accepts_most_and_rewinds(models, monkeypatch):
    """Draft == target: nearly every proposal is accepted (JAX measured
    3.25 tokens a call at k = 3); each round rewinds both caches' ``pos``
    to pos0 + accepted + 1, written in place."""
    qt = models[0]
    seen = []
    forward = tl.forward

    def spy(qp, cfg, tokens, cache, **kw):
        out = forward(qp, cfg, tokens, cache, **kw)
        seen.append((tokens.shape[1], cache.pos.data_ptr(),
                     cache.pos.tolist()))
        return out

    monkeypatch.setattr(tl, "forward", spy)
    prompt = [[7, 9, 2]]
    got, rate = tspec.speculative_greedy_decode(qt, T_T, qt, T_T, prompt, 12,
                                                k=3)
    monkeypatch.undo()
    # accepting every proposal gives 13 tokens in 4 calls (JAX's 3.25)
    assert tspec.best_rate(12, 3) == 3.25
    assert tspec.best_rate(64, 4) == 66 / 14
    assert rate >= 2.5, rate
    _assert_target_greedy(qt, prompt, got)
    verify = [s for s in seen if s[0] == 4]
    draft = [s for s in seen if s[0] == 1]
    assert len(draft) == 4 * len(verify)  # k + 1 draft steps a round
    # every round's steps see the rewound pos of the round before
    starts = [s[2][0] - 1 for s in draft[::4]]
    assert starts[0] == 3 and all(b > a for a, b in zip(starts, starts[1:]))
    assert len({s[1] for s in verify}) == 1  # the target's pos storage


def test_max_seq_must_hold_the_last_round(models):
    qt, qd = models[:2]
    with pytest.raises(ValueError, match="max_seq"):
        tspec.speculative_greedy_decode(qt, T_T, qd, T_D, [[1] * 40], 20,
                                        k=4)


def test_accept_residual_preserves_target_distribution():
    """P(y) = p_d(y) min(1, p_t(y)/p_d(y)) + P(reject) residual(y) ==
    p_t(y), and the code path agrees with the formula (JAX's test)."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        v = 16
        p_t = rng.dirichlet(np.ones(v) * 0.5)
        p_d = rng.dirichlet(np.ones(v) * 0.5)
        accept = np.minimum(1.0, p_t / np.maximum(p_d, 1e-30))
        p_reject = 1.0 - np.sum(p_d * accept)
        res = np.maximum(p_t - p_d, 0.0)
        res = res / res.sum() if res.sum() > 0 else p_t
        np.testing.assert_allclose(p_d * accept + p_reject * res, p_t,
                                   atol=1e-12)
        x = int(rng.integers(v))
        ok, r = tspec.accept_or_residual(p_t, p_d, x, 0.0)
        assert ok and r is None
        ok, r = tspec.accept_or_residual(p_t, p_d, x, 1.0)
        jok, jr = jspec.accept_or_residual(p_t, p_d, x, 1.0)
        assert ok == jok
        if p_t[x] < p_d[x]:
            assert not ok
            np.testing.assert_allclose(r, res, atol=1e-12)
            np.testing.assert_array_equal(r, jr)


def test_sample_decode_deterministic_and_greedy_collapse(models):
    qt, qd = models[:2]
    prompt = [[5, 6, 7]]
    a, _ = tspec.speculative_sample_decode(qt, T_T, qd, T_D, prompt, 8, k=3,
                                           temperature=0.8, seed=4)
    b, _ = tspec.speculative_sample_decode(qt, T_T, qd, T_D, prompt, 8, k=3,
                                           temperature=0.8, seed=4)
    c, _ = tspec.speculative_sample_decode(qt, T_T, qd, T_D, prompt, 8, k=3,
                                           temperature=0.8, seed=5)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool(((a >= 0) & (a < 64)).all())
    g1, _ = tspec.speculative_sample_decode(qt, T_T, qd, T_D, prompt, 8, k=3,
                                            temperature=0.0)
    g2, _ = tspec.speculative_greedy_decode(qt, T_T, qd, T_D, prompt, 8, k=3)
    assert torch.equal(g1, g2)


def test_sample_decode_gives_the_servers_tokens(models):
    """One request alone with a seed: the one-slot Server and
    ``sample_decode`` draw the same tokens (a 16-token prompt, so the
    Server's one chunk is the prompt itself)."""
    qt = models[0]
    prompt = np.random.default_rng(2).integers(0, 64, 16).tolist()
    srv = ts.Server(qt, T_T, n_slots=1, device="cpu")
    rid = srv.submit(prompt, max_new=10, temperature=0.9, top_k=20,
                     top_p=0.95, seed=11)
    want = srv.run_until_done()[rid]
    got, _ = tl.sample_decode(qt, T_T, [prompt], 10, seed=[11],
                              temperature=0.9, top_k=20, top_p=0.95)
    assert got[0].tolist() == want
    other, _ = tl.sample_decode(qt, T_T, [prompt], 10, seed=12,
                                temperature=0.9, top_k=20, top_p=0.95)
    assert other[0].tolist() != want


def test_generate_cli_draft(capsys):
    """``generate.py --draft``: the fixture GGUF as its own draft gives its
    pinned greedy transcript (``tests/test_gguf_interop.py``)."""
    from pathlib import Path

    from quant_gemm_tpu_torch.scripts import generate

    fixture = Path(__file__).parent / "golden" / "tiny_llama_q4km.gguf"
    generate.main(["-m", str(fixture), "--ids", "0,262,312,311,292", "-n",
                   "6", "--draft", str(fixture), "--draft-k", "3",
                   "--device", "cpu"])
    assert capsys.readouterr().out.strip() == "252,44,79,306,79,306"
