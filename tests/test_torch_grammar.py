"""Grammar-constrained sampling and top-N logprobs in the port against the
JAX package, on the CPU: the port's copy of ``models/grammar.py`` (the
GBNF parser, matcher and ``GrammarSampler``), the host-side helpers of
``models/serve.py`` and the Server's ``grammar=`` / ``n_probs=`` requests
on ``tests/golden/tiny_llama_q4km.gguf``.

Tolerances: the grammar engine is exact (rule tables, legal masks and
sampled tokens are equal).  The Servers: greedy tokens and top-N ids
equal; log-probabilities within 2e-2 x their largest magnitude, the
logit bound of ``tests/test_torch_model.py`` (each side quantizes its own
activations, and a float32 rounding difference can move a Q8_1 code
across a .5 tie; measured 7.6e-3 at a log-probability of -5).
"""

import pathlib

import numpy as np
import pytest

from quant_gemm_tpu.formats.gguf_file import GGUFFile
from quant_gemm_tpu.models import gguf_loader as jgl
from quant_gemm_tpu.models import grammar as jg
from quant_gemm_tpu.models import serve as js
from quant_gemm_tpu.models import tokenizer as jt
from quant_gemm_tpu_torch.models import gguf_loader as tgl
from quant_gemm_tpu_torch.models import grammar as tg
from quant_gemm_tpu_torch.models import serve as ts
from quant_gemm_tpu_torch.models import tokenizer as tt

FIXTURE = pathlib.Path(__file__).parent / "golden" / "tiny_llama_q4km.gguf"
GRAMMARS = {
    "yes_no": 'root ::= "yes" | "no"',
    "json": tg.JSON_GBNF,
    "list": 'root ::= "[" item ("," item)* "]"\nitem ::= [a-z]{1,3} | [0-9]+',
    "neg": 'root ::= [^"\\n]* "!"',
}


@pytest.fixture(scope="module")
def md():
    return GGUFFile(str(FIXTURE)).metadata


def test_grammar_module_is_the_jax_one():
    assert tg.JSON_GBNF == jg.JSON_GBNF
    for text in GRAMMARS.values():
        assert tg.parse_gbnf(text) == jg.parse_gbnf(text)
    for bad in ("root ::= (", "nothing here", 'foo ::= "a"', "root ::= [a-"):
        with pytest.raises(Exception) as et:
            tg.parse_gbnf(bad)
        with pytest.raises(Exception) as ej:
            jg.parse_gbnf(bad)
        assert type(et.value) is type(ej.value)


@pytest.mark.parametrize("name", sorted(GRAMMARS))
def test_filter_and_accept_equal_jax(md, name):
    """Walk a few legal tokens: every step's legal mask over the fixture
    vocabulary is JAX's, and the pieces accepted advance both alike."""
    tok_t, tok_j = tt.tokenizer_from_gguf(md), jt.tokenizer_from_gguf(md)
    gs_t = tg.GrammarSampler(GRAMMARS[name], tok_t)
    gs_j = jg.GrammarSampler(GRAMMARS[name], tok_j)
    rng = np.random.default_rng(7)
    logits = rng.standard_normal(len(tok_t.tokens)).astype(np.float32)
    for _ in range(4):
        mt, mj = gs_t.filter_logits(logits), gs_j.filter_logits(logits)
        np.testing.assert_array_equal(mt, mj)
        legal = np.flatnonzero(np.isfinite(mt))
        legal = legal[legal != tok_t.eos_id]
        if not len(legal):
            break
        tid = int(rng.choice(legal))
        gs_t.accept(tid)
        gs_j.accept(tid)
        assert gs_t.matcher.can_finish == gs_j.matcher.can_finish


def test_host_helpers_equal_jax():
    """``_adjusted_logits``, ``_top_logprobs`` and ``_grammar_sample``
    (greedy and seeded sampling) give JAX's numbers."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal(64).astype(np.float32) * 3
    recent = np.array([-1, -1, 3, 5, 5, 9], np.int64)
    for temp, top_k, top_p, min_p in ((0.0, 0, 1.0, 0.0),
                                      (0.8, 5, 0.9, 0.05)):
        kw = dict(prompt=[1], max_new=4, temperature=temp, top_k=top_k,
                  top_p=top_p, min_p=min_p, repeat_penalty=1.3,
                  logit_bias={7: 2.5, 3: -1.0}, seed=11)
        rj = js.Request(0, **kw)
        rt = ts.Request(0, **kw)
        np.testing.assert_array_equal(
            ts._adjusted_logits(logits, rt, recent),
            js._adjusted_logits(logits, rj, recent))
        assert ts._top_logprobs(logits, 5) == js._top_logprobs(logits, 5)

        class Every:  # a grammar that allows every token but 0..9
            def filter_logits(self, x):
                x = np.array(x, copy=True)
                x[:10] = -np.inf
                return x

        rj.grammar, rt.grammar = Every(), Every()
        for _ in range(3):
            assert ts._grammar_sample(logits, rt, recent) == \
                js._grammar_sample(logits, rj, recent)


@pytest.fixture(scope="module")
def servers(md):
    """Both Servers' results on the same three requests: a yes/no grammar,
    ``n_probs=3`` alone, a JSON grammar with ``n_probs=2``."""
    jp, jcfg = jgl.load_llama(str(FIXTURE))
    tp, tcfg = tgl.load_llama(FIXTURE, device="cpu")
    out = {}
    for name, mod, tmod, qp, cfg, kw in (
            ("jax", js, jt, jp, jcfg, {}),
            ("port", ts, tt, tp, tcfg, {"device": "cpu"})):
        tok = tmod.tokenizer_from_gguf(md)
        gmod = jg if name == "jax" else tg
        srv = mod.Server(qp, cfg, n_slots=2, prefill_bucket=8, **kw)
        ids = [srv.submit(tok.encode("say"), max_new=6,
                          grammar=gmod.GrammarSampler(GRAMMARS["yes_no"],
                                                      tok)),
               srv.submit(tok.encode("hello world"), max_new=4, n_probs=3),
               srv.submit(tok.encode("the quick"), max_new=5,
                          grammar=gmod.GrammarSampler(tg.JSON_GBNF, tok),
                          n_probs=2)]
        srv.run_until_done()
        out[name] = [srv.finished[i] for i in ids], tok
    return out


def test_grammar_requests_match_jax_server(servers):
    (rj, tok), (rt, _) = servers["jax"], servers["port"]
    for a, b in zip(rj, rt):
        assert b.generated == a.generated
    assert tok.decode(rt[0].generated).startswith(("yes", "no"))
    assert tok.decode(rt[2].generated).startswith("{")


def test_n_probs_match_jax_server(servers):
    (rj, _), (rt, _) = servers["jax"], servers["port"]
    for a, b in zip(rj[1:], rt[1:]):
        assert len(b.probs) == len(b.generated) == len(a.probs)
        for pa, pb in zip(a.probs, b.probs):
            assert [t for t, _ in pb] == [t for t, _ in pa]
            want = np.array([lp for _, lp in pa])
            np.testing.assert_allclose([lp for _, lp in pb], want, rtol=0,
                                       atol=2e-2 * np.abs(want).max())
    # greedy, no grammar: the token is the top-1 of its distribution
    assert [p[0][0] for p in rt[1].probs] == rt[1].generated


def test_grammar_that_cannot_continue_finishes_the_request(md):
    """A grammar no token can continue finishes its request with what it
    has: at admission (empty) and mid-generation (after its one legal
    token); the other request is served on, as in JAX."""
    tp, tcfg = tgl.load_llama(FIXTURE, device="cpu")
    tok = tt.tokenizer_from_gguf(md)
    srv = ts.Server(tp, tcfg, n_slots=3, prefill_bucket=8, device="cpu")
    never = "[^\\x00-\\U0010FFFF]"  # a class no code point is in
    bad = srv.submit(tok.encode("x"), max_new=4,
                     grammar=tg.GrammarSampler(f"root ::= {never}", tok))
    mid = srv.submit(tok.encode("y"), max_new=4,
                     grammar=tg.GrammarSampler(f'root ::= "a" {never}', tok))
    good = srv.submit(tok.encode("hello world"), max_new=3)
    out = srv.run_until_done()
    assert out[bad] == [] and srv.finished[bad].done
    assert tok.decode(out[mid]) == "a" and srv.finished[mid].done
    assert len(out[good]) == 3
