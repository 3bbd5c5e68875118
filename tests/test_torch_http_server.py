"""The port's HTTP front end (``python -m quant_gemm_tpu_torch.scripts.
server``) over real sockets on ``tests/golden/tiny_llama_q4km.gguf``, on
the CPU (``device="cpu"``), held against JAX's (``scripts/server.py``):
every endpoint JAX's ``tests/test_http_server.py`` drives, with its
checks, each request sent to both front ends.

JAX's ``scripts/server.py`` imports no JAX at module level.  Its
``make_handler`` runs here over a view of the port's Engine: the requests
go to the same Engine (one Server, so the greedy tokens behind both
answers are comparable), while the tokenizer, the GGUF metadata, the
config, the parameters and the embeddings on JAX's side are JAX's own
(``tokenizer_from_gguf``, ``load_llama``, ``llama.embed``; grammar
requests take JAX's ``GrammarSampler``).  So the stop-string handling, the
SSE framing, the completion, chat, logprobs, tokenize, props and error
bodies, ``response_format`` and ``grammar`` are compared whole, and the
transcripts are also held against the port's Server driven directly.

Tolerances: none for the bodies and SSE events, which are equal as JSON
text, logprobs included (one Server computes both).  Embeddings: equal
to the port's ``llama.embed`` driven directly, and within 1e-2 x
max|JAX's| of JAX's ``llama.embed``.  The two agree to about 5e-7 of that
on every token whose Q8_1 activation codes agree; where a code rounds the
other way at a near tie (the float32 sums before it differ in their last
bits), that token's hidden state moves by up to about 8e-3 of its
largest value, and the tokens after it through attention (the near-tie
rule of ``test_torch_model.py``, whose logit bound is 2e-2).  L2 norms
within 1e-3 of 1, as in JAX.
"""

import importlib.util
import json
import math
import pathlib
import sys
import threading
import types
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from quant_gemm_tpu_torch.models import llama, serve
from quant_gemm_tpu_torch.scripts import server as srv

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "golden" / "tiny_llama_q4km.gguf"


def _jax_server_module():
    """JAX's ``scripts/server.py`` as a module of its own name (its
    ``sys.path`` insertion undone)."""
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        "jax_scripts_server", ROOT / "scripts" / "server.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


jsrv = _jax_server_module()


def _admissions(server):
    """Wrap ``server.submit`` and ``server.step`` to record (steps run
    before it, request id, prompt ids) of each submission."""
    trace, steps = [], [0]
    submit, step = server.submit, server.step

    def submitted(prompt_ids, **kw):
        rid = submit(prompt_ids, **kw)
        trace.append((steps[0], rid, list(prompt_ids)))
        return rid

    def stepped():
        out = step()
        steps[0] += 1
        return out

    server.submit, server.step = submitted, stepped
    return trace


@pytest.fixture(scope="module")
def engine():
    eng = srv.build_engine(FIXTURE, n_slots=2, prefill_bucket=8,
                           device="cpu")
    eng.admitted = _admissions(eng.server)
    yield eng
    eng.shutdown()
    assert not eng.thread.is_alive()


@pytest.fixture(scope="module")
def jax_engine(engine):
    """What JAX's ``make_handler`` reads of an Engine: the port's Engine
    takes the requests; tokenizer, metadata, config, parameters and
    embeddings are JAX's."""
    from quant_gemm_tpu.formats.gguf_file import GGUFFile
    from quant_gemm_tpu.models import gguf_loader
    from quant_gemm_tpu.models.tokenizer import tokenizer_from_gguf

    gf = GGUFFile(str(FIXTURE))
    qparams, cfg = gguf_loader.load_llama(gf)

    def stats():
        with engine.lock:
            return engine.server.stats()

    server = types.SimpleNamespace(
        qparams=qparams, cfg=cfg, bucket=engine.server.bucket,
        act_mode=engine.server.act_mode, n_slots=engine.server.n_slots,
        stats=stats)
    return types.SimpleNamespace(
        server=server, tok=tokenizer_from_gguf(gf.metadata),
        metadata=gf.metadata, lock=threading.Lock(),
        results=engine.results, submit=engine.submit, cancel=engine.cancel)


def _serve(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, t, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def urls(engine, jax_engine):
    """(the port's base URL, JAX's front end's base URL)."""
    both = [_serve(srv.make_handler(engine)),
            _serve(jsrv.make_handler(jax_engine))]
    yield tuple(url for _, _, url in both)
    for httpd, t, _ in both:
        httpd.shutdown()
        httpd.server_close()
        t.join(60)


@pytest.fixture(scope="module")
def base_url(urls):
    return urls[0]


def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _stream_raw(url, obj):
    """The ``data:`` payloads of an SSE answer, as sent."""
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(line[6:])
    assert events[-1] == "[DONE]"
    return events


def _both(urls, path, obj):
    """``obj`` posted to the port's front end, then to JAX's: the answers
    must be equal.  Returns the port's."""
    mine = _post(urls[0] + path, obj)
    theirs = _post(urls[1] + path, obj)
    assert mine == theirs, (path, obj)
    return mine


def _both_stream(urls, path, obj):
    """The same for a streamed request: equal SSE payloads, in order."""
    mine = _stream_raw(urls[0] + path, obj)
    assert mine == _stream_raw(urls[1] + path, obj), (path, obj)
    return [json.loads(e) for e in mine[:-1]]


def _get_both(urls, path):
    out = []
    for u in urls:
        with urllib.request.urlopen(u + path, timeout=60) as r:
            out.append(json.loads(r.read()))
    assert out[0] == out[1], path
    return out[0]


def _direct(engine, ids, n):
    """The same greedy request through a fresh Server on the engine's
    parameters."""
    s = serve.Server(engine.server.qparams, engine.server.cfg, n_slots=2,
                     prefill_bucket=8, eos_id=engine.tok.eos_id,
                     device="cpu")
    rid = s.submit(ids, max_new=n)
    return s.run_until_done()[rid]


def test_health(urls):
    assert _get_both(urls, "/health") == {"status": "ok"}


def test_completion_native(urls, engine):
    out = _both(urls, "/completion",
                {"prompt": "hello world", "n_predict": 4})
    assert out["stop"] is True
    # every generated token is relayed, the admit-time one too (the
    # fixture model never emits EOS)
    assert out["tokens_predicted"] == 4
    assert out["tokens_evaluated"] == 5
    tok = engine.tok
    assert out["content"] == tok.decode(
        _direct(engine, tok.encode("hello world"), 4))
    stats = _get_both(urls, "/metrics")
    assert stats["generated_tokens"] >= 1


def test_openai_completion(urls):
    out = _both(urls, "/v1/completions",
                {"prompt": "the quick", "max_tokens": 3})
    assert out["object"] == "text_completion"
    assert out["choices"][0]["finish_reason"] == "stop"
    assert out["usage"]["completion_tokens"] >= 1


def test_openai_chat_uses_template(urls, engine):
    from quant_gemm_tpu_torch.models.tokenizer import (encode_with_specials,
                                                       render_chat)

    msgs = [{"role": "user", "content": "hi"}]
    out = _both(urls, "/v1/chat/completions",
                {"messages": msgs, "max_tokens": 3})
    assert out["object"] == "chat.completion"
    assert out["choices"][0]["message"]["role"] == "assistant"
    ids = encode_with_specials(engine.tok,
                               render_chat(engine.metadata, msgs))
    assert out["usage"]["prompt_tokens"] == len(ids)
    assert out["choices"][0]["message"]["content"] == engine.tok.decode(
        _direct(engine, ids, 3))
    events = _both_stream(urls, "/v1/chat/completions",
                          {"messages": msgs, "max_tokens": 3,
                           "stream": True})
    assert events[-1]["choices"][0]["finish_reason"] == "stop"
    assert "".join(e["choices"][0]["delta"].get("content", "")
                   for e in events) == out["choices"][0]["message"]["content"]


def test_streaming_sse(urls):
    payloads = _both_stream(urls, "/completion",
                            {"prompt": "hello world", "n_predict": 4,
                             "stream": True})
    assert payloads[-1]["stop"] is True
    # the deltas add up to the unstreamed answer (greedy, deterministic)
    text = "".join(p["content"] for p in payloads)
    ref = _post(urls[0] + "/completion",
                {"prompt": "hello world", "n_predict": 4})
    assert text == ref["content"], (text, ref["content"])
    oai = _both_stream(urls, "/v1/completions",
                       {"prompt": "hello world", "max_tokens": 4,
                        "stream": True})
    assert oai[-1]["choices"][0]["finish_reason"] == "stop"
    assert "".join(e["choices"][0]["text"] for e in oai) == text


def test_concurrent_requests_batch(urls, engine):
    """Four simultaneous requests, two through each front end, ride the
    continuous-batching slots; each answer is the Server's alone."""
    results = {}
    jobs = [(urls[i % 2], p) for i, p in enumerate(
        ["hello world", "the quick brown", "the quick brown",
         "hello world"])]

    def go(i, url, prompt):
        results[i] = _post(url + "/completion",
                           {"prompt": prompt, "n_predict": 3})

    ts = [threading.Thread(target=go, args=(i, u, p))
          for i, (u, p) in enumerate(jobs)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert len(results) == 4
    assert all(r["stop"] for r in results.values())
    tok = engine.tok
    for i, (_, prompt) in enumerate(jobs):
        assert results[i]["content"] == tok.decode(
            _direct(engine, tok.encode(prompt), 3)), (i, prompt)


def _jax_embed(jax_engine, text, pooling="mean"):
    import jax.numpy as jnp

    from quant_gemm_tpu.models import llama as jllama

    ids = jax_engine.tok.encode(text)
    padded = ids + [0] * (8 - len(ids))
    return np.asarray(jllama.embed(
        jax_engine.server.qparams, jax_engine.server.cfg,
        jnp.asarray([padded]), lengths=jnp.asarray([len(ids)]),
        pooling=pooling))[0]


def _close(got, want):
    """Within the near-tie bound of the module docstring."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("pooling", ["mean", "last"])
def test_embedding_native(urls, engine, jax_engine, pooling):
    body = {"content": "hello world", "pooling": pooling}
    out = _post(urls[0] + "/embedding", body)
    theirs = _post(urls[1] + "/embedding", body)
    v = out["embedding"]
    assert len(v) == 256 == len(theirs["embedding"])  # cfg.dim
    assert abs(math.fsum(x * x for x in v) - 1.0) < 1e-3  # L2-normalised
    _close(v, theirs["embedding"])
    _close(v, _jax_embed(jax_engine, "hello world", pooling))
    ids = engine.tok.encode("hello world")
    want = llama.embed(engine.server.qparams, engine.server.cfg,
                       torch.tensor([ids + [0] * (8 - len(ids))]),
                       lengths=[len(ids)], pooling=pooling)[0]
    assert torch.equal(torch.tensor(v), want)


def test_openai_embeddings(urls):
    body = {"input": ["hello world", "the quick brown"]}
    out = _post(urls[0] + "/v1/embeddings", body)
    theirs = _post(urls[1] + "/v1/embeddings", body)
    assert out["object"] == "list" == theirs["object"]
    assert out["usage"] == theirs["usage"]
    assert len(out["data"]) == 2 == len(theirs["data"])
    for mine, jx in zip(out["data"], theirs["data"]):
        assert {k: v for k, v in mine.items() if k != "embedding"} == \
            {k: v for k, v in jx.items() if k != "embedding"}
        _close(mine["embedding"], jx["embedding"])
    assert out["data"][0]["index"] == 0
    a, b = out["data"][0]["embedding"], out["data"][1]["embedding"]
    # different texts embed differently
    assert any(abs(x - y) > 1e-4 for x, y in zip(a, b))


def test_tokenize_detokenize_props(urls):
    out = _both(urls, "/tokenize", {"content": "hello world"})
    assert out["tokens"] == [0, 262, 312, 311, 292]
    back = _both(urls, "/detokenize", {"tokens": out["tokens"]})
    assert back["content"] == "hello world"
    props = _get_both(urls, "/props")
    assert props["n_embd"] == 256 and props["total_slots"] == 2
    assert "<|user|>" in props["chat_template"]


def _error(url, obj=None):
    """(status, body) of a request that fails: a GET without ``obj``."""
    with pytest.raises(urllib.error.HTTPError) as e:
        if obj is None:
            urllib.request.urlopen(url, timeout=60)
        else:
            _post(url, obj)
    return e.value.code, json.loads(e.value.read())


def test_unknown_endpoints_and_bad_bodies(urls):
    for path, obj, code in (("/nope", None, 404),
                            ("/nope", {"prompt": "x"}, 404),
                            ("/completion", {"n_predict": 2}, 400),
                            ("/v1/chat/completions", {"max_tokens": 2},
                             400)):
        mine = _error(urls[0] + path, obj)
        assert mine[0] == code
        assert mine == _error(urls[1] + path, obj)


def test_stop_strings(urls):
    # learn what the model emits, then stop on a substring of it
    full = _both(urls, "/completion",
                 {"prompt": "hello world", "n_predict": 6})
    content = full["content"]
    assert len(content) >= 2
    stop = content[1:3]  # a 2-char stop inside the natural output
    out = _both(urls, "/completion",
                {"prompt": "hello world", "n_predict": 6, "stop": [stop]})
    assert out["content"] == content[: content.find(stop)]
    assert stop not in out["content"]
    # streaming: deltas and the final tail add up to the same truncation
    events = _both_stream(urls, "/completion",
                          {"prompt": "hello world", "n_predict": 6,
                           "stop": [stop], "stream": True})
    text = "".join(e["content"] for e in events)
    assert text == out["content"], (text, out["content"])
    # a stop that never completes: its held prefix goes out at the end;
    # an empty stop is ignored; a string is one stop
    for stops in ([content[-1] + "\x00"], ["", content[2:4]],
                  content[3:5]):
        body = {"prompt": "hello world", "n_predict": 6, "stop": stops}
        want = _both(urls, "/completion", body)["content"]
        events = _both_stream(urls, "/completion", {**body, "stream": True})
        assert "".join(e["content"] for e in events) == want


_STOP_TEXT = st.text(alphabet="abé \n�", max_size=12)


@settings(max_examples=300, deadline=None)
@given(text=_STOP_TEXT, stops=st.lists(_STOP_TEXT, max_size=3))
def test_stop_helpers_equal_jax(text, stops):
    """``_find_stop`` and ``_hold_len`` give JAX's answers on the same
    strings, over a small alphabet so that stops match often."""
    assert srv._find_stop(text, stops) == jsrv._find_stop(text, stops)
    stops = [s for s in stops if s]  # as both handlers call it
    assert srv._hold_len(text, stops) == jsrv._hold_len(text, stops)


@settings(max_examples=100, deadline=None)
@given(ids=st.lists(st.integers(0, 324), max_size=8),
       prev=st.text(alphabet="ab ", max_size=6))
def test_decode_stream_equals_jax(engine, jax_engine, ids, prev):
    """``_decode_stream`` (a trailing partial UTF-8 glyph withheld) gives
    JAX's text, each with its own tokenizer, byte tokens included."""
    assert srv._decode_stream(engine.tok, ids, prev) == \
        jsrv._decode_stream(jax_engine.tok, ids, prev)


def test_grammar_forced_over_http(urls):
    out = _both(urls, "/completion",
                {"prompt": "say", "n_predict": 16,
                 "grammar": 'root ::= "yes" | "no"'})
    assert out["content"] in ("yes", "no"), out["content"]
    js = _both(urls, "/v1/completions",
               {"prompt": "data", "max_tokens": 4,
                "response_format": {"type": "json_object"}})
    assert js["choices"][0]["text"].startswith("{")
    # an explicit grammar wins over response_format; a streamed one
    both = {"prompt": "say", "n_predict": 8, "stream": True,
            "grammar": 'root ::= "yes" | "no"',
            "response_format": {"type": "json_object"}}
    events = _both_stream(urls, "/completion", both)
    assert "".join(e["content"] for e in events) in ("yes", "no")


def test_logprobs(urls):
    out = _both(urls, "/completion",
                {"prompt": "hello world", "n_predict": 3, "n_probs": 4})
    probs = out["completion_probabilities"]
    assert len(probs) == 3
    for p in probs:
        assert len(p["probs"]) == 4
        lps = [e["logprob"] for e in p["probs"]]
        assert all(lp <= 1e-6 for lp in lps)  # logprobs are <= 0
        assert lps == sorted(lps, reverse=True)  # descending
        # greedy: the chosen token is the top-1
        assert p["id"] == p["probs"][0]["id"]

    oai = _both(urls, "/v1/completions",
                {"prompt": "hello world", "max_tokens": 3, "logprobs": 2})
    lp = oai["choices"][0]["logprobs"]
    assert len(lp["tokens"]) == 3
    assert all(v is not None and v <= 1e-6 for v in lp["token_logprobs"])
    assert all(len(t) == 2 for t in lp["top_logprobs"])
    # a stop string cuts the tokens reported with the text
    stop = _both(urls, "/completion",
                 {"prompt": "hello world", "n_predict": 3, "n_probs": 2,
                  "stop": [out["content"][-1]]})
    assert len(stop["completion_probabilities"]) == stop["tokens_predicted"]


def test_engine_trace_replays_the_run(base_url, engine):
    """The Engine's admissions, recorded by wrapping its Server (step and
    ids of each submission): a fresh Server fed the same ids gives the
    same tokens."""
    out = _post(base_url + "/completion",
                {"prompt": "the quick brown fox", "n_predict": 5})
    step, rid, ids = engine.admitted[-1]
    assert ids == engine.tok.encode("the quick brown fox")
    assert step >= 1
    assert engine.tok.decode(_direct(engine, ids, 5)) == out["content"]


def test_engine_keeps_no_history(engine):
    """A long-running server holds no record of past requests: what the
    HTTP layer took over is gone from the Server and the Engine."""
    assert not engine.server.finished
    assert not engine.queues and not engine.results
    assert not hasattr(engine, "trace")


def test_build_engine_refuses_unported_options(tmp_path):
    """LoRA and W4A16 prefill are served (slice 15): a missing adapter
    file is refused, not skipped; ``prefill_a16`` reaches the Server."""
    with pytest.raises(FileNotFoundError):
        srv.build_engine(FIXTURE, lora_path=tmp_path / "adapter.gguf",
                         device="cpu")
    engine = srv.build_engine(FIXTURE, prefill_a16=True, device="cpu")
    try:
        assert engine.server.prefill_mode == "bf16"
        assert engine.server.act_mode == "q8_1"
    finally:
        engine.shutdown()
