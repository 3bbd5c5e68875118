"""HTTP serving front end (llama.cpp ``llama-server``), the port's
counterpart of ``scripts/server.py``.

The continuous-batching :class:`~quant_gemm_tpu_torch.models.serve.Server`
behind a threaded standard-library HTTP server, with llama.cpp-native and
OpenAI-compatible endpoints:

* ``POST /completion``          llama.cpp native: {prompt, n_predict,
  temperature, top_k, top_p, min_p, repeat_penalty, stream, stop,
  grammar, n_probs, cache_prompt, seed, ...}
* ``POST /v1/completions``      OpenAI completions (prompt, max_tokens,
  logprobs, stop, response_format)
* ``POST /v1/chat/completions`` OpenAI chat; messages render through the
  GGUF-embedded chat template (``tokenizer.chat_template``), as
  ``generate --chat`` does
* ``POST /embedding``           llama.cpp native sequence embedding
* ``POST /v1/embeddings``       OpenAI batch embeddings
* ``POST /tokenize`` / ``POST /detokenize``
* ``GET  /health``, ``GET /props`` (n_ctx, chat template, ...),
  ``GET /metrics`` (``Server.stats()``)

``"stream": true`` answers with Server-Sent Events (``data: {...}`` per
token, ``data: [DONE]`` at the end).

One engine thread owns the device: it steps the Server (whose decode
steps and prefill chunks are captured into and replayed from CUDA graphs
on that thread) and runs every other model call, the embeddings, from its
queue, so no handler thread launches work on the card while the engine
thread captures (a stream capture fails when another thread uses the
device).  Handler threads submit requests and drain per-request token
queues; concurrency comes from the Server's slots.

Usage: python -m quant_gemm_tpu_torch.scripts.server -m model.gguf
       [--port 8080] [--slots 8] [--kv q8] [--device cpu]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import queue
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class Engine:
    """Thread-safe bridge: handlers submit requests and model calls; one
    loop thread steps the Server and runs the calls."""

    def __init__(self, server, tok, metadata):
        self.server = server
        self.tok = tok
        self.metadata = metadata
        self.lock = threading.Lock()
        self.wake = threading.Condition(self.lock)
        self.queues: dict[int, queue.Queue] = {}
        self._sent: dict[int, int] = {}  # rid -> tokens already relayed
        self.results: dict[int, object] = {}  # rid -> finished Request
        self._calls: list = []  # (fn, future) for the engine thread
        self._stop = False
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, prompt_ids, **kw) -> tuple[int, queue.Queue]:
        q: queue.Queue = queue.Queue()
        with self.wake:
            rid = self.server.submit(prompt_ids, **kw)
            self.queues[rid] = q
            self._sent[rid] = 0
            self.wake.notify()
        return rid, q

    def call(self, fn):
        """``fn()`` run on the engine thread between steps; returns its
        result (or raises its exception) in the calling thread."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self.wake:
            if self._stop:
                raise RuntimeError("the engine is shut down")
            self._calls.append((fn, fut))
            self.wake.notify()
        return fut.result()

    def _relay(self) -> None:
        """Push every generated token not relayed yet (the admit-time
        token too, which ``Server.step()``'s return never holds) to its
        request's queue; a finished request's queue gets the end-of-stream
        sentinel."""
        reqs = {r.rid: r for r in self.server.slots if r is not None}
        for rid in list(self.queues):
            r = reqs.get(rid) or self.server.finished.get(rid)
            if r is None:
                continue
            sent = self._sent[rid]
            for t in r.generated[sent:]:
                self.queues[rid].put(int(t))
            self._sent[rid] = len(r.generated)
            if rid in self.server.finished:
                # the HTTP layer owns the result now; the Request is kept
                # only where the handler reads it back (n_probs)
                req_obj = self.server.finished.pop(rid)
                if req_obj.n_probs:
                    self.results[rid] = req_obj
                self.queues.pop(rid).put(None)
                self._sent.pop(rid)

    def _run_calls(self) -> None:
        calls, self._calls = self._calls, []
        for fn, fut in calls:
            try:
                fut.set_result(fn())
            except Exception as e:  # noqa: BLE001 - handed to the caller
                fut.set_exception(e)

    def _busy(self) -> bool:
        return bool(self._calls or self.server.queue
                    or any(s is not None for s in self.server.slots))

    def _loop(self):
        while True:
            with self.wake:
                while not self._stop and not self._busy():
                    self.wake.wait()
                if self._stop:
                    for _, fut in self._calls:
                        fut.set_exception(RuntimeError("engine shut down"))
                    return
                self._run_calls()
                try:
                    if self.server.queue or any(
                            s is not None for s in self.server.slots):
                        self.server.step()
                    self._relay()
                except Exception:  # noqa: BLE001 - keep the loop alive
                    traceback.print_exc(file=sys.stderr)
                    # release every request and wake its client: a failing
                    # request left active would fail every later step
                    for r in list(self.server.slots) + list(
                            self.server.queue):
                        if r is not None:
                            self.server.cancel(r.rid)
                    self.server.finished.clear()
                    for q in self.queues.values():
                        q.put(None)
                    self.queues.clear()
                    self._sent.clear()

    def cancel(self, rid: int) -> None:
        """Stop a request early (a stop string matched, the client went
        away) and end its queue with the sentinel now: the loop thread may
        be asleep."""
        with self.wake:
            self.server.cancel(rid)
            r = self.server.finished.pop(rid, None)
            q = self.queues.pop(rid, None)
            sent = self._sent.pop(rid, 0)
            if r is not None and r.n_probs:
                self.results[rid] = r
            if q is not None:
                if r is not None:
                    for t in r.generated[sent:]:
                        q.put(int(t))
                q.put(None)

    def shutdown(self, timeout: float = 60.0):
        """Stop the loop thread and wait for it."""
        with self.wake:
            self._stop = True
            self.wake.notify()
        self.thread.join(timeout)


def _decode_stream(tok, ids: list, prev_text: str) -> str:
    """Decoded text so far, withholding a trailing partial UTF-8 glyph so
    that a streamed delta never carries a replacement character that a
    later token takes back."""
    text = tok.decode(ids)
    while text.endswith("�"):
        text = text[:-1]
    return text if len(text) >= len(prev_text) else prev_text


def _find_stop(text: str, stops) -> int:
    """Index of the earliest stop string in ``text``, or -1."""
    best = -1
    for s in stops:
        i = text.find(s)
        if i >= 0 and (best < 0 or i < best):
            best = i
    return best


def _hold_len(text: str, stops) -> int:
    """Length of the longest tail of ``text`` that begins some stop
    string: withheld from the stream until it is decided (llama.cpp's
    stopping-word hold)."""
    hold = 0
    for s in stops:
        for n in range(min(len(s) - 1, len(text)), 0, -1):
            if s.startswith(text[-n:]):
                hold = max(hold, n)
                break
    return hold


def make_handler(engine: Engine):
    tok = engine.tok

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # stderr, not stdout
            sys.stderr.write("%s - %s\n" % (self.address_string(),
                                            fmt % args))

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def _run(self, prompt_ids, req, *, stream_fmt=None):
            from ..models.grammar import JSON_GBNF, GrammarSampler

            gsampler = None
            gbnf = req.get("grammar")  # llama.cpp server native field
            rf = req.get("response_format") or {}
            if gbnf is None and rf.get("type") == "json_object":
                gbnf = JSON_GBNF
            if gbnf:
                gsampler = GrammarSampler(gbnf, tok)
            kw = dict(
                max_new=int(req.get("n_predict",
                                    req.get("max_tokens", 64))),
                temperature=float(req.get("temperature", 0.0)),
                top_k=int(req.get("top_k", 0)),
                top_p=float(req.get("top_p", 1.0)),
                min_p=float(req.get("min_p", 0.0)),
                repeat_penalty=float(req.get("repeat_penalty", 1.0)),
                seed=req.get("seed"),
                grammar=gsampler,
                n_probs=int(req.get("n_probs", req.get("logprobs") or 0)),
                cache_prompt=bool(req.get("cache_prompt", True)),
            )
            stops = req.get("stop") or []
            if isinstance(stops, str):
                stops = [stops]
            stops = [s for s in stops if s]  # llama.cpp ignores empty ones
            rid, q = engine.submit(prompt_ids, **kw)

            def drain_after_cancel():
                engine.cancel(rid)
                while q.get() is not None:  # through the sentinel
                    pass

            if stream_fmt is None:
                ids = []
                while True:
                    t = q.get()
                    if t is None:
                        break
                    ids.append(t)
                    if stops:
                        i = _find_stop(tok.decode(ids), stops)
                        if i >= 0:
                            drain_after_cancel()
                            return rid, ids, tok.decode(ids)[:i]
                return rid, ids, tok.decode(ids)
            # Server-Sent Events; the finally cancels the engine request
            # when the client goes away (a write raises), so no tokens are
            # made for it and no result is kept
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            ids, emitted, text = [], "", ""
            stopped = False
            try:
                while True:
                    t = q.get()
                    if t is None:
                        break
                    ids.append(t)
                    text = _decode_stream(tok, ids, text)
                    full = text
                    if stops:
                        i = _find_stop(text, stops)
                        if i >= 0:
                            text = text[:i]
                            stopped = True
                        else:  # hold a tail that may become a stop
                            text = text[: len(text)
                                        - _hold_len(text, stops)]
                    delta = text[len(emitted):]
                    if delta:
                        self.wfile.write(
                            b"data: "
                            + json.dumps(stream_fmt(delta, False)).encode()
                            + b"\n\n")
                        self.wfile.flush()
                        emitted = text
                    if stopped:
                        break
                    text = full  # the held tail back
                # what was held back and never became a stop goes out now,
                # so the deltas add up to the unstreamed answer
                if stopped:
                    tail = ""
                else:
                    final = tok.decode(ids)
                    if stops:
                        i = _find_stop(final, stops)
                        final = final[:i] if i >= 0 else final
                    tail = final[len(emitted):]
                self.wfile.write(
                    b"data: " + json.dumps(stream_fmt(tail, True)).encode()
                    + b"\n\ndata: [DONE]\n\n")
                self.wfile.flush()
                self.close_connection = True
            finally:
                engine.cancel(rid)
                engine.results.pop(rid, None)
            return None

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok"})
            elif self.path in ("/metrics", "/stats"):
                with engine.lock:
                    stats = engine.server.stats()
                self._json(200, stats)
            elif self.path == "/props":
                cfg = engine.server.cfg
                self._json(200, {
                    "n_ctx": cfg.max_seq,
                    "n_embd": cfg.dim,
                    "n_vocab": cfg.vocab,
                    "total_slots": engine.server.n_slots,
                    "chat_template":
                        engine.metadata.get("tokenizer.chat_template", ""),
                    "model": engine.metadata.get("general.name", ""),
                })
            else:
                self._json(404, {"error": "unknown endpoint"})

        def do_POST(self):
            try:
                req = self._read_body()
                if self.path == "/completion":
                    self._completion(req)
                elif self.path == "/v1/completions":
                    self._oai_completion(req)
                elif self.path == "/v1/chat/completions":
                    self._oai_chat(req)
                elif self.path == "/embedding":
                    self._embedding(req)
                elif self.path == "/v1/embeddings":
                    self._oai_embeddings(req)
                elif self.path == "/tokenize":
                    self._json(200, {"tokens": tok.encode(req["content"])})
                elif self.path == "/detokenize":
                    self._json(200,
                               {"content": tok.decode(req["tokens"])})
                else:
                    self._json(404, {"error": "unknown endpoint"})
            except Exception as e:  # noqa: BLE001 - told to the client
                self._json(400, {"error": str(e)})

        def _embed_one(self, text, pooling="mean"):
            import torch

            from ..models import llama

            ids = tok.encode(text)
            # padded to the prefill bucket, the padding masked by
            # ``lengths``, as in JAX
            srv = engine.server
            width = max(-(-len(ids) // srv.bucket) * srv.bucket, srv.bucket)
            padded = ids + [0] * (width - len(ids))

            def run():
                dev = srv.device
                vec = llama.embed(
                    srv.qparams, srv.cfg,
                    torch.tensor([padded], device=dev),
                    lengths=torch.tensor([len(ids)], device=dev),
                    pooling=pooling, act_mode=srv.act_mode)
                return vec[0].cpu().tolist()

            return engine.call(run), len(ids)

        def _embedding(self, req):  # llama.cpp native
            emb, _ = self._embed_one(req["content"],
                                     req.get("pooling", "mean"))
            self._json(200, {"embedding": emb})

        def _oai_embeddings(self, req):
            inputs = req["input"]
            if isinstance(inputs, str):
                inputs = [inputs]
            data, total = [], 0
            for i, text in enumerate(inputs):
                emb, n = self._embed_one(text)
                total += n
                data.append({"object": "embedding", "index": i,
                             "embedding": emb})
            self._json(200, {"object": "list", "data": data,
                             "usage": {"prompt_tokens": total}})

        def _probs_payload(self, rid, out_ids):
            """llama.cpp's completion_probabilities of a finished
            request."""
            r = engine.results.pop(rid, None)
            if r is None or not r.probs:
                return None
            out = []
            for tid, top in zip(out_ids, r.probs):
                out.append({
                    "id": tid,
                    "token": tok.decode([tid]),
                    "probs": [{"id": t, "token": tok.decode([t]),
                               "logprob": lp} for t, lp in top],
                })
            return out

        def _completion(self, req):
            ids = tok.encode(req["prompt"])
            if req.get("stream"):
                self._run(ids, req, stream_fmt=lambda d, stop: {
                    "content": d, "stop": stop})
                return
            rid, out_ids, text = self._run(ids, req)
            body = {
                "content": text,
                "tokens_predicted": len(out_ids),
                "tokens_evaluated": len(ids),
                "stop": True,
            }
            probs = self._probs_payload(rid, out_ids)
            if probs is not None:
                body["completion_probabilities"] = probs
            self._json(200, body)

        def _oai_completion(self, req):
            ids = tok.encode(req["prompt"])
            if req.get("stream"):
                self._run(ids, req, stream_fmt=lambda d, stop: {
                    "object": "text_completion.chunk",
                    "choices": [{"text": d, "index": 0,
                                 "finish_reason": "stop" if stop else None}],
                })
                return
            rid, out_ids, text = self._run(ids, req)
            choice = {"text": text, "index": 0, "finish_reason": "stop"}
            probs = self._probs_payload(rid, out_ids)
            if probs is not None:  # OpenAI's logprobs shape
                choice["logprobs"] = {
                    "tokens": [p["token"] for p in probs],
                    "token_logprobs": [
                        next((e["logprob"] for e in p["probs"]
                              if e["id"] == p["id"]), None)
                        for p in probs],
                    "top_logprobs": [
                        {e["token"]: e["logprob"] for e in p["probs"]}
                        for p in probs],
                }
            self._json(200, {
                "object": "text_completion",
                "choices": [choice],
                "usage": {"prompt_tokens": len(ids),
                          "completion_tokens": len(out_ids)},
            })

        def _oai_chat(self, req):
            from ..models.tokenizer import encode_with_specials, render_chat

            text_in = render_chat(engine.metadata, req["messages"])
            ids = encode_with_specials(tok, text_in)
            if req.get("stream"):
                self._run(ids, req, stream_fmt=lambda d, stop: {
                    "object": "chat.completion.chunk",
                    "choices": [{"delta": ({"content": d} if d else {}),
                                 "index": 0,
                                 "finish_reason": "stop" if stop else None}],
                })
                return
            rid, out_ids, text = self._run(ids, req)
            engine.results.pop(rid, None)  # chat reports no logprobs
            self._json(200, {
                "object": "chat.completion",
                "choices": [{"message": {"role": "assistant",
                                         "content": text},
                             "index": 0, "finish_reason": "stop"}],
                "usage": {"prompt_tokens": len(ids),
                          "completion_tokens": len(out_ids)},
            })

    return Handler


def build_engine(model_path, *, n_slots=8, cache_qtype="bf16",
                 prefill_a16=False, prefill_bucket=16, lora_path=None,
                 device="cuda") -> Engine:
    """Load a GGUF file (weights and tokenizer) onto ``device``, apply the
    LoRA adapter at ``lora_path`` if one is given, and start an
    :class:`Engine` over a Server of ``n_slots`` slots (``prefill_a16``:
    W4A16 prompt processing)."""
    from ..formats.gguf_file import GGUFFile
    from ..models import gguf_loader, serve
    from ..models.tokenizer import tokenizer_from_gguf

    with GGUFFile(model_path) as gf:
        qparams, cfg = gguf_loader.load_llama(gf, device=device)
        metadata = gf.metadata
    if lora_path:
        from ..models import lora

        qparams = lora.attach_lora(
            qparams, lora.load_lora(lora_path, device=device), cfg)
    tok = tokenizer_from_gguf(metadata)
    srv = serve.Server(qparams, cfg, n_slots=n_slots,
                       cache_qtype=cache_qtype,
                       prefill_bucket=prefill_bucket,
                       prefill_a16=prefill_a16,
                       eos_id=tok.eos_id, device=device)
    return Engine(srv, tok, metadata)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--kv", default="bf16", choices=["bf16", "q8"])
    ap.add_argument("--lora", default=None, metavar="ADAPTER_GGUF",
                    help="apply a llama.cpp LoRA adapter at run time")
    ap.add_argument("--prefill-a16", action="store_true",
                    help="W4A16 prompt processing (bf16 activations; "
                         "decode stays W4A8)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    engine = build_engine(args.model, n_slots=args.slots,
                          cache_qtype=args.kv, lora_path=args.lora,
                          prefill_a16=args.prefill_a16, device=args.device)
    httpd = ThreadingHTTPServer((args.host, args.port),
                                make_handler(engine))
    print(f"listening on http://{args.host}:{args.port} "
          f"(slots={args.slots}, kv={args.kv}, device={args.device})",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        engine.shutdown()


if __name__ == "__main__":
    main()
