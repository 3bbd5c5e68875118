"""The port's spans (``quant_gemm_tpu_torch/tracing.py``) and the Server's
request times, on the CPU at a small Llama (2 layers, dim 128):

* the span tree of a Server run: one ``serve.step`` per ``step`` call,
  one ``serve.admit`` per admission with its request's ``rid``, slot and
  reused prompt tokens, ``ceil((len(prompt) - reused) / max_chunk)``
  chunks each, a replay and a sample in every decode step, every child
  inside its parent;
* nothing is recorded with neither a profiler window nor ``start()``;
* ``t_submit <= t_admit <= t_first``, and ``reused`` summed over a step
  that admits several equals that step's ``cached_prompt_tokens``;
* under a CPU ``torch.profiler`` window every span is a
  ``record_function`` event of its name, its stamps within 100 us of the
  event's and their median within 20 us;
* wrappers patched onto ``serve.Graphs.run`` and ``sampling.sample`` (as
  the benchmark's trace patches them) see every chunk, decode replay and
  sample, each inside the span of its name.
"""

import math
import statistics

import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from quant_gemm_tpu_torch import tracing
from quant_gemm_tpu_torch.models import llama, sampling, serve

CFG = llama.LlamaConfig(vocab=64, dim=128, n_layers=2, n_heads=4,
                        n_kv_heads=2, d_ff=256, max_seq=256)
SHARED = list(range(1, 41))  # a 40-token prefix the later prompts reuse


@pytest.fixture(scope="module")
def qparams():
    return llama.init_qparams(CFG, seed=3, device="cpu")


@pytest.fixture
def fresh():
    tracing.stop()
    tracing.clear()
    yield
    tracing.stop()
    tracing.clear()


def _server(qparams):
    return serve.Server(qparams, CFG, n_slots=3, prefill_bucket=16,
                        max_prefill_chunk=32, device="cpu")


def _run(srv) -> int:
    """Two rounds of requests, the second reusing the first's prompts;
    returns the ``step`` calls made."""
    steps = 0
    for rnd in range(2):
        for i in range(3):
            srv.submit(SHARED + [50 + i] * (5 + 9 * i + 20 * rnd),
                       max_new=3 + i)
        while srv.queue or any(s is not None for s in srv.slots):
            srv.step()
            steps += 1
    return steps


def _by_name(spans) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_span_tree_of_a_server_run(qparams, fresh):
    srv = _server(qparams)
    tracing.start()
    steps = _run(srv)
    tracing.stop()
    spans = tracing.spans()
    assert tracing.dropped() == 0
    by_id = {s.id: s for s in spans}
    names = _by_name(spans)
    assert len(names["serve.step"]) == steps
    assert all(s.parent == -1 for s in names["serve.step"])
    # every child inside its parent, on the same request
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent != -1:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.rid == p.rid or p.rid == -1
    reqs = srv.finished
    admits = {s.rid: s for s in names["serve.admit"]}
    assert sorted(admits) == sorted(reqs) and len(admits) == 6
    assert sum(r.reused for r in reqs.values()) \
        == srv.stats()["cached_prompt_tokens"] > 0
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s.name)
    for rid, a in admits.items():
        r = reqs[rid]
        assert by_id[a.parent].name == "serve.step"
        assert a.attrs["reused"] == r.reused
        assert 0 <= a.attrs["slot"] < srv.n_slots
        n = math.ceil((len(r.prompt) - r.reused) / srv.max_chunk)
        assert kids[a.id] == ["serve.prefill.chunk"] * n + ["serve.sample"]
    decodes = names["serve.decode"]
    assert len(decodes) == srv.stats()["decode_steps"]
    for d in decodes:
        assert by_id[d.parent].name == "serve.step"
        assert kids[d.id] == ["serve.decode.replay", "serve.sample"]


def test_nothing_recorded_while_off(qparams, fresh):
    srv = _server(qparams)
    _run(srv)
    with tracing.span("outside", 7) as sp:
        sp.note(slot=1)
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_request_times_and_reuse(qparams, fresh):
    srv = _server(qparams)
    _run(srv)
    for r in srv.finished.values():
        assert r.t_submit <= r.t_admit <= r.t_first
    # three prompts sharing the first round's prefixes, admitted in one
    # step: their reuse adds up to the Server's count across that step
    before = srv.stats()["cached_prompt_tokens"]
    rids = [srv.submit(SHARED + [50 + i] * 12, max_new=2) for i in range(3)]
    srv.step()
    r = [srv.finished.get(i) or next(x for x in srv.slots if x.rid == i)
         for i in rids]
    assert all(x.t_first is not None for x in r)
    assert all(x.reused >= len(SHARED) for x in r)
    assert sum(x.reused for x in r) \
        == srv.stats()["cached_prompt_tokens"] - before


def test_spans_are_profiler_ranges_on_its_clock(qparams, fresh):
    srv = _server(qparams)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # the range a trace opens around what it reads, as the
        # benchmark's stretch does
        with record_function("stretch"):
            _run(srv)
    spans = tracing.spans()
    assert spans and tracing.dropped() == 0
    events: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("serve."):
            events.setdefault(e.name(), []).append((e.start_ns(),
                                                    e.end_ns()))
    gaps = []
    for name, group in _by_name(spans).items():
        evs = sorted(events[name])
        assert len(evs) == len(group), name
        for s, (e0, e1) in zip(sorted(group, key=lambda s: s.start_ns),
                               evs):
            gaps += [abs(s.start_ns - e0), abs(s.end_ns - e1)]
    assert max(gaps) <= 100_000, max(gaps)
    assert statistics.median(gaps) <= 20_000


def test_patched_wrappers_see_every_step(qparams, fresh, monkeypatch):
    seen = []
    run, sample = serve.Graphs.run, sampling.sample

    def graphs_run(graphs, key, fn):
        seen.append((key[0], tracing.now()))
        return run(graphs, key, fn)

    def sampled(*a, **k):
        seen.append(("sample", tracing.now()))
        return sample(*a, **k)

    monkeypatch.setattr(serve.Graphs, "run", graphs_run)
    monkeypatch.setattr(sampling, "sample", sampled)
    srv = _server(qparams)
    tracing.start()
    _run(srv)
    tracing.stop()
    names = _by_name(tracing.spans())
    for kind, name in (("chunk", "serve.prefill.chunk"),
                       ("decode", "serve.decode.replay"),
                       ("sample", "serve.sample")):
        at = [t for k, t in seen if k == kind]
        assert len(at) == len(names[name]) > 0, kind
        for t, s in zip(at, sorted(names[name], key=lambda s: s.start_ns)):
            assert s.start_ns <= t <= s.end_ns
