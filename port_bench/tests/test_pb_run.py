"""A whole run of the tiny cell on the CPU, past the look for a card:
sound it comes out correct; with the timed path broken underneath, or
with the control (the reference at 4-bit activations) in the program's
place, it does not.  Without a card the command exits non-zero and
prints no result."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench import check, harness

from . import tiny

CHECKOUT = Path(__file__).resolve().parents[2]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "mistral-7b.chat-decode", "--seed", "5",
                        "--seconds", "1", "--trace", "0"], cwd=CHECKOUT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_sound_run_is_correct(tmp_path):
    # long enough for 20 first tokens and 200 gaps on a loaded machine
    res = tiny.run_tiny(tmp_path, seconds=4.0)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"output_tok_s", "itl_p95_ms",
                                   "ttft_p90_ms", "prompt_tok_s", "setup_s"}
    assert list(res)[-1] == "compared"


def test_traced_run_reads_the_per_layer_metrics(tmp_path):
    res = tiny.run_tiny(tmp_path, trace=1)
    assert res["correct"]
    # no device here: the device's readings have nothing to read
    assert {"prefill_time_share", "prefix_reuse_share", "decode_mfu",
            "prefill_mfu"} <= set(res["metrics"])
    assert res["metrics"]["prefix_reuse_share"]["value"] > 50


def _fault_state_unchanged(monkeypatch):
    """Decode steps return the cache as they found it."""
    from quant_gemm_tpu_torch.models import llama

    monkeypatch.setattr(llama, "end", lambda cache, step, current: None)


def _fault_half_batch(monkeypatch):
    """The second half of a decode batch's rows left out, given the
    first half's."""
    from quant_gemm_tpu_torch.models import llama

    forward = llama.forward

    def half(qp, cfg, tokens, cache, **kw):
        logits, c = forward(qp, cfg, tokens, cache, **kw)
        b = logits.shape[0]
        if b > 1 and tokens.shape[1] == 1:
            logits = logits.clone()
            logits[b // 2:] = logits[: b - b // 2]
        return logits, c

    monkeypatch.setattr(llama, "forward", half)


def _fault_token_altered(monkeypatch):
    """Every sampled token is the next id."""
    from quant_gemm_tpu_torch.models import sampling

    sample = sampling.sample

    def altered(logits, *a, **k):
        return (sample(logits, *a, **k) + 1) % logits.shape[-1]

    monkeypatch.setattr(sampling, "sample", altered)


@pytest.mark.parametrize("fault", [_fault_state_unchanged, _fault_half_batch,
                                   _fault_token_altered],
                         ids=["state_unchanged", "half_batch",
                              "token_altered"])
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    res = tiny.run_tiny(tmp_path)
    assert not res["correct"], res["compared"]


def test_control_is_not_correct(tmp_path):
    """The control at the tiny size, on three seeds: its widest gap is
    over the limit on each, the program's under it."""
    cell = tiny.cell(tmp_path)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        run, model, state = harness.serve(cell, seed, 2.0, False,
                                          torch.device("cpu"), 0.0)
        del state
        reqs = check.sample(run, seed)
        g = check.gaps(harness.reference(cell, model), reqs, bits=4)
        prog = max(x["gap_max"] for x in g)
        ctl = max(x["control_gap_max"] for x in g)
        print(json.dumps({"seed": seed, "gap_max": prog,
                          "control_gap_max": ctl}))
        assert prog <= tiny.LIMIT < ctl


def test_forbidden_modules_are_found_by_whole_name(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "quant_gemm_tpu_torch_x",
                        types.ModuleType("quant_gemm_tpu_torch_x"))
    assert "quant_gemm_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "quant_gemm_tpu.models",
                        types.ModuleType("quant_gemm_tpu.models"))
    assert harness.forbidden_modules() == ["quant_gemm_tpu"]


def test_a_stretch_that_lost_its_lead_is_taken_again(tmp_path, monkeypatch):
    """Where the profiler dropped the whole lead graph, the run takes
    another stretch after the window and reads that one."""
    from port_bench import trace

    read, reads = trace.Stretch._read, []

    def lossy(self, events):
        read(self, events)
        reads.append(self.t0_ns)
        if len(reads) == 1:
            self.lead_lost = trace.LEAD_KERNELS

    monkeypatch.setattr(trace.Stretch, "_read", lossy)
    res = tiny.run_tiny(tmp_path, trace=1)
    assert len(reads) == 2 and reads[1] > reads[0]
    assert res["device"]["stretches"] == 2 and res["correct"]


def test_a_lead_lost_in_every_stretch_gives_no_result(tmp_path,
                                                      monkeypatch):
    from port_bench import trace

    read = trace.Stretch._read

    def lost(self, events):
        read(self, events)
        self.lead_lost = trace.LEAD_KERNELS

    monkeypatch.setattr(trace.Stretch, "_read", lost)
    with pytest.raises(RuntimeError, match="lead kernels"):
        tiny.run_tiny(tmp_path, trace=1)


class _Server:
    """What ``Loop`` reads of a Server that reuses prompts."""

    cache_prompt, bucket, n_slots = True, 4, 2

    def __init__(self):
        self.slots = [None, None]
        self.cached = 0

    def stats(self):
        return {"cached_prompt_tokens": self.cached}


class _Req:
    def __init__(self, rid, prompt):
        self.rid, self.prompt, self.done, self.generated = rid, prompt, \
            False, [1]


def _admit(loop, srv, reqs, slots):
    out = []
    for (rid, prompt), s in zip(reqs, slots):
        req = _Req(rid, prompt)
        srv.slots[s] = req
        out.append(harness.Request(rid, 0, prompt, 4, 0.0, req))
    loop._reuse(out)
    return out


def test_reuse_is_the_servers_count():
    srv = _Server()
    loop = harness.Loop(srv, {}, None, 0)
    loop._slot_hist = [list(range(10)), [7] * 10]
    # one admission takes the Server's count whole
    srv.cached = 6
    (r,) = _admit(loop, srv, [(1, list(range(8)) + [99])], [0])
    assert r.reuse == 6
    # two in one step: the split by slot must add up to the Server's count
    srv.slots = [None, None]
    srv.cached = 6 + 9 + 5
    a, b = _admit(loop, srv, [(2, list(range(9)) + [5]), (3, [7] * 6)],
                  [0, 1])
    assert (a.reuse, b.reuse) == (9, 5)
    srv.slots = [None, None]
    loop._slot_hist = [list(range(10)), [7] * 10]
    srv.cached += 3
    with pytest.raises(RuntimeError, match="prompt reuse"):
        _admit(loop, srv, [(4, list(range(9)) + [5]), (5, [7] * 6)], [0, 1])
