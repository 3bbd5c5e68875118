"""Perplexity in the port against the JAX package, on the CPU, at a small
Llama (dim 128, 2 layers, vocab 64, q8_0; a 200-token stream in windows of
48 advanced by 16).

Tolerances:

* the windowing and scoring: JAX's ``perplexity`` loop fed the port's
  window NLLs equals the port's ``perplexity`` within a relative 1e-12;
* end to end against JAX's ``perplexity`` as it runs, jitted, in ``"q8_1"``
  and ``"bf16"``: a relative 1e-3.  1e-4 does not hold there, for two
  measured reasons: JAX's jitted program and its own eager one give
  window NLL sums 0.072 apart on this stream (3.6e-4 of the perplexity),
  where the port's sums equal the eager one's (4.3e-4 from the jitted
  perplexity in all); and in ``"bf16"`` a float32 last-bit difference
  (XLA's and PyTorch's summation orders in RMSNorm and attention) moves a
  bf16-rounded activation by a whole bf16 step (2^-8 relative), as a
  Q8_1 code moves at a .5 tie: the port is 2.4e-4 from JAX there.

Exact: a window's NLL is the cross-entropy of its logits; one window's
perplexity is the exponential of its mean NLL; the CLI's ``report`` adds
its window.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_gemm_tpu.models import evaluate as jev
from quant_gemm_tpu.models import llama as jl
from quant_gemm_tpu_torch.models import evaluate as tev
from quant_gemm_tpu_torch.models import llama as tl
from quant_gemm_tpu_torch.scripts import perplexity as tppl

JCFG = jl.LlamaConfig(vocab=64, dim=128, n_layers=2, n_heads=2,
                      n_kv_heads=2, d_ff=256, max_seq=64)
TCFG = tl.LlamaConfig(**JCFG._asdict())
PPL_RTOL_LOGIC = 1e-12
PPL_RTOL_JIT = 1e-3


@pytest.fixture(scope="module")
def setup():
    params = jl.init_params(JCFG, seed=0)
    stream = np.random.default_rng(1).integers(0, 64, 200)
    return (jl.quantize_params(params, "q8_0"),
            tl.quantize_params(params, "q8_0", device="cpu"), stream)


@pytest.mark.parametrize("mode", ["bf16", "q8_1"])
def test_perplexity_matches_jax(setup, mode, monkeypatch):
    qj, qt, stream = setup
    got = tev.perplexity(qt, TCFG, stream, ctx=48, stride=16, act_mode=mode)
    want = jev.perplexity(qj, JCFG, stream, ctx=48, stride=16, act_mode=mode)
    assert got["tokens"] == want["tokens"] == 199
    assert abs(got["ppl"] - want["ppl"]) <= PPL_RTOL_JIT * want["ppl"]
    # JAX's windows and scoring, fed the port's NLLs (eagerly: the port's
    # forward takes arrays, not tracers)
    monkeypatch.setattr(jev, "nll_of_chunk", lambda qp, cfg, t, act_mode: (
        tev.nll_of_chunk(qt, TCFG, torch.from_numpy(np.array(t)),
                         act_mode).numpy()))
    with jax.disable_jit():
        logic = jev.perplexity(qj, JCFG, stream, ctx=48, stride=16,
                               act_mode=mode)
    assert abs(got["ppl"] - logic["ppl"]) <= PPL_RTOL_LOGIC * logic["ppl"]


def test_nll_is_the_cross_entropy(setup):
    _, qt, stream = setup
    toks = torch.from_numpy(stream[None, :32])
    nll = tev.nll_of_chunk(qt, TCFG, toks)
    logits, _ = tl.forward(qt, TCFG, toks,
                           tl.KVCache.init(TCFG, 1, device="cpu"))
    ce = torch.nn.functional.cross_entropy(logits[0, :-1], toks[0, 1:],
                                           reduction="none")
    assert nll.shape == (1, 31)
    torch.testing.assert_close(nll[0], ce, rtol=1e-5, atol=1e-5)
    one = tev.perplexity(qt, TCFG, stream[:32], ctx=32)
    assert one["tokens"] == 31
    assert abs(one["nll"] - float(nll.mean())) < 1e-5
    with pytest.raises(ValueError):
        tev.perplexity(qt, TCFG, stream[:1])


def test_cli_report_adds_the_window(setup):
    _, qt, stream = setup
    out = tppl.report(qt, TCFG, stream.tolist(), ctx=48, stride=16)
    assert out["ctx"] == 48 and out["stride"] == 16
    assert out["ppl"] == tev.perplexity(qt, TCFG, stream, ctx=48,
                                        stride=16)["ppl"]
    assert tppl.report(qt, TCFG, stream[:40].tolist())["stride"] == "ctx/2"
