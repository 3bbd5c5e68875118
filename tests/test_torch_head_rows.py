"""The head on the rows a caller reads (``llama.forward``'s ``out_rows``,
llama.cpp's ``inp_out_ids``) and the Server's use of it, on the CPU, at a
small Llama (2 layers, dim 256 so that a q6_K head fits its 256-blocks).

* ``out_rows`` [B, R] gives the full forward's logits at those rows to
  float32 rounding (``max|delta| <= 1e-5 * max|logits|``) with the same
  argmax, for a per-32 (q4_0, K4 on the Q8_1 fold) and a per-16 (q6_K,
  the float32 matmul of ``registry.k16_dequant_gemm``) head.  The rows
  keep the route of the call's B * T rows however few they are: a
  prefill chunk's runs neither K1 nor K7.  Neither route is bit-equal on the CPU: the Q8_1 fold is
  row-local and bit-equal, but a float32 matmul of one row sums in
  another order than one of T rows (``tests/test_torch_cuda.py`` holds
  the card's routes);
* R = 0 runs neither the final norm nor the head and leaves the KV cache
  and ``cache.pos`` bit-equal to the full call's;
* the Server: prompts of 1, 2 and 3 chunks give the tokens and the staged
  cache rows of a Server whose head runs on every chunk row (``llama.
  head`` patched to compute every row, then gather), and ``stats()``
  counts one head row an admission and every other chunk headless.
"""

import numpy as np
import pytest
import torch

from quant_gemm_tpu_torch.kernels import registry
from quant_gemm_tpu_torch.models import llama as tl
from quant_gemm_tpu_torch.models import serve as ts

CFG = tl.LlamaConfig(vocab=96, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                     d_ff=512, max_seq=256)
ROUNDING = 1e-5


@pytest.fixture(scope="module")
def heads():
    """The q4_0 model with its own q4_0 head, and with a q6_K one."""
    params = tl.init_params(CFG, seed=21)
    qp = tl.quantize_params(params, device="cpu")
    q6 = tl.quantize_params(dict(params, layers=[]), "q6_k", device="cpu")
    return {"q4_0": qp, "q6_k": dict(qp, lm_head=q6["lm_head"])}


def _tokens(b, t, seed):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, CFG.vocab, (b, t)))


def _spy(counts):
    """KERNELS with every GEMM op counting its calls into ``counts``."""
    def wrap(name, fn):
        def call(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return call
    return registry.KERNELS._replace(**{
        n: wrap(n, f) for n, f in registry.KERNELS._asdict().items()})


def _prefilled(qp, seed=4):
    cache = tl.KVCache.init(CFG, 2, device="cpu")
    tl.forward(qp, CFG, _tokens(2, 20, seed), cache)
    return cache


@pytest.mark.parametrize("qtype", ["q4_0", "q6_k"])
@pytest.mark.parametrize("t, rows", [
    (1, [[0], [0]]), (5, [[4, 1], [0, 2]]), (48, [[47, 3], [0, 29]])])
def test_out_rows_are_the_full_forwards_rows(heads, qtype, t, rows):
    """T tokens on two slots at their own positions (a decode step, a
    5-token block, M 10, and a 48-token chunk): the head on ``rows``
    against the full call's rows at them, on the full call's route (K1 or
    K7 for the step and the block; for the chunk K4, or the per-16
    float32 matmul, and neither K1 nor K7), the caches bit-equal."""
    qp = heads[qtype]
    cache = _prefilled(qp)
    cache.pos[1] = 11
    tokens = _tokens(2, t, 5)
    rows = torch.tensor(rows)
    c_full, c_rows = cache.clone(), cache.clone()
    routes = []
    for c, r in ((c_full, None), (c_rows, rows)):
        counts: dict = {}
        k16 = registry.k16_dequant_gemm.calls
        out, _ = tl.forward(qp, CFG, tokens, c, out_rows=r, ops=_spy(counts))
        routes.append((counts, registry.k16_dequant_gemm.calls - k16))
        if r is None:
            full = out
        else:
            got = out
    want = torch.gather(full, 1, rows[:, :, None].expand(-1, -1, CFG.vocab))
    assert got.shape == (2, rows.shape[1], CFG.vocab)
    assert (got - want).abs().max() <= ROUNDING * want.abs().max()
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    assert routes[0] == routes[1]
    if t == 48:
        counts, k16 = routes[1]
        assert "gemm_exact" not in counts and "gemm_exact_k16" not in counts
        per_layer = 4 * CFG.n_layers
        assert (counts["gemm_dequant"], k16) == (
            (per_layer + 1, 0) if qtype == "q4_0" else (per_layer, 1))
    for x, y in zip(c_full.buffers() + [c_full.pos],
                    c_rows.buffers() + [c_rows.pos]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("qtype, cache_qtype", [("q4_0", "bf16"),
                                                ("q6_k", "q8")])
def test_no_head_leaves_the_cache_of_the_full_call(heads, qtype,
                                                   cache_qtype):
    """R = 0: logits [B, 0, vocab], no head GEMM, and the cache and
    ``cache.pos`` bit-equal to the full call's."""
    qp = heads[qtype]
    cache = tl.KVCache.init(CFG, 2, cache_qtype, device="cpu")
    tl.forward(qp, CFG, _tokens(2, 20, 6), cache)
    tokens = _tokens(2, 32, 7)
    c_full, c_none = cache.clone(), cache.clone()
    tl.forward(qp, CFG, tokens, c_full)
    counts: dict = {}
    k16 = registry.k16_dequant_gemm.calls
    got, out = tl.forward(qp, CFG, tokens, c_none, ops=_spy(counts),
                          out_rows=torch.zeros(2, 0, dtype=torch.int64))
    assert out is c_none and got.shape == (2, 0, CFG.vocab)
    assert counts["gemm_dequant"] == 4 * CFG.n_layers
    assert registry.k16_dequant_gemm.calls == k16
    assert c_none.pos.tolist() == c_full.pos.tolist() == [52, 52]
    for x, y in zip(c_full.buffers(), c_none.buffers()):
        assert torch.equal(x, y)


def _full_head(monkeypatch):
    """Patch ``llama.head`` to run on every row and then gather the rows
    asked for: the head of a Server before it named its rows."""
    head = tl.head

    def every_row(qp, cfg, x, ops=registry.KERNELS, act_mode="q8_1",
                  rows=None):
        out = head(qp, cfg, x, ops, act_mode)
        if rows is None:
            return out
        return torch.gather(out, 1, rows[:, :, None].expand(
            -1, -1, out.shape[-1]))

    monkeypatch.setattr(tl, "head", every_row)


def _serve(qp, prompts):
    """The first three prompts together, then the fourth."""
    srv = ts.Server(qp, CFG, n_slots=4, max_prefill_chunk=32, device="cpu")
    for p in prompts[:3]:
        srv.submit(p, max_new=5)
    srv.run_until_done()
    srv.submit(prompts[3], max_new=5)
    return srv, srv.run_until_done()


@pytest.mark.parametrize("qtype", ["q4_0", "q6_k"])
def test_server_reads_one_head_row_an_admission(heads, qtype, monkeypatch):
    """Prompts of 20, 50 and 90 tokens (1, 2 and 3 chunks of at most 32),
    then one reusing the 90-token prompt's first 64 tokens (one chunk of
    12): the tokens of a Server whose head runs on every chunk row, the
    same staged cache rows and first-token logits to float32 rounding;
    3 middle chunks headless and one head row an admission."""
    qp = heads[qtype]
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, CFG.vocab, n).tolist() for n in (20, 50, 90)]
    prompts.append(prompts[2][:64] + rng.integers(0, CFG.vocab, 12).tolist())
    srv, out = _serve(qp, prompts)
    st = srv.stats()
    assert st["prefill_chunks_headless"] == 0 + 1 + 2 + 0
    assert st["prefill_head_rows"] == len(prompts) == st["finished"]
    assert st["cached_prompt_tokens"] == 64
    # a staged prefill of each prompt alone, both ways
    got = [srv._prefill(0, p) for p in prompts[:3]]
    cache = [t[:, 0].clone() for t in srv.cache.buffers()]
    with monkeypatch.context() as m:
        _full_head(m)
        ref, ref_out = _serve(qp, prompts)
        assert ref.stats()["prefill_chunks_headless"] == 3
        want = [ref._prefill(0, p) for p in prompts[:3]]
        ref_cache = [t[:, 0] for t in ref.cache.buffers()]
    assert out == ref_out
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= ROUNDING * w.abs().max()
        top2 = w.topk(2).values
        assert g.argmax() == w.argmax() or \
            top2[0] - top2[1] <= 2 * ROUNDING * w.abs().max()
    for x, y in zip(cache, ref_cache):
        assert torch.equal(x[:, :, :90], y[:, :, :90])
