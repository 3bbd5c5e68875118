"""The W4A16 and float32 activation modes of the port against the JAX
package, on the CPU, at the small Llama of ``tests/test_torch_model.py``
(dim 512, GQA 8 over 2 heads, where JAX's q8_1 decode takes norm_qkv).

Tolerances: ``"bf16"`` and ``"float"`` logits against JAX's forward at the
same mode, ``max|delta| <= 2e-2 * max|logits|`` and NMSE <= 1.29e-4, the
largest NMSE the q8_1 rule has seen (``tests/torch_jax_gap.py``): no
Q8_1 code is formed on these paths, so nothing flips at a rounding tie and
only float32 summation orders differ.  ``w_down_a16`` (q8_1 everywhere but
the down projection) takes the q8_1 rule of ``tests/test_torch_model.py``
(2e-2, NMSE 2e-4).  Exact: the routes (K2 and K8 only at q8_1 decode; K8
serves ``w_down`` and so ``w_down_a16`` changes nothing under
``ENABLE_TAIL``); a Server in ``"bf16"``, or with ``prefill_a16``, gives
the tokens of the same forwards run by hand; graph keys name the mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_gemm_tpu.models import llama as jl
from quant_gemm_tpu_torch.kernels import gemm_megalayer
from quant_gemm_tpu_torch.models import llama as tl
from quant_gemm_tpu_torch.models import serve as ts

JCFG = jl.LlamaConfig(vocab=256, dim=512, n_layers=2, n_heads=8,
                      n_kv_heads=2, d_ff=1024, max_seq=128)
TCFG = tl.LlamaConfig(**JCFG._asdict())
LOGIT_TOL = 2e-2
A16_NMSE = 1.29e-4
Q8_NMSE = 2e-4


@pytest.fixture(scope="module")
def models():
    params = jl.init_params(JCFG, seed=3)
    return params, jl.quantize_params(params), tl.quantize_params(
        params, device="cpu")


def _close(got, want, nmse):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    assert ((got - want) ** 2).sum() <= nmse * (want ** 2).sum()


def _tokens(b, t, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, t)).astype(
        np.int32)


@pytest.mark.parametrize("mode", ["bf16", "float"])
def test_mode_logits_match_jax(models, mode):
    """A 16-token prefill of two slots then a decode step, each side in
    ``mode`` (``"float"`` through ``forward_float`` on the float
    parameters)."""
    params, qj, qt = models
    toks, nt = _tokens(2, 16, 1), _tokens(2, 1, 2)
    cj, ct = jl.KVCache.init(JCFG, 2), tl.KVCache.init(TCFG, 2, device="cpu")
    if mode == "float":
        fj = jax.jit(jl.forward_float, static_argnames=("cfg",))
        fp = tl.float_params(params, device="cpu")
        assert all(isinstance(fp["layers"][0][n], tl._FloatLinear)
                   for n in ("wqkv", "wo", "wgu", "w_down"))
        for t in (toks, nt):
            lj, cj = fj(params, JCFG, jnp.asarray(t), cj)
            lt, ct = tl.forward_float(fp, TCFG, torch.from_numpy(t), ct)
            _close(lt, lj, A16_NMSE)
        return
    for t in (toks, nt):
        lj, cj = jl.jit_forward(qj, JCFG, jnp.asarray(t), cj, act_mode=mode)
        lt, ct = tl.forward(qt, TCFG, torch.from_numpy(t), ct, act_mode=mode)
        _close(lt, lj, A16_NMSE)
    assert ct.pos.tolist() == np.asarray(cj.pos).tolist() == [17, 17]


def test_w_down_a16_matches_jax(models):
    """The down projection on bf16 activations in the q8_1 mode: a decode
    step of two slots on a fresh cache (M = 2: K4 in place of K1)."""
    _, qj, qt = models
    jcfg, tcfg = JCFG._replace(w_down_a16=True), TCFG._replace(w_down_a16=True)
    nt = _tokens(2, 1, 4)
    lj, _ = jl.jit_forward(qj, jcfg, jnp.asarray(nt), jl.KVCache.init(jcfg, 2))
    lt, _ = tl.forward(qt, tcfg, torch.from_numpy(nt),
                       tl.KVCache.init(tcfg, 2, device="cpu"))
    _close(lt, lj, Q8_NMSE)
    # and it is another product than the all-q8_1 one
    l0, _ = tl.forward(qt, TCFG, torch.from_numpy(nt),
                       tl.KVCache.init(TCFG, 2, device="cpu"))
    assert not torch.equal(l0, lt)


def test_routes_read_the_mode(models, monkeypatch):
    _, _, qt = models
    assert tl.routes(qt, TCFG, 2, 1) == (True, False)
    for mode in ("bf16", "float"):
        assert tl.routes(qt, TCFG, 2, 1, act_mode=mode) == (False, False)
    assert tl.routes(qt, TCFG, 2, 4) == (False, False)
    monkeypatch.setattr(gemm_megalayer, "ENABLE_TAIL", True)
    assert tl.routes(qt, TCFG, 2, 1) == (True, True)
    assert tl.routes(qt, TCFG, 2, 1, act_mode="bf16") == (False, False)
    nt = torch.from_numpy(_tokens(2, 1, 5).astype(np.int64))
    step = tl.begin(qt, TCFG, nt, tl.KVCache.init(TCFG, 2, device="cpu"),
                    act_mode="bf16")[1]
    assert step.act_mode == "bf16" and not step.use_mega


def test_tail_takes_precedence_over_w_down_a16(models, monkeypatch):
    """With ENABLE_TAIL and every layer tail_supported, K8 runs ``wo`` to
    the second residual, ``w_down`` included, so ``w_down_a16`` changes
    no bit of a decode step (JAX llama.py:697-715)."""
    _, _, qt = models
    monkeypatch.setattr(gemm_megalayer, "ENABLE_TAIL", True)
    toks, nt = _tokens(2, 16, 6), _tokens(2, 1, 7)
    cache = tl.KVCache.init(TCFG, 2, device="cpu")
    tl.forward(qt, TCFG, torch.from_numpy(toks), cache)
    out = [tl.forward(qt, cfg, torch.from_numpy(nt), cache.clone())[0]
           for cfg in (TCFG, TCFG._replace(w_down_a16=True))]
    assert torch.equal(out[0], out[1])
    monkeypatch.setattr(gemm_megalayer, "ENABLE_TAIL", False)
    last = tl.forward(qt, TCFG._replace(w_down_a16=True),
                      torch.from_numpy(nt), cache.clone())[0]
    assert not torch.equal(out[0], last)


def _by_hand(qt, prompt, n, prefill_mode, decode_mode):
    cache = tl.KVCache.init(TCFG, 1, device="cpu")
    logits, _ = tl.forward(qt, TCFG, torch.tensor([prompt]), cache,
                           act_mode=prefill_mode)
    toks = [int(logits[0, -1].argmax())]
    while len(toks) < n:
        logits, _ = tl.forward(qt, TCFG, torch.tensor([[toks[-1]]]), cache,
                               act_mode=decode_mode)
        toks.append(int(logits[0, -1].argmax()))
    return toks


@pytest.mark.parametrize("kw, modes", [
    (dict(act_mode="bf16"), ("bf16", "bf16")),
    (dict(prefill_a16=True), ("bf16", "q8_1")),
    (dict(act_mode="bf16", prefill_a16=True), ("bf16", "bf16"))])
def test_server_modes(models, kw, modes):
    """One request alone (a 32-token prompt, one chunk of its own length)
    in a one-slot Server: its tokens are those of the prefill in the
    chunk mode and the decode steps in the decode mode run by hand; the
    keys of its steps name their modes, and their routes keep K2 off
    outside q8_1 decode."""
    _, _, qt = models
    prompt = _tokens(1, 32, 8)[0].tolist()
    srv = ts.Server(qt, TCFG, n_slots=1, device="cpu", **kw)
    assert (srv.prefill_mode, srv.act_mode) == modes
    rid = srv.submit(prompt, max_new=6)
    got = srv.run_until_done()[rid]
    assert got == _by_hand(qt, prompt, 6, *modes)
    for key, route in srv._routes.items():
        assert key[2] == (modes[0] if key[0] == "chunk" else modes[1])
        assert route[0] == (key[0] == "decode" and key[2] == "q8_1")


def test_graph_key_names_the_mode():
    keys = {ts.graph_key("chunk", 128, m) for m in tl.ACT_MODES}
    assert len(keys) == 3
    assert ts.graph_key("decode", 256) == ts.graph_key("decode", 256, "q8_1")
    with pytest.raises(ValueError, match="act_mode"):
        ts.Server({"embed": torch.zeros(1)}, TCFG, device="cpu",
                  act_mode="q4")


def test_greedy_decode_is_the_forward_loop(models):
    """``greedy_decode`` in ``"bf16"``: the prefill and the decode steps
    of :func:`_by_hand`, row for row."""
    _, _, qt = models
    prompt = _tokens(2, 8, 9)
    got, cache = tl.greedy_decode(qt, TCFG, prompt, 5, act_mode="bf16")
    assert got.shape == (2, 5) and cache.pos.tolist() == [12, 12]
    for row in range(2):
        assert got[row].tolist() == _by_hand(
            qt, prompt[row].tolist(), 5, "bf16", "bf16")
