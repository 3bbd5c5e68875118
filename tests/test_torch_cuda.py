"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere.  The
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch.  ``tests/conftest.py`` imports JAX unless
``QGT_TEST_TPU`` is set; that variable means "run the JAX suite on a TPU",
and here it is set only to skip that import:

    QGT_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances (those of chip_smoke.py): K1 ``1e-4 * max|C|`` (float32
summation order), K2 ``2e-3 * max|C|`` (a Q8_1 code can also move across a
.5 rounding tie), K3 ``atol=2e-3``, K4 NMSE <= 1e-4; through the model,
with both op sets started from the same hidden state at every layer, each
layer's update and the logits NMSE <= 1e-4.
"""

import numpy as np
import pytest
import torch

from quant_gemm_tpu_torch.formats import quant as tq
from quant_gemm_tpu_torch.kernels import layout, registry
from quant_gemm_tpu_torch.kernels.gemm_dequant import (gemm_dequant,
                                                       gemm_dequant_plain)
from quant_gemm_tpu_torch.kernels.gemm_exact import (gemm_exact,
                                                     gemm_exact_plain)
from quant_gemm_tpu_torch.kernels.gemm_megalayer import (norm_qkv,
                                                         norm_qkv_plain)
from quant_gemm_tpu_torch.models import llama, serve
from quant_gemm_tpu_torch.ops.attention import flash_decode, flash_decode_plain

N, K, EPS = 768, 1024, 1e-5  # N not a multiple of the kernels' tiles

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc (the kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


@pytest.fixture
def weight(dev):
    w = np.random.default_rng(11).normal(0, 0.05, (N, K)).astype(np.float32)
    return layout.prepare(tq.quantize_q4_0(_t(w, dev)))


def _act(m, seed, dev, scale=1.0):
    x = np.random.default_rng(seed).standard_normal((m, K)) * scale
    return _t(x.astype(np.float32), dev)


@pytest.mark.parametrize("m", [1, 8, 12])
def test_gemm_exact(weight, dev, m):
    a = tq.quantize_q8_1(_act(m, 1, dev))
    before = gemm_exact.launches
    got, ref = gemm_exact(weight, a), gemm_exact_plain(weight, a)
    assert gemm_exact.launches == before + 1
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("m", [3, 8])
def test_norm_qkv(weight, dev, m):
    x = _act(m, 2, dev, scale=3.0)
    nw = _t(np.random.default_rng(3).normal(1, .1, K).astype(np.float32), dev)
    got, ref = norm_qkv(weight, x, nw, EPS), norm_qkv_plain(weight, x, nw, EPS)
    assert (got - ref).abs().max() <= 2e-3 * ref.abs().max()


@pytest.mark.parametrize("m", [16, 48, 100])
def test_gemm_dequant(weight, dev, m):
    a = registry.fold_q8_1(tq.quantize_q8_1(_act(m, 4, dev)))
    got, ref = gemm_dequant(weight, a), gemm_dequant_plain(weight, a)
    assert ((got - ref) ** 2).sum() <= 1e-4 * (ref ** 2).sum()


@pytest.mark.parametrize("hd, rep", [(64, 8), (128, 4)])
def test_flash_decode(dev, hd, rep):
    """Stacked cache via layer=, GQA, ragged positions including 0 (only
    the current token) and a stale position past the cache end."""
    rng = np.random.default_rng(5)
    b, kv, s, layers = 5, 2, 300, 3

    def f(*shape):
        return _t(rng.standard_normal(shape).astype(np.float32), dev)

    q = f(b, kv, rep, hd)
    kc = f(layers, b, kv, s, hd).to(torch.bfloat16)
    vc = f(layers, b, kv, s, hd).to(torch.bfloat16)
    kw = dict(k_current=f(b, kv, 1, hd).to(torch.bfloat16),
              v_current=f(b, kv, 1, hd).to(torch.bfloat16), layer=2)
    pos = torch.tensor([0, 31, 33, s - 1, 10_000], dtype=torch.int32,
                       device=dev)
    got = flash_decode(q, kc, vc, pos, **kw)
    ref = flash_decode_plain(q, kc, vc, pos, **kw)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 2e-3


def test_model_and_server_through_kernels(dev):
    cfg = llama.LlamaConfig(vocab=256, dim=512, n_layers=2, n_heads=8,
                            n_kv_heads=2, d_ff=1024, max_seq=128)
    qp = llama.init_qparams(cfg, seed=1, device=dev)
    toks = torch.randint(0, 256, (2, 48), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))

    def nmse(got, ref):
        return ((got - ref) ** 2).sum() / (ref ** 2).sum()

    cache = llama.KVCache.init(cfg, 2, device=dev)
    for tokens in (toks, toks[:, :1]):  # prefill, then a decode step
        cache_p = cache.clone()
        x, step = llama.begin(qp, cfg, tokens, cache)
        current = []
        for li, lyr in enumerate(qp["layers"]):
            xk, kv = llama.layer(lyr, li, cfg, x, cache, step)
            xp, _ = llama.layer(lyr, li, cfg, x, cache_p, step,
                                registry.PLAIN)
            assert nmse(xk - x, xp - x) <= 1e-4
            x = xk
            if kv is not None:
                current.append(kv)
        assert nmse(llama.head(qp, cfg, x),
                    llama.head(qp, cfg, x, registry.PLAIN)) <= 1e-4
        llama.end(cache, step, current)
    srv = serve.Server(qp, cfg, n_slots=2, max_prefill_chunk=48, device=dev)
    rids = [srv.submit(list(range(1, 70)), max_new=5),
            srv.submit([7, 8, 9], max_new=3)]
    res = srv.run_until_done()
    assert [len(res[r]) for r in rids] == [5, 3]
    assert all(0 <= t < 256 for r in rids for t in res[r])
