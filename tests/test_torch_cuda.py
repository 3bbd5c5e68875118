"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere.  The
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch; ``--noconftest`` keeps pytest from loading
``tests/conftest.py``, which imports JAX for the rest of the suite:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances (those of chip_smoke.py): K1 ``1e-4 * max|C|`` (float32
summation order; q4_k and K7 ``1e-5 * max|C|``), K2 ``2e-3 * max|C|`` (a
Q8_1 code can also move across a .5 rounding tie), K3 and K5, linear and
ring, ``atol=2e-3``, K4 NMSE <= 1e-4, K8 ``2e-3 * max|out - x|`` on the layer
update (K2's rule), and its wo and w_down stages bit for bit equal to
``quantize_q8_1`` + K1 on inputs where the glue between them is exact;
through the model, with both op sets started from the same hidden state
at every layer, each layer's update and the logits NMSE <= 1e-4.
Exact: K6 equals ``quantize_q8_1`` + K1 bit for bit, and K2 equals
``quantize_q8_1`` + K1 bit for bit where its RMSNorm is exact (rows of
+-1, eps 0), in every form (both run K1's body and order), also
replayed from a CUDA graph.  K1 in the q4_1/q5_0/q5_1/q8_0 forms
``1e-4 * max|C|``, K4 in them (bf16 and float32 activations) NMSE <=
1e-4, K9 ``rms_norm_pallas`` ``1e-5 * max|y|`` (its own sum order), K10
``softmax_pallas`` ``atol=1e-6``, both also bit for bit equal to their
plain steps on the sum taken in the kernel's order (``ops/rows.py::
ordered_sum``), on the row plan's clusters and its streamed rows too,
and two calls bit-equal; K4's float32 operands (three bf16 pieces) in
every form, f32 A and ``fused_quant`` into float32, NMSE <= ``FQ_NMSE``
and two calls bit-equal, and a float32 A through a q8_0 identity weight
bit for bit; the spec runner on the
card passes every definition under its own threshold.  Slice 7: K2 in the
q4_1/q4_k/q5_0/q5_1/q5_k forms ``2e-3 * max|C|``, K6 in q4_1 and q8_0 bit
for bit, K1 on q5_k ``1e-5 * max|C|``, K4 on q5_k NMSE <= 1e-4, K4 with
``fused_quant`` (every per-32 form, bf16 and float32 operands) NMSE <=
``FQ_NMSE`` = 1e-8 (kernel and plain version feed the same fake-quantized
operand, so only the float32 summation order differs: about 1e-12 on an
H100; leaving the fake quantization out moves the output by about 3e-5),
and K4's in-kernel fake quantization bit for bit.  The tensor-core
prefill kernels (K4's bf16 operand forms, K5): K4 at ragged M and an N no
tile divides, bf16 and ``fused_quant`` bf16, NMSE <= ``FQ_NMSE`` (every
product is exact, so only the float32 summation order differs); K5
split over the slots at full Mistral-7B ring width ``atol=2e-3``; both
kernels give the same bits on two calls.  Decode on the tensor cores: K3
at every linear and ring parametrisation with its piece count as chosen,
forced to 1 and to its maximum, ``atol=2e-3`` and two calls bit-equal;
K1 in all seven forms equal bit for bit to ``k1_order`` of the plain
version's per-block terms (its summation order replayed).  The
activation quantizers (``kernels/act_quant.py``): codes, scales and the
bf16 fold bit for bit equal to the torch twins on the CPU, also at .5
ties, on zero and f16-saturating blocks; K1 and K3 replay bit-equal from
a CUDA graph; a 2-layer Server's captured transcripts equal its eager
ones, token for token, on the linear cache and the ring, bf16 and q8.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from quant_gemm_tpu_torch.formats import kquants
from quant_gemm_tpu_torch.formats import quant as tq
from quant_gemm_tpu_torch.formats.blocks import Q8_1Tensor
from quant_gemm_tpu_torch.kernels import act_quant, layout, registry
from quant_gemm_tpu_torch.kernels.gemm_dequant import (fake_quant_q8,
                                                       gemm_dequant,
                                                       gemm_dequant_plain)
from quant_gemm_tpu_torch.kernels import gemm_megalayer
from quant_gemm_tpu_torch.kernels.gemm_exact import (block_terms,
                                                     gemm_exact,
                                                     gemm_exact_fused,
                                                     gemm_exact_fused_plain,
                                                     gemm_exact_plain,
                                                     k1_order)
from quant_gemm_tpu_torch.kernels.gemm_exact_k16 import (
    gemm_exact_k16, gemm_exact_k16_plain, k16_block_terms)
from quant_gemm_tpu_torch.kernels.gemm_megalayer import (attn_tail,
                                                         attn_tail_plain,
                                                         norm_qkv,
                                                         norm_qkv_plain)
from quant_gemm_tpu_torch.models import gguf_loader, llama, serve
from quant_gemm_tpu_torch.ops.activations import silu_mul
from quant_gemm_tpu_torch.ops.attention import (decode_max_pieces,
                                                flash_decode,
                                                flash_decode_plain,
                                                flash_prefill,
                                                flash_prefill_plain)
from quant_gemm_tpu_torch.ops import rows
from quant_gemm_tpu_torch.ops.rms_norm import (rms_norm, rms_norm_pallas,
                                               rms_norm_pallas_plain)
from quant_gemm_tpu_torch.ops.rms_norm import rsqrt as rms_rsqrt
from quant_gemm_tpu_torch.ops.softmax import (softmax_pallas,
                                              softmax_pallas_plain)
from quant_gemm_tpu_torch.specs import spec_runner

N, K, EPS = 768, 1024, 1e-5  # N not a multiple of the kernels' tiles
FQ_NMSE = 1e-8  # K4 fused_quant against its plain version (module doc)

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


K2_FORMS = ["q4_0", "q4_1", "q4_k", "q5_0", "q5_1", "q5_k"]


@pytest.mark.parametrize("k", [1056, 2048, 4096, 16384])
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("qtype", K2_FORMS)
def test_norm_qkv_codes_exact(dev, qtype, m, k):
    """Rows of +-1 and eps 0 make K2's RMSNorm exact (h = x * w), so its
    output must equal quantize_q8_1(h) + K1 bit for bit: the shared
    in-kernel quantizer gives quantize_q8_1's codes and scales, and the
    GEMM is K1's body in K1's order (``k1_order`` of the plain terms).
    K 16384 quantizes each chunk as it is staged (the codes of the whole
    row do not fit beside the weight ring); N = 774 leaves a ragged row
    tile."""
    w = _weight_any(qtype, k, dev, rows=774)
    rng = np.random.default_rng(31)
    x = np.where(rng.random((m, k)) < 0.5, -1.0, 1.0).astype(np.float32)
    nw = rng.normal(1, 0.3, k).astype(np.float32)
    before = norm_qkv.launches
    got = norm_qkv(w, _t(x, dev), _t(nw, dev), 0.0)
    assert norm_qkv.launches == before + 1
    a = tq.quantize_q8_1(_t(x * nw, dev))
    assert torch.equal(got, gemm_exact(w, a))
    cpu = layout.PreparedWeight(*(t.cpu() if isinstance(t, torch.Tensor)
                                  else t for t in w))
    want = k1_order(block_terms(cpu, Q8_1Tensor(*(t.cpu() for t in a))))
    assert torch.equal(got.cpu(), want)


def _degenerate(x):
    """Zero blocks (d = 0, codes 0) and blocks whose amax / 127 saturates
    f16, as tests/test_kernels.py::test_fused_exact_degenerate_blocks."""
    x = x.clone()
    x[0, 0:32] = 0.0
    x[-1, 32:64] = 7e8
    x[x.shape[0] // 2, 64:96] = -7e8
    return x


@pytest.mark.parametrize("k", [2048, 5632, 14336])
@pytest.mark.parametrize("m", [1, 8, 12])
@pytest.mark.parametrize("qtype", ["q4_0", "q4_k", "q4_1", "q8_0"])
def test_gemm_exact_fused(dev, qtype, m, k):
    """K6 equals quantize_q8_1 + K1 bit for bit, degenerate blocks
    included, in every form it has (q4_0, q4_k, q4_1 and q8_0), with
    the codes resident in shared memory and, at K 14336 and M 12 (q8_0:
    also M 8), quantized chunk by chunk; N = 774 leaves a ragged row
    tile."""
    g = torch.Generator(device=dev).manual_seed(41)
    if qtype != "q4_k":
        w = layout.prepare(tq.QUANTIZE[qtype](
            torch.randn(774, k, generator=g, device=dev) * k ** -0.5))
    else:
        w = layout.prepare(kquants.to_effective(_kquant("q4_K", 774, k, dev)))
    for x in (torch.randn(m, k, generator=g, device=dev),
              _degenerate(torch.randn(m, k, generator=g, device=dev))):
        before = gemm_exact_fused.launches
        got = gemm_exact_fused(w, x)
        assert gemm_exact_fused.launches == before + 1
        assert torch.equal(got, gemm_exact(w, tq.quantize_q8_1(x)))
        assert torch.isfinite(got).all()
        ref = gemm_exact_fused_plain(w, x)
        assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


# K8's widths: TinyLlama-1.1B and Mistral-7B-v0.1 (dim, d_ff), and one
# whose d_ff codes do not fit beside the ring (its w_down stage CHUNKED)
TAIL_WIDTHS = [(2048, 5632), (4096, 14336), (512, 19456)]


def _tail_weights(dim, dff, g, dev, gate=None):
    def lin(n, k, w=None):
        w = torch.randn(n, k, generator=g, device=dev) * k ** -0.5 \
            if w is None else w
        return layout.prepare(tq.quantize_q4_0(w))

    wgu = lin(2 * dff, dim, None if gate is None else torch.cat(
        [gate, torch.randn(dff, dim, generator=g, device=dev)
         * dim ** -0.5]))
    return lin(dim, dim), wgu, lin(dim, dff)


@pytest.mark.parametrize("dim, dff", TAIL_WIDTHS)
@pytest.mark.parametrize("m", [1, 8])
def test_attn_tail(dev, m, dim, dff):
    """K8 against its plain chain on the layer update out - x, and two
    calls bit-equal."""
    g = torch.Generator(device=dev).manual_seed(43)
    wo, wgu, wd = _tail_weights(dim, dff, g, dev)
    attn = torch.randn(m, dim, generator=g, device=dev)
    x = torch.randn(m, dim, generator=g, device=dev) * 3.0
    nw = 1.0 + 0.1 * torch.randn(dim, generator=g, device=dev)
    before = attn_tail.launches
    got = attn_tail(attn, x, nw, wo, wgu, wd, EPS, dff)
    assert attn_tail.launches == before + 1
    ref = attn_tail_plain(attn, x, nw, wo, wgu, wd, EPS, dff)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 2e-3 * (ref - x).abs().max()
    assert torch.equal(got, attn_tail(attn, x, nw, wo, wgu, wd, EPS, dff))


@pytest.mark.parametrize("dim, dff", TAIL_WIDTHS)
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("stage", ["wo", "w_down"])
def test_attn_tail_stages_exact(dev, stage, m, dim, dff):
    """K8's GEMM stages equal quantize_q8_1 + K1 bit for bit, at
    TinyLlama-1.1B and Mistral-7B-v0.1 width and with a d_ff whose codes
    are quantized chunk by chunk.
    wo: x = 0 and w_down's scales 0, so out is the wo stage.  w_down:
    wo's scales 0 (xm = x), rows of mostly +1 and a few -1 with eps 0 (the
    RMSNorm is exact) and positive gate weights, so every gate output is
    far above 17, where SiLU is the identity in float32; ff is then
    exact and out = x + the w_down stage."""
    g = torch.Generator(device=dev).manual_seed(47)

    def zero_scales(w):
        return w._replace(d=torch.zeros_like(w.d))

    gate = 0.5 + 0.5 * torch.rand(dff, dim, generator=g, device=dev)
    wo, wgu, wd = _tail_weights(dim, dff, g, dev, gate)
    attn = torch.randn(m, dim, generator=g, device=dev)
    nw = 0.5 + torch.rand(dim, generator=g, device=dev)
    if stage == "wo":
        x = torch.zeros(m, dim, device=dev)
        got = attn_tail(attn, x, nw, wo, wgu, zero_scales(wd), EPS, dff)
        want = gemm_exact(wo, tq.quantize_q8_1(attn))
    else:
        x = torch.where(torch.rand(m, dim, generator=g, device=dev) < 0.1,
                        -1.0, 1.0)
        got = attn_tail(attn, x, nw, zero_scales(wo), wgu, wd, 0.0, dff)
        gu = gemm_exact(wgu, tq.quantize_q8_1(rms_norm(x, nw, 0.0)))
        assert gu[:, :dff].min() > 100.0
        ff = silu_mul(gu[:, :dff], gu[:, dff:])
        want = x + gemm_exact(wd, tq.quantize_q8_1(ff))
    assert torch.equal(got, want)


@pytest.mark.parametrize("m", [16, 48, 100])
def test_gemm_dequant(weight, dev, m):
    a = registry.fold_q8_1(tq.quantize_q8_1(_act(m, 4, dev)))
    got, ref = gemm_dequant(weight, a), gemm_dequant_plain(weight, a)
    assert ((got - ref) ** 2).sum() <= 1e-4 * (ref ** 2).sum()


def _kquant(qtype, n, k, dev, seed=21):
    g = torch.Generator(device=dev).manual_seed(seed)
    return kquants.random_blocks(qtype, n, k, k ** -0.5, g)


@pytest.mark.parametrize("k", [1024, 2048, 5632, 14336])
@pytest.mark.parametrize("m", [1, 8, 12])
@pytest.mark.parametrize("qtype", ["q6_K", "q3_K", "q2_K"])
def test_gemm_exact_k16(dev, qtype, m, k):
    """K7 for each per-16 format against its plain version; N = 774
    leaves a ragged row tile.  Its output equals k1_order of its
    per-block terms bit for bit (the two sub-block terms of a 32-block
    added, then K1's order), so two calls give the same bits."""
    w = layout.prepare_k16(_kquant(qtype, 774, k, dev))
    x = np.random.default_rng(k + m).standard_normal((m, k))
    a = tq.quantize_q8_1(_t(x.astype(np.float32), dev))
    before = gemm_exact_k16.launches
    got, ref = gemm_exact_k16(w, a), gemm_exact_k16_plain(w, a)
    assert gemm_exact_k16.launches == before + 1
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert torch.equal(got, k1_order(k16_block_terms(w, a)))
    assert torch.equal(got, gemm_exact_k16(w, a))


@pytest.mark.parametrize("m", [1, 8, 12, 16, 100])
def test_q4_k_kernels(dev, m):
    """K1 (M <= 12) or K4 (M > 12) on a q4_K weight in its effective
    form, through dispatch."""
    w = layout.prepare(kquants.to_effective(_kquant("q4_K", 774, K, dev)))
    x = _act(m, 2, dev)
    got = registry.dispatch(w, x, quantize_act=True)
    ref = registry.dispatch(w, x, quantize_act=True, ops=registry.PLAIN)
    if m <= registry.DECODE_M_MAX:
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    else:
        assert ((got - ref) ** 2).sum() <= 1e-4 * (ref ** 2).sum()


FIXTURE = Path(__file__).parent / "golden" / "tiny_llama_q4km.gguf"
PROMPT_IDS = [0, 262, 312, 311, 292]  # tests/test_gguf_interop.py
GREEDY_CONT = [252, 44, 79, 306, 79, 306]


def test_load_llama_fixture_on_the_card(dev):
    """The foreign Q4_K_M file decodes on the card to what it decodes to
    on the CPU, and its greedy transcript runs through K1, K3, K4 and K7
    (the fixture's prompt is 5 tokens: the dense prefill path)."""
    qp, cfg = gguf_loader.load_llama(FIXTURE, device=dev)
    qc, _ = gguf_loader.load_llama(FIXTURE, device="cpu")
    for a, b in zip(qp["layers"], qc["layers"]):
        for name in ("wqkv", "wo", "wgu", "w_down"):
            pa = getattr(a[name], "parts", (a[name],))
            pb = getattr(b[name], "parts", (b[name],))
            for x, y in zip(pa, pb):
                assert type(x) is type(y) and x.qtype == y.qtype
                assert all(torch.equal(u.cpu(), v) for u, v in zip(x, y)
                           if isinstance(u, torch.Tensor))
    assert qp["lm_head"].qtype == "q6_k"
    # the pinned transcript teacher-forced: at every step its token is the
    # argmax, or (a near-tie broken the other way by another float32
    # summation order) within 2 * 2e-2 * max|logits| of it
    before = (gemm_exact.launches, gemm_exact_k16.launches)
    cache = llama.KVCache.init(cfg, 1, device=dev)
    feed = [PROMPT_IDS] + [[t] for t in GREEDY_CONT]
    for i, toks in enumerate(feed[:-1]):
        logits, cache = llama.forward(qp, cfg, torch.tensor([toks],
                                                            device=dev), cache)
        last = logits[0, -1]
        slack = float(last.max() - last[GREEDY_CONT[i]])
        assert slack <= 4e-2 * float(last.abs().max()), (i, slack)
    # per forward (M <= 12: prefill of 5 tokens too): layer 0 fused q4_k
    # wqkv, wo, wgu, w_down on K1; layer 1 q4_k q and k, wo, wgu, w_down on
    # K1, its q6_K attn_v and the q6_K lm_head on K7
    assert gemm_exact.launches - before[0] == len(GREEDY_CONT) * 9
    assert gemm_exact_k16.launches - before[1] == len(GREEDY_CONT) * 2


def _int8_cache(rng, shape, dev):
    codes = [_t(rng.integers(-127, 128, shape).astype(np.int8), dev)
             for _ in range(2)]
    scales = [_t(rng.uniform(0.005, 0.03, shape[:-1]).astype(np.float32),
                 dev) for _ in range(2)]
    return codes, dict(k_scale=scales[0], v_scale=scales[1])


@pytest.mark.parametrize("quant, window", [(False, 0), (True, 0),
                                           (False, 40), (True, 40)])
@pytest.mark.parametrize("hd, rep", [(64, 8), (128, 4)])
def test_flash_decode(dev, hd, rep, quant, window):
    """Stacked cache via layer=, GQA, ragged positions including 0 (only
    the current token) and a stale position past the cache end; bf16 or
    int8 cache, full causal or a window of 40 (not a tile multiple)."""
    rng = np.random.default_rng(5)
    b, kv, s, layers = 5, 2, 300, 3

    def f(*shape):
        return _t(rng.standard_normal(shape).astype(np.float32), dev)

    q = f(b, kv, rep, hd)
    shape = (layers, b, kv, s, hd)
    if quant:
        (kc, vc), kw = _int8_cache(rng, shape, dev)
    else:
        kc, vc, kw = f(*shape).to(torch.bfloat16), \
            f(*shape).to(torch.bfloat16), {}
    kw.update(k_current=f(b, kv, 1, hd).to(torch.bfloat16),
              v_current=f(b, kv, 1, hd).to(torch.bfloat16), layer=2,
              window=window)
    pos = torch.tensor([0, 31, 33, s - 1, 10_000], dtype=torch.int32,
                       device=dev)
    before = flash_decode.launches
    got = flash_decode(q, kc, vc, pos, **kw)
    ref = flash_decode_plain(q, kc, vc, pos, **kw)
    assert flash_decode.launches == before + 1
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 2e-3


@pytest.mark.parametrize("quant, window", [(False, 0), (True, 0),
                                           (False, 40), (True, 40)])
@pytest.mark.parametrize("hd, rep, t", [(64, 8, 72), (128, 4, 37)])
def test_flash_prefill(dev, hd, rep, t, quant, window):
    """Ragged start positions (a chunk that ends at the cache's last
    slot, one at 0), T * rep rows that do not divide the 64-row tile, the
    layer of a stacked cache, and a one-slot view of a wider cache read in
    place (the server's prefill)."""
    rng = np.random.default_rng(6)
    b, kv, s, layers = 3, 2, 300, 2
    q = _t(rng.standard_normal((b, kv, t * rep, hd)).astype(np.float32), dev)
    shape = (layers, b + 1, kv, s, hd)
    if quant:
        (kc, vc), kw = _int8_cache(rng, shape, dev)
    else:
        kc, vc = (_t(rng.standard_normal(shape).astype(np.float32),
                     dev).to(torch.bfloat16) for _ in range(2))
        kw = {}
    # slots 1..b of the wider cache: a strided view, as the server's
    kc, vc = kc[:, 1:], vc[:, 1:]
    kw = {n: x[:, 1:] for n, x in kw.items()}
    kw.update(rep=rep, window=window, layer=1)
    pos0 = torch.tensor([0, 113, s - t], dtype=torch.int32, device=dev)
    before = flash_prefill.launches
    got = flash_prefill(q, kc, vc, pos0, **kw)
    ref = flash_prefill_plain(q, kc, vc, pos0, **kw)
    assert flash_prefill.launches == before + 1
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 2e-3


@pytest.mark.parametrize("current", [True, False])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hd, rep", [(64, 8), (128, 4)])
def test_flash_decode_ring(dev, hd, rep, quant, current):
    """The ring form (R = 256 slots, window 200): positions before the
    wrap (0, 5, 199), at it (255, 256) and past it (300, 1000), with and
    without the current token as operands; the layer of a stacked cache
    with more slots than the ring (only the first R are attended)."""
    rng = np.random.default_rng(15)
    b, kv, ring, layers = 7, 2, 256, 2

    def f(*shape):
        return _t(rng.standard_normal(shape).astype(np.float32), dev)

    q = f(b, kv, rep, hd)
    shape = (layers, b, kv, ring + 32, hd)
    if quant:
        (kc, vc), kw = _int8_cache(rng, shape, dev)
    else:
        kc, vc, kw = f(*shape).to(torch.bfloat16), \
            f(*shape).to(torch.bfloat16), {}
    if current:
        kw.update(k_current=f(b, kv, 1, hd).to(torch.bfloat16),
                  v_current=f(b, kv, 1, hd).to(torch.bfloat16))
    kw.update(layer=1, window=200, ring=ring)
    pos = torch.tensor([0, 5, 199, 255, 256, 300, 1000], dtype=torch.int32,
                       device=dev)
    before = flash_decode.launches
    got = flash_decode(q, kc, vc, pos, **kw)
    ref = flash_decode_plain(q, kc, vc, pos, **kw)
    assert flash_decode.launches == before + 1
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 2e-3


def _decode_case(dev, hd, rep, quant, window, ring, current, seed):
    """The inputs of test_flash_decode (ring = 0) or
    test_flash_decode_ring, as (q, k, v, pos, kwargs, slots)."""
    rng = np.random.default_rng(seed)
    b, kv, layers = (7, 2, 2) if ring else (5, 2, 3)
    s = ring + 32 if ring else 300

    def f(*shape):
        return _t(rng.standard_normal(shape).astype(np.float32), dev)

    q = f(b, kv, rep, hd)
    shape = (layers, b, kv, s, hd)
    if quant:
        (kc, vc), kw = _int8_cache(rng, shape, dev)
    else:
        kc, vc, kw = f(*shape).to(torch.bfloat16), \
            f(*shape).to(torch.bfloat16), {}
    if current:
        kw.update(k_current=f(b, kv, 1, hd).to(torch.bfloat16),
                  v_current=f(b, kv, 1, hd).to(torch.bfloat16))
    kw.update(layer=1, window=window, ring=ring)
    pos = [0, 5, 199, 255, 256, 300, 1000] if ring else \
        [0, 31, 33, s - 1, 10_000]
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    return q, kc, vc, pos, kw, ring or s


@pytest.mark.parametrize("pieces", ["chosen", "one", "most"])
@pytest.mark.parametrize("quant, window, ring, current",
                         [(False, 0, 0, True), (True, 0, 0, True),
                          (False, 40, 0, True), (True, 40, 0, True),
                          (False, 200, 256, True), (True, 200, 256, True),
                          (False, 200, 256, False), (True, 200, 256, False)])
@pytest.mark.parametrize("hd, rep", [(64, 8), (128, 4)])
def test_flash_decode_split(dev, hd, rep, quant, window, ring, current,
                            pieces):
    """K3 split over the walk: the linear and ring parametrisations above
    with the piece count the wrapper picks, forced to 1 and to its most
    (one tile a piece); within 2e-3 of plain, two calls bit-equal."""
    q, kc, vc, pos, kw, slots = _decode_case(dev, hd, rep, quant, window,
                                             ring, current, 25)
    ns = {"chosen": None, "one": 1,
          "most": decode_max_pieces(window, slots)}[pieces]
    before = flash_decode.launches
    got = flash_decode(q, kc, vc, pos, pieces=ns, **kw)
    assert flash_decode.launches == before + 1
    if ns is not None:
        assert flash_decode.last_pieces == ns
    ref = flash_decode_plain(q, kc, vc, pos, **kw)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 2e-3
    assert torch.equal(got, flash_decode(q, kc, vc, pos, pieces=ns, **kw))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hd, rep, t", [(64, 8, 72), (128, 4, 37)])
def test_flash_prefill_ring(dev, hd, rep, t, quant):
    """The ring form (R = 256, window 100): chunks straddling the ring's
    edge (pos0 220), at its start (0) and past the wrap (400), T * rep
    rows that do not divide the 64-row tile, a one-slot-strided view of a
    wider stacked cache."""
    rng = np.random.default_rng(16)
    b, kv, ring, layers = 3, 2, 256, 2
    q = _t(rng.standard_normal((b, kv, t * rep, hd)).astype(np.float32), dev)
    shape = (layers, b + 1, kv, ring, hd)
    if quant:
        (kc, vc), kw = _int8_cache(rng, shape, dev)
    else:
        kc, vc = (_t(rng.standard_normal(shape).astype(np.float32),
                     dev).to(torch.bfloat16) for _ in range(2))
        kw = {}
    kc, vc = kc[:, 1:], vc[:, 1:]
    kw = {n: x[:, 1:] for n, x in kw.items()}
    kw.update(rep=rep, window=100, ring=ring, layer=0)
    pos0 = torch.tensor([220, 0, 400], dtype=torch.int32, device=dev)
    before = flash_prefill.launches
    got = flash_prefill(q, kc, vc, pos0, **kw)
    ref = flash_prefill_plain(q, kc, vc, pos0, **kw)
    assert flash_prefill.launches == before + 1
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 2e-3


@pytest.mark.parametrize("qtype", ["bf16", "q8"])
def test_ring_forward_through_kernels(dev, qtype):
    """A ring model (window 48, ring_chunk 64, R = 128): a 64-token chunk
    straddling the ring's edge (K5 at pos0 100) and a decode step past the
    wrap, each layer through the kernels and the plain versions from the
    same hidden state (update and logits NMSE <= 1e-4)."""
    cfg = llama.LlamaConfig(vocab=256, dim=512, n_layers=2, n_heads=8,
                            n_kv_heads=2, d_ff=1024, max_seq=512, window=48,
                            ring=True, ring_chunk=64)
    qp = llama.init_qparams(cfg, seed=1, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    cache = llama.KVCache.init(cfg, 2, qtype, device=dev)
    assert cache.k.shape[3] == cfg.ring_capacity == 128
    for t in (64, 36):
        llama.forward(qp, cfg, torch.randint(0, 256, (2, t), device=dev,
                                             generator=g), cache)

    def nmse(got, ref):
        return ((got - ref) ** 2).sum() / (ref ** 2).sum()

    before = (flash_prefill.launches, flash_decode.launches)
    for t in (64, 1):
        tokens = torch.randint(0, 256, (2, t), device=dev, generator=g)
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
    assert cache.pos.tolist() == [165, 165]
    assert (flash_prefill.launches, flash_decode.launches) == (
        before[0] + cfg.n_layers, before[1] + cfg.n_layers)


@pytest.mark.parametrize("qtype, window", [("bf16", 0), ("q8", 0),
                                           ("bf16", 24)])
def test_model_and_server_through_kernels(dev, qtype, window):
    """Prefill chunks on the dense path (T = 48) and through K5 (T = 64),
    then a decode step, each layer through the kernels and the plain
    versions from the same hidden state; then the default Server (chunk
    128, prompt caching) through the kernels, reusing a prefix."""
    cfg = llama.LlamaConfig(vocab=256, dim=512, n_layers=2, n_heads=8,
                            n_kv_heads=2, d_ff=1024, max_seq=256,
                            window=window)
    qp = llama.init_qparams(cfg, seed=1, device=dev)
    toks = torch.randint(0, 256, (2, 112), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))

    def nmse(got, ref):
        return ((got - ref) ** 2).sum() / (ref ** 2).sum()

    cache = llama.KVCache.init(cfg, 2, qtype, device=dev)
    before = flash_prefill.launches
    for tokens in (toks[:, :48], toks[:, 48:], toks[:, :1]):
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
    assert flash_prefill.launches == before + cfg.n_layers
    srv = serve.Server(qp, cfg, n_slots=2, cache_qtype=qtype, device=dev)
    prompt = list(range(1, 101))
    rids = [srv.submit(prompt, max_new=5), srv.submit([7, 8, 9], max_new=3)]
    res = srv.run_until_done()
    rids.append(srv.submit(prompt + res[rids[0]][:4] + [5], max_new=4))
    res = srv.run_until_done()
    assert [len(res[r]) for r in rids] == [5, 3, 4]
    assert all(0 <= t < 256 for r in rids for t in res[r])
    assert srv.stats()["cached_prompt_tokens"] == 104


@pytest.mark.parametrize("fused, tail", [(True, False), (False, True),
                                         (True, True)])
def test_fused_decode_through_kernels(dev, monkeypatch, fused, tail):
    """A decode step with the switches of the JAX package set: every
    layer through the kernels (K6 and/or K8) and through the plain
    versions from the same hidden state, each layer's update and the
    logits NMSE <= 1e-4; the switches route every GEMM as the JAX
    package does (K1 never runs with FUSED_DECODE)."""
    monkeypatch.setattr(registry, "FUSED_DECODE", fused)
    monkeypatch.setattr(gemm_megalayer, "ENABLE_TAIL", tail)
    cfg = llama.LlamaConfig(vocab=256, dim=512, n_layers=2, n_heads=8,
                            n_kv_heads=2, d_ff=1024, max_seq=128)
    qp = llama.init_qparams(cfg, seed=1, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    cache = llama.KVCache.init(cfg, 3, device=dev)
    llama.forward(qp, cfg, torch.randint(0, 256, (3, 20), device=dev,
                                         generator=g), cache)
    tokens = torch.randint(0, 256, (3, 1), device=dev, generator=g)

    def nmse(got, ref):
        return ((got - ref) ** 2).sum() / (ref ** 2).sum()

    kernels = registry.KERNELS
    before = {n: f.launches for n, f in kernels._asdict().items()}
    cache_p = cache.clone()
    x, step = llama.begin(qp, cfg, tokens, cache)
    assert step.use_mega_tail == tail
    for li, lyr in enumerate(qp["layers"]):
        xk, _ = llama.layer(lyr, li, cfg, x, cache, step)
        xp, _ = llama.layer(lyr, li, cfg, x, cache_p, step, registry.PLAIN)
        assert nmse(xk - x, xp - x) <= 1e-4
        x = xk
    assert nmse(llama.head(qp, cfg, x),
                llama.head(qp, cfg, x, registry.PLAIN)) <= 1e-4
    n = {k: f.launches - before[k] for k, f in kernels._asdict().items()}
    layers = cfg.n_layers
    assert n["attn_tail"] == (layers if tail else 0)
    assert n["gemm_exact_fused"] == (1 + (0 if tail else 3 * layers)
                                     if fused else 0)
    assert n["gemm_exact"] == (0 if fused else 1 + (0 if tail else
                                                    3 * layers))
    assert n["norm_qkv"] == n["flash_decode"] == layers


# --- slice 6: the per-32 forms of K1 and K4, K9, K10, the spec runner ---

NEW32 = ["q4_1", "q5_0", "q5_1", "q8_0"]


def _weight32(qtype, k, dev, seed=41, rows=N):
    w = np.random.default_rng(seed).normal(0, 0.05, (rows, k)).astype(
        np.float32)
    return layout.prepare(tq.QUANTIZE[qtype](_t(w, dev)))


@pytest.mark.parametrize("k", [1024, 1056, 14336])
@pytest.mark.parametrize("m", [1, 8, 12])
@pytest.mark.parametrize("qtype", NEW32)
def test_gemm_exact_new_forms(dev, qtype, m, k):
    """K1's q4_1 / q5_0 / q5_1 / q8_0 epilogues, K % 64 == 32 included."""
    w = _weight32(qtype, k, dev)
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    a = tq.quantize_q8_1(_t(x, dev))
    before = gemm_exact.launches
    got, ref = gemm_exact(w, a), gemm_exact_plain(w, a)
    assert gemm_exact.launches == before + 1
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("k", [1024, 1056, 14336])
@pytest.mark.parametrize("m", [1, 8, 12, 128])
@pytest.mark.parametrize("adt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("qtype", NEW32 + ["q4_0"])
def test_gemm_dequant_new_forms(dev, qtype, adt, m, k):
    """K4's new weight forms and its float32-activation form, at the
    decode rows, a prefill chunk's, and K % 64 == 32."""
    w = _weight32(qtype, k, dev)
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    a = _t(x, dev).to(adt)
    before = gemm_dequant.launches
    got, ref = gemm_dequant(w, a), gemm_dequant_plain(w, a)
    assert gemm_dequant.launches == before + 1
    assert ((got - ref) ** 2).sum() <= 1e-4 * (ref ** 2).sum()


@pytest.mark.parametrize("qtype", ["q4_0", "q4_k"])
def test_k2_and_k6_at_k_1056(dev, qtype):
    """K % 64 == 32 through K2 (q4_0) and K6, which stays bit-equal to
    quantize_q8_1 + K1; q4_k as the effective form of q4_1's blocks (a
    q4_K tensor itself needs K % 256)."""
    k = 1056
    w = _weight32("q4_0" if qtype == "q4_0" else "q4_1", k, dev)
    if qtype == "q4_k":
        w = w._replace(qtype="q4_k", d=w.d.float(), m=w.m.float())
    x = _t((np.random.default_rng(5).standard_normal((8, k)) * 2).astype(
        np.float32), dev)
    got = gemm_exact_fused(w, x)
    assert torch.equal(got, gemm_exact(w, tq.quantize_q8_1(x)))
    ref = gemm_exact_fused_plain(w, x)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    if qtype == "q4_0":
        nw = _t(np.random.default_rng(6).normal(1, .1, k).astype(np.float32),
                dev)
        got, ref = norm_qkv(w, x, nw, EPS), norm_qkv_plain(w, x, nw, EPS)
        assert (got - ref).abs().max() <= 2e-3 * ref.abs().max()


ROWS = [(8, 4096), (5, 1000), (300, 1001), (3, 32000), (7, 33), (4096, 4608)]


def _unaligned(r, c, dev, seed):
    """[r, c] float32 starting 4 bytes past a 16-byte boundary (the
    kernels need no alignment)."""
    x = torch.randn(r * c + 1, generator=torch.Generator(device=dev)
                    .manual_seed(seed), device=dev)
    return x[1:].view(r, c)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("r, c", ROWS)
def test_rms_norm_pallas(dev, r, c, aligned):
    x = _unaligned(r, c, dev, 1) if not aligned else torch.randn(
        r, c, generator=torch.Generator(device=dev).manual_seed(1),
        device=dev)
    w = 0.5 + torch.rand(c, generator=torch.Generator(device=dev)
                         .manual_seed(2), device=dev)
    before = rms_norm_pallas.launches
    got, ref = rms_norm_pallas(x, w, EPS), rms_norm_pallas_plain(x, w, EPS)
    assert rms_norm_pallas.launches == before + 1
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("r, c", ROWS)
def test_softmax_pallas(dev, r, c, aligned):
    x = 4.0 * (_unaligned(r, c, dev, 3) if not aligned else torch.randn(
        r, c, generator=torch.Generator(device=dev).manual_seed(3),
        device=dev))
    before = softmax_pallas.launches
    got, ref = softmax_pallas(x), softmax_pallas_plain(x)
    assert softmax_pallas.launches == before + 1
    assert (got - ref).abs().max() <= 1e-6
    assert torch.allclose(got.sum(-1), torch.ones(r, device=dev), atol=1e-5)


@pytest.mark.parametrize("path", spec_runner.definitions(),
                         ids=lambda p: p.stem)
def test_spec_on_the_card(dev, path):
    """Every committed definition through the kernels on the card; a gemm
    definition under every ladder rung its activation takes, at its own
    K and at K = 1056."""
    r = spec_runner.run_spec(path)
    assert r.passed, r.row()
    d = spec_runner.load(path)
    if d["op_type"] != "gemm_quant":
        return
    rungs = ["pallas_f32", "pallas_bf16", "pallas", "xla_dequant"]
    if d["inputs"]["A"]["dtype"] == "q8_1":
        rungs += ["pallas_exact", "xla_int", "xla_compensated"]
    else:
        rungs += ["pallas_fused_quant"]
    for impl in rungs:
        for params in (None, {"M": 8, "K": 1056}):
            r = spec_runner.run_spec(path, impl=impl, params=params)
            assert r.passed, (impl, params, r.row())


# -- slice 7: K2's min and qh planes, K1/K4 on q5_k, K4's fused_quant ----

K2_NEW = ["q4_1", "q4_k", "q5_0", "q5_1", "q5_k"]
ALL32 = ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "q4_k", "q5_k"]


def _weight_any(qtype, k, dev, seed=41, rows=N):
    """A per-32 weight of any form: q4_k / q5_k as the effective form of
    q4_1 / q5_1 blocks with float32 planes (a K-quant tensor itself
    needs K % 256 == 0; the kernels take any K % 32 == 0)."""
    base = {"q4_k": "q4_1", "q5_k": "q5_1"}.get(qtype, qtype)
    w = _weight32(base, k, dev, seed, rows)
    if base != qtype:
        w = w._replace(qtype=qtype, d=w.d.float(), m=w.m.float())
    return w


@pytest.mark.parametrize("k", [1024, 1056])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("qtype", K2_NEW)
def test_norm_qkv_new_forms(dev, qtype, m, k):
    """K2 with the min plane (q4_1, q4_k, q5_1, q5_k) and the qh plane
    (q5_0, q5_1, q5_k) against its plain chain (``2e-3 * max|C|``), K %
    64 == 32 included."""
    w = _weight_any(qtype, k, dev)
    x = _t((np.random.default_rng(m).standard_normal((m, k)) * 3).astype(
        np.float32), dev)
    nw = _t(np.random.default_rng(6).normal(1, .1, k).astype(np.float32),
            dev)
    before = norm_qkv.launches
    got, ref = norm_qkv(w, x, nw, EPS), norm_qkv_plain(w, x, nw, EPS)
    assert norm_qkv.launches == before + 1
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 2e-3 * ref.abs().max()


@pytest.mark.parametrize("k", [1024, 14336])
@pytest.mark.parametrize("m", [1, 8, 12])
def test_gemm_exact_q5_k(dev, m, k):
    """K1 on a q5_K tensor's effective form (random valid blocks),
    ``1e-5 * max|C|`` as q4_k."""
    w = layout.prepare(kquants.to_effective_q5_k(_kquant("q5_K", N, k, dev)))
    assert w.qtype == "q5_k" and w.d.dtype == torch.float32
    a = tq.quantize_q8_1(_t(np.random.default_rng(m).standard_normal(
        (m, k)).astype(np.float32), dev))
    before = gemm_exact.launches
    got, ref = gemm_exact(w, a), gemm_exact_plain(w, a)
    assert gemm_exact.launches == before + 1
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("k", [1024, 1056, 14336])
@pytest.mark.parametrize("m", [1, 128])
@pytest.mark.parametrize("adt", [torch.bfloat16, torch.float32])
def test_gemm_dequant_q5_k(dev, adt, m, k):
    """K4 on q5_k, NMSE <= 1e-4; K = 1056 through the effective form of
    q5_1 blocks."""
    if k % 256:
        w = _weight_any("q5_k", k, dev)
    else:
        w = layout.prepare(kquants.to_effective_q5_k(
            _kquant("q5_K", N, k, dev)))
    a = _t(np.random.default_rng(m).standard_normal((m, k)).astype(
        np.float32), dev).to(adt)
    before = gemm_dequant.launches
    got, ref = gemm_dequant(w, a), gemm_dequant_plain(w, a)
    assert gemm_dequant.launches == before + 1
    assert ((got - ref) ** 2).sum() <= 1e-4 * (ref ** 2).sum()


@pytest.mark.parametrize("k", [1024, 1056])
@pytest.mark.parametrize("m", [1, 128])
@pytest.mark.parametrize("a_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("qtype", ALL32)
def test_gemm_dequant_fused_quant(dev, qtype, a_dtype, m, k):
    """K4 with the activation fake-quantized in the kernel (JAX's
    ``_fake_quant_q8``), every per-32 form, bf16 and float32 operands,
    against its plain version (NMSE <= ``FQ_NMSE``), degenerate blocks
    included."""
    w = _weight_any(qtype, k, dev)
    x = _degenerate(_t(np.random.default_rng(m).standard_normal(
        (m, k)).astype(np.float32), dev))
    x[:, -32:] *= 1e-3  # a block far below the others
    before = gemm_dequant.launches
    got = gemm_dequant(w, x, fused_quant=True, a_dtype=a_dtype)
    assert gemm_dequant.launches == before + 1
    ref = gemm_dequant_plain(w, x, fused_quant=True, a_dtype=a_dtype)
    assert torch.isfinite(got).all()
    assert ((got - ref) ** 2).sum() <= FQ_NMSE * (ref ** 2).sum()


@pytest.mark.parametrize("a_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_fused_quant_prologue_bit_exact(dev, xdt, a_dtype):
    """K4's in-kernel fake quantization equals ``fake_quant_q8`` bit for
    bit: through a q8_0 identity weight (code 1, d = 1 on the diagonal)
    every output is one product a' * 1 plus zeros, so out = a'."""
    k = 1024
    qs = torch.eye(k, dtype=torch.int8, device=dev)
    eye = layout.PreparedWeight("q8_0", k, k, qs, torch.ones(
        k, k // 32, dtype=torch.float16, device=dev))
    x = _degenerate(torch.randn(8, k, generator=torch.Generator(
        device=dev).manual_seed(9), device=dev) * 4).to(xdt)
    got = gemm_dequant(eye, x, fused_quant=True, a_dtype=a_dtype)
    want = fake_quant_q8(x).to(a_dtype).float()
    assert torch.equal(got, want)


def test_pallas_fused_quant_rung(dev):
    """The ladder rung runs K4 with fused_quant on a planar container."""
    w = tq.quantize_q4_0(_t(np.random.default_rng(2).normal(
        0, 0.05, (N, K)).astype(np.float32), dev))
    x = _act(16, 4, dev)
    before = gemm_dequant.launches
    got = registry.LADDER["pallas_fused_quant"](w, x)
    assert gemm_dequant.launches == before + 1
    ref = gemm_dequant_plain(layout.prepare(w), x, fused_quant=True)
    assert ((got - ref) ** 2).sum() <= FQ_NMSE * (ref ** 2).sum()


@pytest.mark.parametrize("qtype", sorted(tq.QUANTIZE))
def test_quantizers_on_the_card_bit_equal_to_cpu(dev, qtype):
    """The torch quantizers give the same bits on the card as on the CPU
    (where they equal numpy's) over 2^20 blocks: their scale divisions
    take the IEEE quotient there too (``quant.div``), so a scale at an
    f16 rounding tie rounds the same way."""
    x = torch.randn(4096, 8192, generator=torch.Generator().manual_seed(3))
    got = tq.QUANTIZE[qtype](x.to(dev))
    want = tq.QUANTIZE[qtype](x)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


# --- the tensor-core prefill kernels: K4's bf16 forms and K5 ---


@pytest.mark.parametrize("qtype", ALL32)
def test_gemm_dequant_deterministic(dev, qtype):
    """Two launches at the prefill chunk (M = 128, K split into pieces
    at this N) give the same bits, bf16 and fused_quant bf16."""
    w = _weight_any(qtype, K, dev)
    x = _t(np.random.default_rng(3).standard_normal((128, K)).astype(
        np.float32), dev)
    a = x.to(torch.bfloat16)
    assert torch.equal(gemm_dequant(w, a), gemm_dequant(w, a))
    assert torch.equal(gemm_dequant(w, x, fused_quant=True),
                       gemm_dequant(w, x, fused_quant=True))


@pytest.mark.parametrize("fq", [False, True])
@pytest.mark.parametrize("m", [13, 100, 300])
@pytest.mark.parametrize("qtype", ALL32)
def test_gemm_dequant_ragged(dev, qtype, m, fq):
    """Ragged rows, N = 2560 + 96 (no multiple of the 64-wide tile) and
    K = 1056 (K % 64 == 32), bf16 operands: NMSE <= FQ_NMSE."""
    n, k = 2560 + 96, 1056
    base = {"q4_k": "q4_1", "q5_k": "q5_1"}.get(qtype, qtype)
    wf = np.random.default_rng(8).normal(0, 0.05, (n, k)).astype(np.float32)
    w = layout.prepare(tq.QUANTIZE[base](_t(wf, dev)))
    if base != qtype:
        w = w._replace(qtype=qtype, d=w.d.float(), m=w.m.float())
    x = _t(np.random.default_rng(m).standard_normal((m, k)).astype(
        np.float32), dev)
    a = x if fq else x.to(torch.bfloat16)
    before = gemm_dequant.launches
    got = gemm_dequant(w, a, fused_quant=fq)
    assert gemm_dequant.launches == before + 1
    ref = gemm_dequant_plain(w, a, fused_quant=fq)
    assert torch.isfinite(got).all()
    assert ((got - ref) ** 2).sum() <= FQ_NMSE * (ref ** 2).sum()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("p0", [0, 4000, 4544])
def test_flash_prefill_split_s_mistral_ring(dev, p0, quant):
    """K5 at full Mistral-7B ring width, one layer: KV 8, rep 4, hd 128,
    R 4608, window 4096, a 128-token chunk at pos0 0 (most pieces
    empty), 4000 and 4544 (across the ring's edge); max|err| <= 2e-3,
    and two calls bit-equal."""
    rng = np.random.default_rng(p0 + 1)
    kv, rep, hd, ring, t = 8, 4, 128, 4608, 128
    q = _t(rng.standard_normal((1, kv, t * rep, hd)).astype(np.float32), dev)
    shape = (1, kv, ring, hd)
    if quant:
        (kc, vc), kw = _int8_cache(rng, shape, dev)
    else:
        kc, vc = (_t(rng.standard_normal(shape).astype(np.float32),
                     dev).to(torch.bfloat16) for _ in range(2))
        kw = {}
    kw.update(rep=rep, window=4096, ring=ring)
    pos0 = torch.tensor([p0], dtype=torch.int32, device=dev)
    before = flash_prefill.launches
    got = flash_prefill(q, kc, vc, pos0, **kw)
    assert flash_prefill.launches == before + 1
    ref = flash_prefill_plain(q, kc, vc, pos0, **kw)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 2e-3
    assert torch.equal(got, flash_prefill(q, kc, vc, pos0, **kw))


# --- slice 9: K1 on the int8 tensor cores keeps its summation order ---

ALL_FORMS = ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "q4_k", "q5_k"]


@pytest.mark.parametrize("k", [1056, 2048, 5632, 14336])
@pytest.mark.parametrize("m", [1, 8, 12])
@pytest.mark.parametrize("qtype", ALL_FORMS)
def test_gemm_exact_k1_order_bit_exact(dev, qtype, m, k):
    """K1's output equals k1_order of the plain version's per-block
    terms, bit for bit: the old kernel's order, which K6 and K8 keep.
    q4_k and q5_k as the effective forms of q4_1's and q5_1's blocks (a
    K-quant tensor itself needs K % 256); N = 774 leaves a ragged row
    tile."""
    base = {"q4_k": "q4_1", "q5_k": "q5_1"}.get(qtype, qtype)
    wf = np.random.default_rng(k + m).normal(0, 0.05, (774, k))
    w = layout.prepare(tq.QUANTIZE[base](_t(wf.astype(np.float32), dev)))
    if base != qtype:
        w = w._replace(qtype=qtype, d=w.d.float(), m=w.m.float())
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    a = tq.quantize_q8_1(_t(x, dev))
    before = gemm_exact.launches
    got = gemm_exact(w, a)
    assert gemm_exact.launches == before + 1
    cpu = layout.PreparedWeight(*(t.cpu() if isinstance(t, torch.Tensor)
                                  else t for t in w))
    want = k1_order(block_terms(cpu, Q8_1Tensor(*(t.cpu() for t in a))))
    assert torch.equal(got.cpu(), want)


# --- K2 and K6 on K1's body, captured in a CUDA graph ---


def test_k2_and_k6_replay_in_a_cuda_graph(dev):
    """K2 and K6 read nothing on the host and allocate only their output
    at launch, so a CUDA graph captures them: replays over new inputs
    copied into the captured buffers equal eager calls bit for bit."""
    g = torch.Generator(device=dev).manual_seed(53)
    k, m = 2048, 8
    wqkv = _weight_any("q5_1", k, dev, rows=2560)
    wgu = layout.prepare(tq.quantize_q4_0(
        torch.randn(1024, k, generator=g, device=dev) * k ** -0.5))
    x = torch.randn(m, k, generator=g, device=dev)
    nw = 1.0 + 0.1 * torch.randn(k, generator=g, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # first launches: the occupancy queries
        norm_qkv(wqkv, x, nw, EPS)
        gemm_exact_fused(wgu, x)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (norm_qkv.launches, gemm_exact_fused.launches)
    with torch.cuda.graph(graph):
        qkv = norm_qkv(wqkv, x, nw, EPS)
        gu = gemm_exact_fused(wgu, qkv[:, :k].contiguous())
    assert (norm_qkv.launches, gemm_exact_fused.launches) == (
        before[0] + 1, before[1] + 1)
    for scale in (1.0, 3.0):
        x.copy_(scale * torch.randn(m, k, generator=g, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        want = norm_qkv(wqkv, x, nw, EPS)
        assert torch.equal(qkv, want)
        assert torch.equal(gu, gemm_exact_fused(wgu, want[:, :k]
                                                .contiguous()))


# --- K7 and K8 on K1's body: captured in a CUDA graph; RMSNorm's bits ---


def test_k7_and_k8_replay_in_a_cuda_graph(dev):
    """K7 and K8 (a cooperative launch of clusters with two grid
    barriers; its scratch allocated by the wrapper) read nothing on the
    host, so a CUDA graph captures them: replays over new inputs copied
    into the captured buffers equal eager calls bit for bit."""
    g = torch.Generator(device=dev).manual_seed(59)
    m, dim, dff = 8, 2048, 5632
    wo, wgu, wd = _tail_weights(dim, dff, g, dev)
    w16 = layout.prepare_k16(_kquant("q6_K", 2048, dff, dev))
    attn = torch.randn(m, dim, generator=g, device=dev)
    x = torch.randn(m, dim, generator=g, device=dev)
    nw = 1.0 + 0.1 * torch.randn(dim, generator=g, device=dev)
    a = tq.quantize_q8_1(torch.randn(m, dff, generator=g, device=dev))
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # first launches: the occupancy queries
        attn_tail(attn, x, nw, wo, wgu, wd, EPS, dff)
        gemm_exact_k16(w16, a)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (attn_tail.launches, gemm_exact_k16.launches)
    with torch.cuda.graph(graph):
        out = attn_tail(attn, x, nw, wo, wgu, wd, EPS, dff)
        c = gemm_exact_k16(w16, a)
    assert (attn_tail.launches, gemm_exact_k16.launches) == (
        before[0] + 1, before[1] + 1)
    for scale in (1.0, 3.0):
        attn.copy_(scale * torch.randn(m, dim, generator=g, device=dev))
        x.copy_(torch.randn(m, dim, generator=g, device=dev))
        new = tq.quantize_q8_1(scale * torch.randn(m, dff, generator=g,
                                                   device=dev))
        for t, v in zip(a, new):
            t.copy_(v)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, attn_tail(attn, x, nw, wo, wgu, wd, EPS,
                                          dff))
        assert torch.equal(c, gemm_exact_k16(w16, a))


@pytest.mark.parametrize("c", [1056, 2560, 5632])
def test_rms_norm_on_the_card_bit_equal_to_cpu(dev, c):
    """ops/rms_norm.py's rms_norm and rms_norm_pallas_plain on the card
    equal the CPU's bits at widths whose 1/C is not a float32 value.  The
    rows hold multiples of 1/8 below 4, so every sum of squares is exact
    in any order and only the division by C and the rsqrt can differ."""
    rng = np.random.default_rng(c)
    x = (rng.integers(-31, 32, (8, c)) / 8.0).astype(np.float32)
    w = rng.standard_normal(c).astype(np.float32)
    xc, wc = torch.from_numpy(x), torch.from_numpy(w)
    for fn in (rms_norm, rms_norm_pallas_plain):
        got = fn(_t(x, dev), _t(w, dev), EPS).cpu()
        assert torch.equal(got, fn(xc, wc, EPS)), fn.__name__


# --- the activation quantizers as hand launches; the captured Server ---


def _edge_rows(m, k, seed):
    """float32 [m, k]: normal rows, with per row one all-zero block, one
    block of .5 ties (amax 127, so d = 1 and the codes land on halves)
    and one whose amax / 127 saturates f16 (and its sum with it)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    nb = k // 32
    for r in range(m):
        b0, b1, b2 = (3 * r) % nb, (3 * r + 1) % nb, (3 * r + 2) % nb
        x[r, 32 * b0:32 * b0 + 32] = 0.0
        ties = rng.integers(-120, 120, 32) + 0.5
        ties[rng.integers(0, 32)] = 127.0
        x[r, 32 * b1:32 * b1 + 32] = ties
        x[r, 32 * b2:32 * b2 + 32] = np.abs(rng.standard_normal(32)) * 1e7
    return x


@pytest.mark.parametrize("k", [2048, 4096, 5632, 14336])
@pytest.mark.parametrize("m", [1, 8, 128])
def test_act_quant_on_the_card_bit_equal_to_cpu(dev, m, k):
    """``act_quant.quantize_q8_1`` (codes, d, s) and ``quantize_fold_q8_1``
    (bf16 ``qs * d``) on the card equal the torch twins on the CPU bit for
    bit, at .5 ties, on all-zero blocks and where the f16 scale and sum
    saturate; one launch each."""
    x = _edge_rows(m, k, seed=m + k)
    xc = torch.from_numpy(x)
    before = (act_quant.quantize_q8_1.launches,
              act_quant.quantize_fold_q8_1.launches)
    got = act_quant.quantize_q8_1(_t(x, dev))
    fold = act_quant.quantize_fold_q8_1(_t(x, dev))
    assert (act_quant.quantize_q8_1.launches,
            act_quant.quantize_fold_q8_1.launches) == (before[0] + 1,
                                                       before[1] + 1)
    want = tq.quantize_q8_1(xc)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(fold.cpu(), registry.fold_q8_1(want))


@pytest.mark.parametrize("m, route", [(8, "quantize_q8_1"),
                                      (128, "quantize_fold_q8_1")])
def test_dispatch_quantizes_with_one_launch(weight, dev, m, route):
    """On CUDA tensors ``dispatch`` quantizes a float activation with one
    launch (decode: codes for K1; prefill: the bf16 fold for K4), with
    the bits of the twin route; ``ops=PLAIN`` launches nothing."""
    x = _act(m, 61, dev)
    before = registry.counters()
    got = registry.dispatch(weight, x, quantize_act=True)
    moved = {k: v - before[k] for k, v in registry.counters().items()
             if v != before[k]}
    kernel = "gemm_exact" if m <= registry.DECODE_M_MAX else "gemm_dequant"
    assert moved == {route: 1, kernel: 1}
    a = tq.quantize_q8_1(x)
    want = (gemm_exact(weight, a) if kernel == "gemm_exact"
            else gemm_dequant(weight, registry.fold_q8_1(a)))
    assert torch.equal(got, want)
    before = registry.counters()
    plain = registry.dispatch(weight, x, quantize_act=True,
                              ops=registry.PLAIN)
    assert registry.counters() == before
    assert torch.isfinite(plain).all()


def test_k1_and_k3_replay_in_a_cuda_graph(dev):
    """K1 and K3 (split over the window, its merge) read nothing on the
    host, so a CUDA graph captures them with the activation quantize:
    replays over new inputs copied into the captured buffers equal eager
    calls bit for bit."""
    g = torch.Generator(device=dev).manual_seed(67)
    m, k = 8, 2048
    w = layout.prepare(tq.quantize_q4_0(
        torch.randn(1024, k, generator=g, device=dev) * k ** -0.5))
    x = torch.randn(m, k, generator=g, device=dev)
    b, kv, rep, hd, s, layers = 8, 4, 8, 64, 2048, 2
    q = torch.randn(b, kv, rep, hd, generator=g, device=dev)
    kc = torch.randn(layers, b, kv, s, hd, generator=g,
                     device=dev).to(torch.bfloat16)
    vc = torch.randn(layers, b, kv, s, hd, generator=g,
                     device=dev).to(torch.bfloat16)
    kcur = torch.randn(b, kv, 1, hd, generator=g,
                       device=dev).to(torch.bfloat16)
    pos = torch.full((b,), 600, dtype=torch.int32, device=dev)
    kw = dict(k_current=kcur, v_current=kcur, layer=1)

    def step():
        return (gemm_exact(w, act_quant.quantize_q8_1(x)),
                flash_decode(q, kc, vc, pos, **kw))

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # first launches outside the capture
        step()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (gemm_exact.launches, flash_decode.launches)
    with torch.cuda.graph(graph):
        c, o = step()
    assert flash_decode.last_pieces > 1
    assert (gemm_exact.launches, flash_decode.launches) == (
        before[0] + 1, before[1] + 1)
    for scale, p in ((1.0, 700), (3.0, 1900)):
        x.copy_(scale * torch.randn(m, k, generator=g, device=dev))
        q.copy_(torch.randn(b, kv, rep, hd, generator=g, device=dev))
        pos.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        want_c, want_o = step()
        assert torch.equal(c, want_c)
        assert torch.equal(o, want_o)


@pytest.mark.parametrize("qtype", ["bf16", "q8"])
@pytest.mark.parametrize("ring", [False, True])
def test_server_captured_equals_eager(dev, monkeypatch, qtype, ring):
    """A 2-layer Server replaying its decode steps and prefill chunks
    from CUDA graphs gives the transcripts of the same Server run
    eagerly (``serve.CUDA_GRAPHS = False``), token for token, on the
    linear cache (with prefix reuse) and on the ring; every decode graph
    is replayed, its launches per replay are those of an eager step, and
    the counters with ``replay_launches`` equal the eager run's."""
    cfg = llama.LlamaConfig(vocab=256, dim=512, n_layers=2, n_heads=8,
                            n_kv_heads=2, d_ff=1024, max_seq=256)
    if ring:
        cfg = cfg._replace(max_seq=1024, window=96, ring=True,
                           ring_chunk=64)
    qp = llama.init_qparams(cfg, seed=1, device=dev)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, 150 if ring else 100).tolist()
    prompts = [a, rng.integers(0, 256, 30).tolist(),
               a[:64] + rng.integers(0, 256, 20).tolist()]
    runs = {}
    for graphs in (False, True):
        monkeypatch.setattr(serve, "CUDA_GRAPHS", graphs)
        srv = serve.Server(qp, cfg, n_slots=2, cache_qtype=qtype,
                           device=dev)
        for p, n in zip(prompts, (6, 40, 5)):
            srv.submit(p, max_new=n)
        before = registry.counters()
        out = srv.run_until_done()
        ran = {k: v - before[k] + srv.replay_launches().get(k, 0)
               for k, v in registry.counters().items()}
        runs[graphs] = (out, srv, ran)
    (eager, se, ran_e), (captured, sc, ran_c) = runs[False], runs[True]
    assert captured == eager
    assert ran_c == ran_e
    assert se.graphs == {} and sc.graphs
    assert sc.stats()["cached_prompt_tokens"] == \
        se.stats()["cached_prompt_tokens"] == (0 if ring else 64)
    for key, g in sc.graphs.items():
        assert g.replays >= 1 or key[0] == "chunk", key
        layers = cfg.n_layers
        if key[0] == "decode":
            assert g.launches["flash_decode"] == layers
            assert g.launches["norm_qkv"] == layers
            assert g.launches["gemm_exact"] == \
                g.launches["quantize_q8_1"] == 3 * layers + 1
        else:
            assert g.launches["gemm_dequant"] == \
                g.launches["quantize_fold_q8_1"] == 4 * layers + 1


# --- K4's float32 operands as three bf16 pieces; K9/K10 on the row plan ---


@pytest.mark.parametrize("fq, xdt", [(False, torch.float32),
                                     (True, torch.float32),
                                     (True, torch.bfloat16)])
@pytest.mark.parametrize("m", [13, 100])
@pytest.mark.parametrize("qtype", ALL32)
def test_gemm_dequant_f32_operand(dev, qtype, m, fq, xdt):
    """A float32 operand (f32 A, or fused_quant into float32 from an f32
    or a bf16 A) on the tensor cores as three bf16 pieces, at ragged M, N
    = 2560 + 96 and K = 1056: NMSE <= FQ_NMSE (the pieces sum to the
    operand exactly, so only the float32 summation order differs), two
    calls bit-equal."""
    n, k = 2560 + 96, 1056
    w = _weight_any(qtype, k, dev, rows=n)
    x = _t(np.random.default_rng(m).standard_normal((m, k)).astype(
        np.float32), dev).to(xdt)
    run = (lambda: gemm_dequant(w, x, fused_quant=True,
                                a_dtype=torch.float32)) if fq else (
        lambda: gemm_dequant(w, x))
    before = gemm_dequant.launches
    got = run()
    assert gemm_dequant.launches == before + 1
    ref = gemm_dequant_plain(w, x, fused_quant=fq, a_dtype=torch.float32)
    assert torch.isfinite(got).all()
    assert ((got - ref) ** 2).sum() <= FQ_NMSE * (ref ** 2).sum()
    assert torch.equal(got, run())


@pytest.mark.parametrize("k", [1056, 4096])
def test_k4_split_through_identity(dev, k):
    """Through a q8_0 identity weight every output is the operand's three
    pieces times 1 plus zeros, so a float32 A comes back bit for bit:
    the prologue's split is exact (values from 2^-100 to 2^100)."""
    qs = torch.eye(k, dtype=torch.int8, device=dev)
    eye = layout.PreparedWeight("q8_0", k, k, qs, torch.ones(
        k, k // 32, dtype=torch.float16, device=dev))
    g = torch.Generator(device=dev).manual_seed(12)
    sign = torch.where(torch.rand(16, k, generator=g, device=dev) < 0.5,
                       -1.0, 1.0)
    x = sign * (1.0 + torch.rand(16, k, generator=g, device=dev)) * 2.0 ** (
        torch.randint(-100, 100, (16, k), generator=g, device=dev).float())
    x[0, :32] = 0.0
    assert torch.equal(gemm_dequant(eye, x), x)


ROW_CLUSTER_SHAPES = [(r, c) for r in (1, 3, 8)
                      for c in (32000, 32001, 65536, 300000)]


def _row_input(r, c, dev, seed, aligned):
    x = _unaligned(r, c, dev, seed) if not aligned else torch.randn(
        r, c, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)
    return x


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("r, c", ROW_CLUSTER_SHAPES + ROWS)
def test_rms_norm_pallas_row_plan(dev, r, c, aligned):
    """K9 on the row plan (a cluster of 8 CTAs a row at these R x C; the
    streamed path at C 300000, above a full cluster's registers): within
    1e-5 * max|y| of the plain version, equal bit for bit to the plain
    version's steps on the sum of squares in the kernel's order
    (``rows.ordered_sum``), and two calls bit-equal."""
    x = _row_input(r, c, dev, 21, aligned)
    w = 0.5 + torch.rand(c, generator=torch.Generator(device=dev)
                         .manual_seed(22), device=dev)
    p = rows.plan(r, c, x.data_ptr() % 16 == 0)
    before = rms_norm_pallas.launches
    got = rms_norm_pallas(x, w, EPS)
    assert rms_norm_pallas.launches == before + 1
    ref = rms_norm_pallas_plain(x, w, EPS)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    ms = tq.div(rows.ordered_sum(x * x, p)[:, None], c)
    assert torch.equal(got, x * rms_rsqrt(ms + EPS) * w)
    assert torch.equal(got, rms_norm_pallas(x, w, EPS))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("r, c", ROW_CLUSTER_SHAPES + ROWS)
def test_softmax_pallas_row_plan(dev, r, c, aligned):
    """K10 on the row plan: within 1e-6 of the plain version, equal bit
    for bit to ``exp(x - max)`` over its sum in the kernel's order
    (``rows.ordered_sum``), and two calls bit-equal."""
    x = 4.0 * _row_input(r, c, dev, 23, aligned)
    p = rows.plan(r, c, x.data_ptr() % 16 == 0)
    before = softmax_pallas.launches
    got = softmax_pallas(x)
    assert softmax_pallas.launches == before + 1
    assert (got - softmax_pallas_plain(x)).abs().max() <= 1e-6
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    assert torch.equal(got, e / rows.ordered_sum(e, p)[:, None])
    assert torch.equal(got, softmax_pallas(x))


# --- slice 14: the iq4_xs forms of K1, K4 and K6; Qwen2.5-1.5B shapes ---

QWEN = dict(dim=1536, d_ff=8960, n_heads=12, n_kv_heads=2, vocab=151936)


def _iq4_xs(n, k, dev, seed):
    """A random IQ4_XS weight [n, k] in the port's iq4_xs form."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return layout.prepare(kquants.from_bytes_iq4_xs(
        kquants.random_iq4("iq4_xs", n, k, k ** -0.5, g)))


def _cpu(w):
    return type(w)(*(t.cpu() if isinstance(t, torch.Tensor) else t
                     for t in w))


@pytest.mark.parametrize("k", [1536, 8960])
@pytest.mark.parametrize("m", [1, 8, 12])
def test_gemm_exact_iq4_xs_k1_order_bit_exact(dev, m, k):
    """K1's iq4_xs form (q8_0's body with float32 scales) equals
    ``k1_order`` of the plain version's terms bit for bit; N = 774 leaves
    a ragged row tile."""
    w = _iq4_xs(774, k, dev, seed=k + m)
    a = tq.quantize_q8_1(_act_k(m, k, m, dev))
    before = gemm_exact.launches
    got = gemm_exact(w, a)
    assert gemm_exact.launches == before + 1
    want = k1_order(block_terms(_cpu(w), Q8_1Tensor(*(t.cpu() for t in a))))
    assert torch.equal(got.cpu(), want)


def _act_k(m, k, seed, dev, scale=1.0):
    x = np.random.default_rng(seed).standard_normal((m, k)) * scale
    return _t(x.astype(np.float32), dev)


@pytest.mark.parametrize("k", [1536, 8960])
@pytest.mark.parametrize("m", [1, 8, 12])
def test_gemm_exact_fused_iq4_xs(dev, m, k):
    """K6's iq4_xs form equals quantize_q8_1 + K1 bit for bit, with an
    all-zero and an f16-saturating block."""
    w = _iq4_xs(640, k, dev, seed=3 * k + m)
    x = _degenerate(_act_k(m, k, m + 1, dev))
    got = gemm_exact_fused(w, x)
    assert torch.equal(got, gemm_exact(w, tq.quantize_q8_1(x)))
    ref = gemm_exact_fused_plain(w, x)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("adt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m, k", [(13, 1536), (128, 1536), (100, 8960)])
def test_gemm_dequant_iq4_xs(dev, adt, m, k):
    """K4's iq4_xs form against its plain version: bf16 and float32
    operands, NMSE <= FQ_NMSE (exact products, only the float32 order of
    sums differs); two calls bit-equal."""
    w = _iq4_xs(17920 if k == 1536 else 1536, k, dev, seed=m + k)
    a = _act_k(m, k, m, dev).to(adt)
    got, ref = gemm_dequant(w, a), gemm_dequant_plain(w, a)
    e = ((got.double() - ref.double()) ** 2).sum() / (ref.double() ** 2).sum()
    assert e <= FQ_NMSE
    assert torch.equal(got, gemm_dequant(w, a))


@pytest.mark.parametrize("pieces", ["chosen", "one", "most"])
@pytest.mark.parametrize("ctxs", [[512] * 8, [900, 17, 512, 300, 64, 1000,
                                              5, 777]])
def test_flash_decode_qwen_rep6(dev, ctxs, pieces):
    """K3 at Qwen's KV 2, rep 6 (16 query rows a block: 10 padded), hd
    128, 8 slots, with the Server's ``s_hi``, split as chosen, into one
    piece and into the most; within 2e-3 of plain, two calls equal."""
    from quant_gemm_tpu_torch.ops.attention import decode_s_hi

    g = torch.Generator(device=dev).manual_seed(61)
    shape = (3, 8, 2, 2048, 128)
    kc = torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn(8, 2, 6, 128, generator=g, device=dev)
    kw = dict(k_current=torch.randn(8, 2, 1, 128, generator=g, device=dev)
              .to(torch.bfloat16),
              v_current=torch.randn(8, 2, 1, 128, generator=g, device=dev)
              .to(torch.bfloat16), layer=1, s_hi=decode_s_hi(max(ctxs)))
    pos = torch.tensor(ctxs, dtype=torch.int32, device=dev)
    ns = {"chosen": None, "one": 1,
          "most": decode_max_pieces(0, 2048, kw["s_hi"])}[pieces]
    got = flash_decode(q, kc, vc, pos, pieces=ns, **kw)
    ref = flash_decode_plain(q, kc, vc, pos, **kw)
    assert (got - ref).abs().max() <= 2e-3
    assert torch.equal(got, flash_decode(q, kc, vc, pos, pieces=ns, **kw))


@pytest.mark.parametrize("t, p0", [(128, 0), (128, 384), (80, 200),
                                   (64, 1000)])
def test_flash_prefill_qwen_rep6(dev, t, p0):
    """K5 at KV 2, rep 6, hd 128: 64-row tiles that cut across tokens
    (64 / 6 is not whole), a ragged last chunk; within 2e-3, two calls
    equal."""
    g = torch.Generator(device=dev).manual_seed(62)
    shape = (2, 3, 2, 2048, 128)
    kc = torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
    kc, vc = kc[:, 1:2], vc[:, 1:2]  # a one-slot view, strided
    q = torch.randn(1, 2, t * 6, 128, generator=g, device=dev)
    pos0 = torch.tensor([p0], dtype=torch.int32, device=dev)
    kw = dict(rep=6, layer=1)
    got = flash_prefill(q, kc, vc, pos0, **kw)
    ref = flash_prefill_plain(q, kc, vc, pos0, **kw)
    assert (got - ref).abs().max() <= 2e-3
    assert torch.equal(got, flash_prefill(q, kc, vc, pos0, **kw))


@pytest.mark.parametrize("m", [1, 8])
def test_gemm_exact_k16_qwen_tied_head(dev, m):
    """K7 on the tied q6_K head at N 151936 (a multiple of 128, not of
    256): bit for bit ``k1_order`` of its block terms."""
    g = torch.Generator(device=dev).manual_seed(63)
    w = layout.prepare_k16(kquants.random_blocks("q6_K", 151936, 1536, 0.02,
                                                 g))
    a = tq.quantize_q8_1(_act_k(m, 1536, 7, dev))
    got = gemm_exact_k16(w, a)
    assert torch.equal(got, k1_order(k16_block_terms(w, a)))
    ref = gemm_exact_k16_plain(w, a)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


def _qwen_model(dev, layers=2):
    """Qwen2.5-1.5B width, ``layers`` deep: random q4_0 linears, float32
    QKV biases, the tied q6_K head."""
    cfg = llama.LlamaConfig(**QWEN, n_layers=layers, max_seq=1024,
                            rope_base=1e6, eps=1e-6)
    qp = llama.init_qparams(cfg, seed=5, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    for ly in qp["layers"]:
        ly["bqkv"] = 0.1 * torch.randn(2048, generator=g, device=dev)
    qp["lm_head"] = layout.prepare_k16(kquants.random_blocks(
        "q6_K", cfg.vocab, cfg.dim, 0.02, g))
    return qp, cfg


def test_qwen_decode_with_bias_layer_by_layer(dev):
    """A Qwen-width 8-slot decode step (K2 + bias, K1, K3 at rep 6, K7
    head) against the plain versions from the same hidden state at every
    layer: each layer's update and the logits NMSE <= 1e-4."""
    qp, cfg = _qwen_model(dev)
    cache = llama.KVCache.init(cfg, 8, device=dev)
    rng = np.random.default_rng(9)
    llama.forward(qp, cfg, torch.as_tensor(rng.integers(0, cfg.vocab,
                                                        (8, 40)),
                                           device=dev), cache)
    cache.pos = torch.tensor([40, 33, 7, 40, 1, 25, 39, 12],
                             dtype=torch.int32, device=dev)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (8, 1)), device=dev)
    cp = cache.clone()
    x, step = llama.begin(qp, cfg, tok, cache)
    assert step.use_mega
    for li, ly in enumerate(qp["layers"]):
        xk, _ = llama.layer(ly, li, cfg, x, cache, step)
        xp, _ = llama.layer(ly, li, cfg, x, cp, step, registry.PLAIN)
        d, r = (xk - x).double(), (xp - x).double()
        assert ((d - r) ** 2).sum() <= 1e-4 * (r ** 2).sum()
        x = xk
    lk = llama.head(qp, cfg, x)
    lp = llama.head(qp, cfg, x, registry.PLAIN)
    assert ((lk.double() - lp.double()) ** 2).sum() <= \
        1e-4 * (lp.double() ** 2).sum()


def test_qwen_server_captured_equals_eager_with_bias(dev, monkeypatch):
    """The bias inside the captured decode and chunk graphs: a Qwen-width
    Server replaying CUDA graphs gives the eager Server's transcripts and
    launches; the decode graph runs K2 and K7 once a step."""
    qp, cfg = _qwen_model(dev)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (150, 70)]
    runs = {}
    for graphs in (False, True):
        monkeypatch.setattr(serve, "CUDA_GRAPHS", graphs)
        srv = serve.Server(qp, cfg, n_slots=2, device=dev)
        for p in prompts:
            srv.submit(p, max_new=6)
        runs[graphs] = srv.run_until_done(), srv
    assert runs[True][0] == runs[False][0]
    decode = [g for k, g in runs[True][1].graphs.items() if k[0] == "decode"]
    assert decode and all(g.launches["norm_qkv"] == 2
                          and g.launches["gemm_exact_k16"] == 1
                          for g in decode)


# -- slice 15: W4A16 decode, LoRA routes, the speculative rewind -------------

#: TinyLlama-1.1B's five GEMMs (N, K): wqkv, wo, wgu, w_down, lm_head
TINY_GEMMS = [(2560, 2048), (2048, 2048), (11264, 2048), (2048, 5632),
              (32000, 2048)]


@pytest.fixture(scope="module")
def tiny_weights():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc (the kernels run only there)")
    g = torch.Generator(device="cuda").manual_seed(15)
    return {s: layout.prepare(tq.quantize_q4_0(torch.randn(
        *s, generator=g, device="cuda") * s[1] ** -0.5)) for s in TINY_GEMMS}


@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("shape", TINY_GEMMS, ids=["wqkv", "wo", "wgu",
                                                  "w_down", "lm_head"])
def test_gemm_dequant_bf16_decode_rows(dev, tiny_weights, shape, m):
    """K4 on a bf16 activation at M 1..8 (the W4A16 decode route, 7/8 and
    more of each 64-row tile padding): NMSE <= FQ_NMSE against its plain
    version (every product exact, only the float32 order differs), two
    calls bit-equal."""
    w = tiny_weights[shape]
    a = torch.randn(m, w.k, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(m)
                    ).to(torch.bfloat16)
    got, ref = gemm_dequant(w, a), gemm_dequant_plain(w, a)
    assert got.shape == (m, w.n)
    assert ((got - ref).double() ** 2).sum() <= FQ_NMSE * (
        ref.double() ** 2).sum()
    assert torch.equal(got, gemm_dequant(w, a))


@pytest.mark.parametrize("slot", ["wqkv", "w_down"])
def test_lora_turns_k2_and_k8_off_on_the_card(dev, monkeypatch, slot):
    """A decode step of a dim-512 q4_0 model with ENABLE_TAIL: K2 and K8
    launch once per layer; with a LoRA delta on one layer's ``wqkv`` K2
    launches no more (K8 still), on one layer's ``w_down`` K8 no more (K2
    still); the LoRA'd step equals its plain version layer by layer."""
    from quant_gemm_tpu_torch.models import lora

    monkeypatch.setattr(gemm_megalayer, "ENABLE_TAIL", True)
    cfg = llama.LlamaConfig(vocab=256, dim=512, n_layers=2, n_heads=8,
                            n_kv_heads=2, d_ff=1024, max_seq=64)
    qp = llama.init_qparams(cfg, seed=3, device=dev)
    part = {"wqkv": "attn_v", "w_down": "ffn_down"}[slot]
    w = qp["layers"][1][slot]
    g = torch.Generator(device=dev).manual_seed(4)
    n = cfg.n_kv_heads * cfg.head_dim if slot == "wqkv" else w.n
    ql = lora.attach_lora(qp, lora.LoraAdapter(32.0, {
        f"blk.1.{part}.weight": lora.LoraDelta(
            torch.randn(16, w.k, generator=g, device=dev) * 0.05,
            torch.randn(n, 16, generator=g, device=dev) * 0.05)}), cfg)
    tok = torch.tensor([[5], [9]], device=dev)
    for params, k2, k8 in ((qp, 2, 2), (ql, 0 if slot == "wqkv" else 2,
                                         2 if slot == "wqkv" else 0)):
        before = norm_qkv.launches, attn_tail.launches
        llama.forward(params, cfg, tok, llama.KVCache.init(cfg, 2,
                                                           device=dev))
        torch.cuda.synchronize()
        assert (norm_qkv.launches - before[0],
                attn_tail.launches - before[1]) == (k2, k8)
    cache = llama.KVCache.init(cfg, 2, device=dev)
    cp = cache.clone()
    x, step = llama.begin(ql, cfg, tok, cache)
    for li, ly in enumerate(ql["layers"]):
        xk, _ = llama.layer(ly, li, cfg, x, cache, step)
        xp, _ = llama.layer(ly, li, cfg, x, cp, step, registry.PLAIN)
        d, r = (xk - x).double(), (xp - x).double()
        assert ((d - r) ** 2).sum() <= 1e-4 * (r ** 2).sum()
        x = xk


def test_speculative_rewind_at_batch_4(dev):
    """Speculative greedy decoding at B 4, k 4 (the verify block M = 20:
    K4, the draft's steps K1) from CUDA graphs: each row is the target's
    greedy transcript, or within the near-tie rule (4e-2 x max|logits|)
    along it; the verify graph replays every round after the first; the
    self draft reaches at least 0.9 of ``speculative.best_rate`` (64
    tokens: 13 rounds at best, 66 / 14 = 4.71 tokens per target call)."""
    from quant_gemm_tpu_torch.models import speculative

    cfg = llama.LlamaConfig(vocab=512, dim=512, n_layers=2, n_heads=8,
                            n_kv_heads=2, d_ff=1024, max_seq=128)
    cfg_d = cfg._replace(n_layers=1)
    qp = llama.init_qparams(cfg, seed=5, device=dev)
    qd = llama.init_qparams(cfg_d, seed=6, device=dev)
    prompt = torch.randint(0, 512, (4, 40), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(7))
    want, _ = llama.greedy_decode(qp, cfg, prompt, 64)
    for draft, c in ((qd, cfg_d), (qp, cfg)):
        graphs = serve.Graphs(dev)
        got, rate = speculative.speculative_greedy_decode(
            qp, cfg, draft, c, prompt, 64, k=4, graphs=graphs)
        verify = [g for key, g in graphs.graphs.items() if key[0] == "verify"]
        assert len(verify) == 1 and verify[0].replays >= 1
        cache = llama.KVCache.init(cfg, 4, device=dev)
        logits, _ = llama.forward(qp, cfg, prompt, cache)
        for s in range(64):
            last = logits[:, -1]
            slack = last.amax(-1) - last.gather(-1, got[:, s:s + 1])[:, 0]
            assert (slack <= 4e-2 * last.abs().amax(-1)).all()
            logits, _ = llama.forward(qp, cfg, got[:, s:s + 1], cache)
        if draft is qp:
            assert rate >= 0.9 * speculative.best_rate(64, 4), rate
    assert want.shape == got.shape


# -- slice 17: the measuring tools on the card -------------------------------


def test_benchmark_kernel_times_k1(weight, dev):
    """``harness.benchmark.benchmark_kernel`` on K1 (M 8): a valid time,
    the card's name, and a rate under the physical cap."""
    from quant_gemm_tpu_torch.harness import benchmark as bm

    a = tq.quantize_q8_1(_act(8, 171, dev))
    nbytes = bm.weight_bytes("q4_0", N, K) + 8 * K * 9 // 8 + 8 * N * 4
    r = bm.benchmark_kernel(gemm_exact, (weight, a), name="K1",
                            flops=bm.gemm_flops(8, N, K),
                            bytes_accessed=nbytes, device=dev)
    assert r.valid and 0 < r.time_s < 1e-2, r
    assert r.device == torch.cuda.get_device_name(dev)
    assert r.gbps < bm.PHYS_MAX_GBPS, r.row()


def test_aot_compile_sees_no_gpu():
    """The deviceless gate builds every source with no GPU visible, and
    its report names every source's entries."""
    from quant_gemm_tpu_torch.harness import aot
    from quant_gemm_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA toolkit of a card's machine")
    res = aot.aot_compile()
    rows = aot.resource_report(res["logs"])
    assert set(res["logs"]) == set(_build.source_names())
    assert {r.source for r in rows} == set(_build.source_names())
    assert all(r.registers > 0 for r in rows)


def test_trace_names_k1(weight, dev, tmp_path):
    import json

    from quant_gemm_tpu_torch.harness import profiling

    a = tq.quantize_q8_1(_act(8, 172, dev))
    gemm_exact(weight, a)
    with profiling.trace(str(tmp_path)) as path:
        gemm_exact(weight, a)
    events = json.loads(Path(path).read_text())["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    assert any("gemm_exact_kernel" in n for n in names), names


def test_decode_without_k2_bit_equal_on_exact_norms(dev, monkeypatch):
    """A 1-layer decode step whose K2 input is exact (embedding rows of
    +-1, eps 0, so RMSNorm is ``x * w``): with ``ENABLE_QKV`` off (the
    unfused RMSNorm, quantize and K1) the logits equal the K2 step's bit
    for bit."""
    cfg = llama.LlamaConfig(vocab=64, dim=512, n_layers=1, n_heads=8,
                            n_kv_heads=2, d_ff=1024, max_seq=64, eps=0.0)
    params = llama.init_params(cfg, seed=9)
    sign = np.random.default_rng(9).random((cfg.vocab, cfg.dim)) < 0.5
    params["embed"] = np.where(sign, -1.0, 1.0).astype(np.float32)
    qp = llama.quantize_params(params, device=dev)
    cache = llama.KVCache.init(cfg, 2, device=dev)
    llama.forward(qp, cfg, torch.ones(2, 8, dtype=torch.long, device=dev),
                  cache)
    tok = torch.tensor([[3], [5]], device=dev)
    before = norm_qkv.launches
    fused = llama.forward(qp, cfg, tok, cache.clone())[0]
    assert norm_qkv.launches == before + 1
    monkeypatch.setattr(gemm_megalayer, "ENABLE_QKV", False)
    plain = llama.forward(qp, cfg, tok, cache.clone())[0]
    assert norm_qkv.launches == before + 1
    assert torch.equal(fused, plain)
