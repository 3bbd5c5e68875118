"""The port's kernel modules against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both the JAX function
(Pallas in interpret mode, as the JAX tests run it) and the port's wrapper,
which on CPU tensors runs its kernel's plain PyTorch version.  Tolerances:

* K1 ``gemm_exact`` and K4 ``gemm_dequant`` (q4_0, and q4_k: a q4_K
  weight in its effective form), K7 ``gemm_exact_k16`` (q6_K, q3_K,
  q2_K): ``rtol=1e-5, atol=1e-5 * max|C|`` — the integer dots and the
  dequantized weights are the same float32 values and both sum in
  float32, so only the summation order differs; also against the JAX
  package's float64-summed goldens (``ref.gemm.gemm_wxa8``,
  ``kquants.gemm_k16_ref``);
* K2 ``norm_qkv``: ``atol=2e-3 * max|C|`` — a last-ulp difference in the
  normalised activation can move a Q8_1 code across a .5 rounding tie;
* K3 ``flash_decode``: ``atol=1e-5`` — both compute in float32 from the
  same float32 / bf16 inputs, the softmax in different orders.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_gemm_tpu.formats import jax_quant as jq
from quant_gemm_tpu.formats import kquants as jk
from quant_gemm_tpu.formats import numpy_ref as jnr
from quant_gemm_tpu.formats.blocks import Q4_1Tensor
from quant_gemm_tpu.kernels.gemm_exact import gemm_exact_k16 as j_gemm_k16
from quant_gemm_tpu.kernels.gemm_exact import prepare_k16 as j_prepare_k16
from quant_gemm_tpu.kernels import gemm_megalayer as jmega
from quant_gemm_tpu.kernels.gemm_exact import gemm_exact as j_gemm_exact
from quant_gemm_tpu.kernels.gemm_pallas import gemm as j_gemm
from quant_gemm_tpu.kernels.gemm_pallas import prepare as j_prepare
from quant_gemm_tpu.ops import attention as jattn
from quant_gemm_tpu.ref.gemm import gemm_w4a8, gemm_wxa8
from quant_gemm_tpu_torch.formats import kquants as tk
from quant_gemm_tpu_torch.formats import quant as tq
from quant_gemm_tpu_torch.formats.blocks import Q8_1Tensor
from quant_gemm_tpu_torch.kernels import layout, registry
from quant_gemm_tpu_torch.kernels.gemm_dequant import (gemm_dequant,
                                                       gemm_dequant_plain)
from quant_gemm_tpu_torch.kernels.gemm_exact import (gemm_exact,
                                                     gemm_exact_plain,
                                                     k1_order)
from quant_gemm_tpu_torch.kernels.gemm_exact_k16 import (
    gemm_exact_k16, gemm_exact_k16_plain, k16_block_terms)
from quant_gemm_tpu_torch.kernels.gemm_megalayer import (norm_qkv,
                                                         norm_qkv_plain)
from quant_gemm_tpu_torch.ops.rms_norm import rms_norm
from quant_gemm_tpu_torch.ops.attention import (flash_decode,
                                                flash_decode_plain,
                                                flash_decode_ref)

N, K, EPS = 512, 1024, 1e-5


@pytest.fixture(scope="module")
def weight():
    rng = np.random.default_rng(11)
    w = rng.normal(0, 0.05, (N, K)).astype(np.float32)
    wq = jnr.quantize_q4_0(w)
    return wq, j_prepare(wq), layout.prepare(tq.quantize_q4_0(
        torch.from_numpy(w)))


def _act(m, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, K)) * scale).astype(np.float32)


def _q8_1(x):
    a = jnr.quantize_q8_1(x)
    return a, Q8_1Tensor(*(torch.from_numpy(np.asarray(t)) for t in a))


def _close_rel(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("m", [8, 3])
def test_gemm_exact_matches_jax(weight, m):
    wq, jw, pw = weight
    a_np, a_t = _q8_1(_act(m, 1))
    got = gemm_exact(pw, a_t).numpy()
    _close_rel(got, j_gemm_exact(jw, jq.device_put(a_np)), 1e-5)
    _close_rel(got, gemm_w4a8(wq, a_np), 1e-5)  # the float64-summed golden


@pytest.mark.parametrize("m", [8, 5])
def test_norm_qkv_matches_jax(m):
    # K = 512, the smallest the JAX kernel takes (K % 512 == 0): its
    # interpret-mode run time grows with K
    k = 512
    w = np.random.default_rng(12).normal(0, 0.05, (256, k)).astype(np.float32)
    jw = j_prepare(jnr.quantize_q4_0(w))
    pw = layout.prepare(tq.quantize_q4_0(torch.from_numpy(w)))
    x = _act(m, 2, scale=3.0)[:, :k]
    nw = np.random.default_rng(3).normal(1, 0.1, k).astype(np.float32)
    got = norm_qkv(pw, torch.from_numpy(x), torch.from_numpy(nw), EPS)
    want = np.asarray(jmega.norm_qkv(jw, jnp.asarray(x), jnp.asarray(nw), EPS))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-3 * np.abs(want).max())
    # the plain version is exactly the unfused chain
    h = rms_norm(torch.from_numpy(x), torch.from_numpy(nw), EPS)
    torch.testing.assert_close(
        got, gemm_exact_plain(pw, tq.quantize_q8_1(h)), rtol=0, atol=0)


@pytest.mark.parametrize("m", [8, 5])
def test_gemm_dequant_matches_jax(weight, m):
    _, jw, pw = weight
    a_np, a_t = _q8_1(_act(m, 4))
    got = gemm_dequant(pw, registry.fold_q8_1(a_t)).numpy()
    _close_rel(got, j_gemm(jw, jq.device_put(a_np)), 1e-5)


def _to_torch(container, cls):
    return cls(*(torch.from_numpy(np.ascontiguousarray(np.asarray(f)))
                 for f in container))


@pytest.fixture(scope="module")
def weight_q4_k():
    """A q4_K weight (the JAX encoder, with its scale search) in its
    effective form, for both packages."""
    w = np.random.default_rng(13).normal(0, 0.05, (N, K)).astype(np.float32)
    jq4k = jk.quantize_q4_k(w)
    eff = jk.to_effective(jq4k)
    return eff, j_prepare(eff), layout.prepare(tk.to_effective(
        _to_torch(jq4k, tk.Q4_KTensor)))


@pytest.mark.parametrize("m", [8, 3])
def test_gemm_exact_q4_k_matches_jax(weight_q4_k, m):
    """K1's min-form epilogue d' d_a sumi + m' s_a (s_a the stored Q8_1
    s)."""
    eff, jw, pw = weight_q4_k
    assert pw.qtype == "q4_k" and pw.d.dtype == torch.float32
    a_np, a_t = _q8_1(_act(m, 14))
    got = gemm_exact(pw, a_t).numpy()
    _close_rel(got, j_gemm_exact(jw, jq.device_put(a_np)), 1e-5)
    golden = gemm_wxa8(Q4_1Tensor(eff.packed, eff.d, eff.m), a_np)
    _close_rel(got, golden, 1e-5)


@pytest.mark.parametrize("m", [16, 5])
def test_gemm_dequant_q4_k_matches_jax(weight_q4_k, m):
    _, jw, pw = weight_q4_k
    a_np, a_t = _q8_1(_act(m, 15))
    got = gemm_dequant(pw, registry.fold_q8_1(a_t)).numpy()
    _close_rel(got, j_gemm(jw, jq.device_put(a_np)), 1e-5)


K16_QUANTIZE = {"q6_K": (jk.quantize_q6_k, tk.Q6_KTensor),
                "q3_K": (jk.quantize_q3_k, tk.Q3_KTensor),
                "q2_K": (jk.quantize_q2_k, tk.Q2_KTensor)}


@pytest.fixture(scope="module")
def k16_weights():
    w = np.random.default_rng(16).normal(0, 0.05, (N, K)).astype(np.float32)
    out = {}
    for qt, (quantize, cls) in K16_QUANTIZE.items():
        jt = quantize(w)
        out[qt] = (jt, j_prepare_k16(jt),
                   layout.prepare_k16(_to_torch(jt, cls)))
    return out


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("qt", list(K16_QUANTIZE))
def test_gemm_exact_k16_matches_jax(k16_weights, qt, m):
    """K7: the per-16 terms, with q2_K's min term, against the Pallas
    kernel (interpret mode) and the golden ``gemm_k16_ref``."""
    jt, jw, pw = k16_weights[qt]
    assert pw.qtype == qt.lower() and (pw.mp is None) == (qt != "q2_K")
    a_np, a_t = _q8_1(_act(m, 17))
    got = gemm_exact_k16(pw, a_t).numpy()
    _close_rel(got, j_gemm_k16(jw, jq.device_put(a_np), interpret=True),
               1e-5)
    _close_rel(got, jk.gemm_k16_ref(jt, a_np), 1e-5)
    if qt == "q6_K":
        _close_rel(got, jk.gemm_q6k_ref(jt, a_np), 1e-5)


@pytest.mark.parametrize("m", [1, 8, 12])
@pytest.mark.parametrize("qt", list(K16_QUANTIZE))
def test_k16_block_terms_in_k1_order(k16_weights, qt, m):
    """K7's own sum on the card: each 32-block's two sub-block terms
    added, then K1's order (``k1_order``).  It agrees with the plain
    version's sum, the Pallas kernel and the golden to K7's 1e-5, and the
    block terms add up the plain version's per-16 terms."""
    jt, jw, pw = k16_weights[qt]
    a_np, a_t = _q8_1(_act(m, 19))
    terms = k16_block_terms(pw, a_t)
    assert terms.shape == (m, pw.n, pw.k // 32)
    got = k1_order(terms).numpy()
    _close_rel(got, gemm_exact_k16_plain(pw, a_t).numpy(), 1e-5)
    _close_rel(got, j_gemm_k16(jw, jq.device_put(a_np), interpret=True),
               1e-5)
    _close_rel(got, jk.gemm_k16_ref(jt, a_np), 1e-5)


@pytest.mark.parametrize("m, route", [(1, "gemm_exact_k16"),
                                      (12, "gemm_exact_k16"),
                                      (13, "k16_dequant_gemm"),
                                      (48, "k16_dequant_gemm")])
def test_dispatch_routes_k16_by_rows(k16_weights, m, route):
    """Decode rows take K7; prefill rows take the plain float32 matmul
    with the float activation unquantized (JAX routes a float activation
    with quantize_act there as it is, registry.py:182-190), and a Q8_1
    activation dequantized to float32."""
    _, _, pw = k16_weights["q2_K"]
    rec = _Recorder()
    x = torch.from_numpy(_act(m, 18))
    calls = registry.k16_dequant_gemm.calls
    got = registry.dispatch(pw, x, quantize_act=True, ops=rec.ops())
    if route == "gemm_exact_k16":
        assert [c[0] for c in rec.calls] == [route]
        want = gemm_exact_k16_plain(pw, tq.quantize_q8_1(x))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        return
    assert rec.calls == [] and registry.k16_dequant_gemm.calls == calls + 1
    deq = layout.dequantize_k16(pw)
    torch.testing.assert_close(got, x @ deq.T, rtol=0, atol=0)
    a8 = tq.quantize_q8_1(x)
    got8 = registry.dispatch(pw, a8, ops=rec.ops())
    x8 = a8.qs.to(torch.float32) * tq.expand_scale(a8.d)
    torch.testing.assert_close(got8, x8 @ deq.T, rtol=0, atol=0)


def test_dispatch_refuses_weights_without_a_kernel():
    """An unprepared container reaches no plain version: it raises."""
    w = tq.quantize_q4_0(torch.from_numpy(_act(4, 19)))
    with pytest.raises(TypeError, match="Q4_0Tensor"):
        registry.dispatch(w, torch.zeros(2, K), quantize_act=True)


def _attn_inputs(seed=5, layers=3, b=4, kv=2, rep=4, hd=64, s=256):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    q = f(b, kv, rep, hd)
    kc, vc = bf(f(layers, b, kv, s, hd)), bf(f(layers, b, kv, s, hd))
    kcur, vcur = bf(f(b, kv, 1, hd)), bf(f(b, kv, 1, hd))
    pos = np.array([0, 5, 77, s - 1], np.int32)[:b]  # ragged per slot
    return q, kc, vc, kcur, vcur, pos


def _jnp(t):
    """bf16 torch tensor -> the same values as a jnp bf16 array."""
    return jnp.asarray(t.to(torch.float32).numpy(), jnp.bfloat16)


@pytest.mark.parametrize("layer", [0, 2])
def test_flash_decode_matches_jax(layer):
    """GQA rep 4, the stacked cache read through layer=, the current
    token folded in, and ragged per-slot positions (including pos 0,
    where only the current token is attended)."""
    q, kc, vc, kcur, vcur, pos = _attn_inputs()
    got = flash_decode(torch.from_numpy(q), kc, vc, torch.from_numpy(pos),
                       k_current=kcur, v_current=vcur, layer=layer)
    want = jattn.flash_decode(jnp.asarray(q), _jnp(kc), _jnp(vc),
                              jnp.asarray(pos), layer=layer,
                              k_current=_jnp(kcur), v_current=_jnp(vcur))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_flash_decode_without_current_matches_jax():
    q, kc, vc, _, _, pos = _attn_inputs(seed=6)
    kl, vl = kc[1].contiguous(), vc[1].contiguous()
    got = flash_decode(torch.from_numpy(q), kl, vl, torch.from_numpy(pos))
    want = jattn.flash_decode(jnp.asarray(q), _jnp(kl), _jnp(vl),
                              jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    ref = jattn.flash_decode_ref(jnp.asarray(q), _jnp(kl), _jnp(vl),
                                 jnp.asarray(pos))
    np.testing.assert_allclose(
        flash_decode_ref(torch.from_numpy(q), kl, vl,
                         torch.from_numpy(pos)).numpy(),
        np.asarray(ref), rtol=0, atol=1e-5)


def test_flash_decode_stale_position_stays_in_bounds():
    """An inactive serving slot's position can pass the cache end; the
    valid range clamps to the cache."""
    q, kc, vc, kcur, vcur, pos = _attn_inputs(seed=7)
    far = torch.from_numpy(pos.copy())
    far[1] = 10_000
    got = flash_decode(torch.from_numpy(q), kc, vc, far, k_current=kcur,
                       v_current=vcur, layer=1)
    at_end = far.clone()
    at_end[1] = kc.shape[3]
    want = flash_decode(torch.from_numpy(q), kc, vc, at_end, k_current=kcur,
                        v_current=vcur, layer=1)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


class _Recorder:
    """An Ops whose entries record which route dispatch took."""

    def __init__(self):
        self.calls = []

    def ops(self):
        def rec(name, fn):
            def f(*a, **kw):
                self.calls.append((name, a))
                return fn(*a, **kw)
            return f
        p = registry.PLAIN
        return registry.Ops(*(rec(n, getattr(p, n)) for n in p._fields))


@pytest.mark.parametrize("m, route", [(1, "gemm_exact"), (12, "gemm_exact"),
                                      (13, "gemm_dequant"),
                                      (48, "gemm_dequant")])
def test_dispatch_routes_by_rows(weight, m, route):
    _, _, pw = weight
    rec = _Recorder()
    x = torch.from_numpy(_act(m, 8))
    got = registry.dispatch(pw, x, quantize_act=True, ops=rec.ops())
    assert [c[0] for c in rec.calls] == [route]
    act = tq.quantize_q8_1(x)
    if route == "gemm_dequant":
        a = rec.calls[0][1][1]
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, registry.fold_q8_1(act), rtol=0, atol=0)
        want = gemm_dequant_plain(pw, registry.fold_q8_1(act))
    else:
        want = gemm_exact_plain(pw, act)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cpu_tensors_never_count_as_launches(weight, k16_weights):
    _, _, pw = weight
    before = [f.launches for f in registry.KERNELS]
    x = torch.from_numpy(_act(4, 9))
    registry.dispatch(pw, x, quantize_act=True)
    registry.dispatch(pw, torch.cat([x] * 4), quantize_act=True)
    registry.dispatch(k16_weights["q6_K"][2], x, quantize_act=True)
    norm_qkv(pw, x, torch.ones(K), EPS)
    assert [f.launches for f in registry.KERNELS] == before


def test_wrappers_raise_off_cpu_and_cuda(weight):
    """A tensor on neither the CPU nor a CUDA device is refused rather
    than run through the plain version."""
    _, _, pw = weight
    meta = layout.PreparedWeight(pw.qtype, pw.n, pw.k, pw.qs.to("meta"),
                                 pw.d.to("meta"))
    a = tq.quantize_q8_1(torch.from_numpy(_act(2, 10)))
    with pytest.raises(ValueError):
        gemm_exact(meta, Q8_1Tensor(*(t.to("meta") for t in a)))
    with pytest.raises(ValueError):
        gemm_dequant(meta, torch.zeros(2, K, dtype=torch.bfloat16,
                                       device="meta"))
    w16 = layout.prepare_k16(tk.random_blocks(
        "q6_K", 8, K, 0.05, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError):
        gemm_exact_k16(layout.PreparedK16(
            w16.qtype, w16.n, w16.k, w16.qs.to("meta"), w16.d.to("meta"),
            w16.sc.to("meta")), Q8_1Tensor(*(t.to("meta") for t in a)))
