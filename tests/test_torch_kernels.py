"""The port's kernel modules against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both the JAX function
(Pallas in interpret mode, as the JAX tests run it) and the port's wrapper,
which on CPU tensors runs its kernel's plain PyTorch version.  Tolerances:

* K1 ``gemm_exact`` and K4 ``gemm_dequant``: ``rtol=1e-5,
  atol=1e-5 * max|C|`` — the integer dots and the dequantized weights are
  exact and both sum in float32, so only the summation order differs;
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
from quant_gemm_tpu.formats import numpy_ref as jnr
from quant_gemm_tpu.kernels import gemm_megalayer as jmega
from quant_gemm_tpu.kernels.gemm_exact import gemm_exact as j_gemm_exact
from quant_gemm_tpu.kernels.gemm_pallas import gemm as j_gemm
from quant_gemm_tpu.kernels.gemm_pallas import prepare as j_prepare
from quant_gemm_tpu.ops import attention as jattn
from quant_gemm_tpu.ref.gemm import gemm_w4a8
from quant_gemm_tpu_torch.formats import quant as tq
from quant_gemm_tpu_torch.formats.blocks import Q8_1Tensor
from quant_gemm_tpu_torch.kernels import layout, registry
from quant_gemm_tpu_torch.kernels.gemm_dequant import (gemm_dequant,
                                                       gemm_dequant_plain)
from quant_gemm_tpu_torch.kernels.gemm_exact import (gemm_exact,
                                                     gemm_exact_plain)
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


def test_cpu_tensors_never_count_as_launches(weight):
    _, _, pw = weight
    before = (gemm_exact.launches, gemm_dequant.launches, norm_qkv.launches,
              flash_decode.launches)
    x = torch.from_numpy(_act(4, 9))
    registry.dispatch(pw, x, quantize_act=True)
    registry.dispatch(pw, torch.cat([x] * 4), quantize_act=True)
    norm_qkv(pw, x, torch.ones(K), EPS)
    assert (gemm_exact.launches, gemm_dequant.launches, norm_qkv.launches,
            flash_decode.launches) == before


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
