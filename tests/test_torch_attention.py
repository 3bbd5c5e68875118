"""K5 ``flash_prefill`` and K3 ``flash_decode`` with the int8 cache and
the sliding window, against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both the JAX kernel
(Pallas in interpret mode, as the JAX tests run it) and the port's
wrapper, which on CPU tensors runs its kernel's plain PyTorch version.
Tolerance ``atol=1e-5``: both compute in float32 from the same float32 /
bf16 / int8 inputs and O(1) outputs, the softmax sums in different orders
(the K3 tolerance of ``tests/test_torch_kernels.py``).  The CUDA kernels
themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_gemm_tpu.ops import attention as jattn
from quant_gemm_tpu_torch.ops.attention import (flash_decode,
                                                flash_decode_plain,
                                                flash_prefill,
                                                flash_prefill_plain)

ATOL = 1e-5


def _cache(rng, shape, quant):
    """A cache as (torch k, v, ks, vs) and the same values for JAX."""
    x = rng.standard_normal((2, *shape)).astype(np.float32)
    if not quant:
        t = torch.from_numpy(x).to(torch.bfloat16)
        j = jnp.asarray(t.float().numpy(), jnp.bfloat16)
        return (t[0], t[1], None, None), (j[0], j[1], None, None)
    codes = rng.integers(-127, 128, (2, *shape)).astype(np.int8)
    sc = rng.uniform(0.005, 0.03, (2, *shape[:-1])).astype(np.float32)
    t = (*torch.from_numpy(codes), *torch.from_numpy(sc))
    j = (*jnp.asarray(codes), *jnp.asarray(sc))
    return t, j


def _prefill_case(seed, b=3, kv=2, rep=2, t=32, hd=64, s=160, quant=False,
                  layers=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, t * rep, hd)).astype(np.float32)
    shape = ((layers,) if layers else ()) + (b, kv, s, hd)
    tc, jc = _cache(rng, shape, quant)
    pos0 = np.array([0, 17, s - t, 5][:b], np.int32)  # ragged per slot
    return q, pos0, tc, jc


def _j_prefill(q, pos0, jc, rep, window=0):
    k, v, ks, vs = jc
    return np.asarray(jattn.flash_prefill(
        jnp.asarray(q), k, v, jnp.asarray(pos0), rep=rep, k_scale=ks,
        v_scale=vs, window=window))


def _t_prefill(q, pos0, tc, rep, window=0, layer=None):
    k, v, ks, vs = tc
    return flash_prefill(torch.from_numpy(q), k, v, torch.from_numpy(pos0),
                         rep=rep, k_scale=ks, v_scale=vs, window=window,
                         layer=layer).numpy()


@pytest.mark.parametrize("rep, t", [(2, 32), (4, 64)])
def test_flash_prefill_matches_jax(rep, t):
    """bf16 cache, GQA, ragged start positions (one chunk ends at the
    cache's last slot)."""
    q, pos0, tc, jc = _prefill_case(1, rep=rep, t=t)
    np.testing.assert_allclose(_t_prefill(q, pos0, tc, rep),
                               _j_prefill(q, pos0, jc, rep), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("quant, window", [(True, 0), (False, 24),
                                           (True, 24)])
def test_flash_prefill_int8_and_window_match_jax(quant, window):
    q, pos0, tc, jc = _prefill_case(2, rep=4, t=32, quant=quant)
    np.testing.assert_allclose(_t_prefill(q, pos0, tc, 4, window),
                               _j_prefill(q, pos0, jc, 4, window), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("quant", [False, True])
def test_flash_prefill_layer_of_stacked_cache(quant):
    """``layer=`` reads one layer of the stacked cache in place; JAX runs
    on that layer's slice."""
    q, pos0, tc, jc = _prefill_case(3, b=2, rep=2, t=32, quant=quant,
                                    layers=3)
    want = _j_prefill(q, pos0, tuple(None if a is None else a[1]
                                     for a in jc), 2)
    np.testing.assert_allclose(_t_prefill(q, pos0, tc, 2, layer=1), want,
                               rtol=0, atol=ATOL)


def _decode_case(seed, quant, b=4, kv=2, rep=4, hd=64, s=256, layers=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, rep, hd)).astype(np.float32)
    tc, jc = _cache(rng, (layers, b, kv, s, hd), quant)
    cur = torch.from_numpy(rng.standard_normal((2, b, kv, 1, hd))
                           .astype(np.float32)).to(torch.bfloat16)
    pos = np.array([0, 5, 77, s - 1], np.int32)[:b]
    return q, pos, tc, jc, cur


@pytest.mark.parametrize("quant, window", [(True, 0), (False, 24),
                                           (True, 24), (False, 1)])
def test_flash_decode_int8_and_window_match_jax(quant, window):
    """The current token rides as bf16 with either cache; window 1
    attends the current token alone."""
    q, pos, tc, jc, cur = _decode_case(4, quant)
    k, v, ks, vs = tc
    got = flash_decode(torch.from_numpy(q), k, v, torch.from_numpy(pos),
                       k_current=cur[0], v_current=cur[1], k_scale=ks,
                       v_scale=vs, layer=2, window=window)
    jk, jv, jks, jvs = jc
    jcur = jnp.asarray(cur.float().numpy(), jnp.bfloat16)
    want = jattn.flash_decode(jnp.asarray(q), jk, jv, jnp.asarray(pos),
                              k_current=jcur[0], v_current=jcur[1],
                              k_scale=jks, v_scale=jvs, layer=2,
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_ring_cache_is_not_ported():
    """What of the ring stays refused: a ring without a window, or one
    larger than the cache (its forms are held to JAX in
    ``tests/test_torch_ring.py``)."""
    q, pos0, tc, _ = _prefill_case(5)
    k, v, _, _ = tc
    for window, ring in ((0, 64), (16, k.shape[-2] + 1)):
        with pytest.raises(ValueError):
            flash_prefill(torch.from_numpy(q), k, v, torch.from_numpy(pos0),
                          rep=2, window=window, ring=ring)
    qd, pos, (kd, vd, _, _), _, _ = _decode_case(5, False)
    with pytest.raises(ValueError):
        flash_decode_plain(torch.from_numpy(qd), kd, vd,
                           torch.from_numpy(pos), layer=0, window=0,
                           ring=64)


def test_cpu_tensors_never_count_as_launches():
    q, pos0, (k, v, ks, vs), _ = _prefill_case(6, quant=True)
    before = (flash_prefill.launches, flash_decode.launches)
    got = flash_prefill(torch.from_numpy(q), k, v, torch.from_numpy(pos0),
                        rep=2, k_scale=ks, v_scale=vs)
    want = flash_prefill_plain(torch.from_numpy(q), k, v,
                               torch.from_numpy(pos0), rep=2, k_scale=ks,
                               v_scale=vs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (flash_prefill.launches, flash_decode.launches) == before


def test_wrappers_raise_off_cpu_and_cuda():
    q, pos0, (k, v, _, _), _ = _prefill_case(7)
    with pytest.raises(ValueError):
        flash_prefill(torch.from_numpy(q).to("meta"), k.to("meta"),
                      v.to("meta"), torch.from_numpy(pos0).to("meta"), rep=2)
    with pytest.raises(ValueError):  # int8 codes without their scales
        flash_prefill(torch.from_numpy(q), k.to(torch.int8),
                      v.to(torch.int8), torch.from_numpy(pos0), rep=2)
