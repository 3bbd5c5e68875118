"""Decode on the tensor cores, on the CPU: the grid choices and the
arithmetic that K3 ``flash_decode`` and K1 ``gemm_exact`` rely on on the
card, replayed in numpy / PyTorch, and ``s_hi`` through the port's
``forward`` and ``Server`` against the JAX Server.

Inputs come from numpy seeds, at shapes within (8, 512, 1024) (K1's
order is also replayed on synthetic terms of up to 448 blocks).
Tolerances:

* ``decode_pieces`` / ``decode_piece_bounds``: exact (integer cuts);
* K3's split over the walk, replayed in float64 (pieces of the ring's
  or the linear cache's interval cut as the kernel cuts them, each
  piece's max, sum and unnormalised output, merged in piece order, the
  current token folded last): within ``1e-6 * max(1, max|out|)`` of
  ``flash_decode_plain``, which computes in float32: the int8 cache's
  outputs reach about 4, where a float32 ulp is 4.8e-7, and the plain
  version's dense softmax is a few ulps off the float64 replay;
* the int8 -> bf16 conversion K3 does in registers, and the fragment
  algebra of K3's int8 QK^T / PV and of K1's ``mma.sync`` m16n8k32 (every
  MMA emulated from the PTX fragment layout): exact, integers and
  products of integers;
* K7's fragments: the halves of K1's q8_0 fragment through two int8
  m16n8k16 give each 16-element sub-block's dot, a fragment of ones its
  activation codes' sum (q2_K's ``sumq``): exact;
* ``k1_order``: bit for bit against a scalar replay of K1's order (each
  virtual thread's sum, then the butterfly, as a CUDA-core loop runs it);
  against ``gemm_exact_plain`` NMSE <= 1e-10
  (the same float32 terms, summed in another order); against the JAX
  ``gemm_exact`` (Pallas in interpret mode) ``rtol=1e-5, atol=1e-5 *
  max|C|``, K1's tolerance in ``tests/test_torch_kernels.py``;
* ``forward`` with ``s_hi``: logits equal to the call without it
  (``torch.equal``); the Server passes JAX's bucket at every decode step,
  and its greedy transcripts follow the JAX Server's under the near-tie
  rule of ``tests/test_torch_model.py`` (the JAX token is the port's
  argmax, or within ``2 * 2e-2 * max|logits|`` of it).
"""

import numpy as np
import pytest
import torch

from quant_gemm_tpu.formats import jax_quant as jq
from quant_gemm_tpu.formats import numpy_ref as jnr
from quant_gemm_tpu.kernels.gemm_exact import gemm_exact as j_gemm_exact
from quant_gemm_tpu.kernels.gemm_pallas import prepare as j_prepare
from quant_gemm_tpu.models import llama as jl
from quant_gemm_tpu.models import serve as js
from quant_gemm_tpu.ops import attention as jattn
from quant_gemm_tpu_torch.formats import quant as tq
from quant_gemm_tpu_torch.formats.blocks import Q8_1Tensor
from quant_gemm_tpu_torch.kernels import layout, registry
from quant_gemm_tpu_torch.kernels.gemm_exact import (block_terms,
                                                     gemm_exact,
                                                     gemm_exact_plain,
                                                     k1_order, k1_warps)
from quant_gemm_tpu_torch.models import llama as tl
from quant_gemm_tpu_torch.models import serve as ts
from quant_gemm_tpu_torch.ops import attention as ta

SMS = 132
LOGIT_TOL = 2e-2  # tests/test_torch_model.py


# --- K3: the piece count and the cut ---

@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, 300, 4095, 4096])
@pytest.mark.parametrize("ns", [1, 2, 3, 5, 8, 64])
def test_decode_piece_bounds_cover_the_interval(length, ns):
    """The pieces are [u0, u1) of whole tiles, in order, end to end, and
    cover the interval exactly; pieces past it are empty at its end."""
    bounds = ta.decode_piece_bounds(length, ns)
    assert len(bounds) == ns
    assert bounds[0][0] == 0 and bounds[-1][1] == length
    for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
        assert a1 == b0
    for u0, u1 in bounds:
        assert u0 <= u1
        for u in (u0, u1):  # a tile boundary, or the interval's end
            assert u == length or u % ta.DECODE_TILE == 0


SHAPES = [  # b, kv, rep, window, slots, s_hi
    (8, 4, 8, 0, 2048, None), (8, 4, 8, 0, 2048, 256),
    (8, 4, 8, 0, 2048, 512), (8, 4, 8, 256, 2048, None),
    (8, 8, 4, 4096, 4608, None), (1, 8, 4, 4096, 4608, None),
    (5, 2, 8, 0, 300, None), (7, 2, 4, 200, 256, None),
    (2, 2, 32, 0, 8192, None), (3, 1, 1, 1, 1, None)]


@pytest.mark.parametrize("b, kv, rep, window, slots, s_hi", SHAPES)
def test_decode_pieces_none_empty_at_the_longest_span(b, kv, rep, window,
                                                      slots, s_hi):
    ns = ta.decode_pieces(b, kv, rep, window, slots, s_hi)
    span = ta.decode_span(window, slots, s_hi)
    assert 1 <= ns <= ta.decode_max_pieces(window, slots, s_hi)
    assert all(u1 > u0 for u0, u1 in ta.decode_piece_bounds(span, ns))


@pytest.mark.parametrize("s_hi", [256, 512])
def test_decode_pieces_one_launch_at_short_tinyllama_buckets(s_hi):
    """TinyLlama-1.1B width (8 slots, 4 kv heads of 8 query rows, a
    2048-slot cache) below the Server's 256 and 512 buckets: one piece,
    so K3 writes the output itself in one launch."""
    assert ta.decode_pieces(8, 4, 8, 0, 2048, s_hi) == 1


def test_decode_pieces_fill_the_card_at_the_mistral_ring():
    """Mistral-7B-v0.1 on the ring (8 slots, 8 kv heads of 4 rows, window
    4096, R = 4608): at least two blocks per SM of the H100."""
    ns = ta.decode_pieces(8, 8, 4, 4096, 4608)
    assert 8 * 8 * ns >= 2 * SMS


@pytest.mark.parametrize("max_ctx", [0, 1, 48, 255, 256, 300, 511, 512,
                                     4096])
def test_decode_s_hi_is_the_jax_bucket(max_ctx):
    assert ta.decode_s_hi(max_ctx) == jattn.decode_ts_bucket(max_ctx)[1]


# --- K3: the split over the walk, merged in piece order ---

def _interval(p, cur, window, ring, s):
    """Cache slots a decode query walks, oldest first (the kernel's
    ranges)."""
    if ring:
        p_new = p + (0 if cur else 1) - 1
        cnt = min(window - (1 if cur else 0), p_new + 1)
        if cnt <= 0:
            return []
        if cnt >= ring:
            return list(range(ring))
        return [(p_new - cnt + 1 + i) % ring for i in range(cnt)]
    valid = min(max(p + (0 if cur else 1), 0), s)
    lo = max(p - window + 1, 0) if window else 0
    return list(range(lo, valid))


def _split_replay(q, k, v, pos, ks, vs, kcur, vcur, window, ring, ns):
    """K3's algorithm in float64: per (slot, kv head) the interval's
    pieces, each (max, sum, unnormalised output), merged in piece order
    by running max and sum, the current token folded last."""
    q = q.double() / np.sqrt(q.shape[-1])
    b, kvh, rep, hd = q.shape
    out = torch.zeros(b, kvh, rep, hd, dtype=torch.float64)
    neg = float(np.finfo(np.float32).min)
    for bi in range(b):
        slots = _interval(int(pos[bi]), kcur is not None, window, ring,
                          k.shape[2])
        for g in range(kvh):
            parts = []
            for u0, u1 in ta.decode_piece_bounds(len(slots), ns):
                idx = torch.tensor(slots[u0:u1], dtype=torch.long)
                if not len(idx):
                    parts.append((neg, torch.zeros(rep),
                                  torch.zeros(rep, hd)))
                    continue
                sc = q[bi, g] @ k[bi, g, idx].double().T
                w = v[bi, g, idx].double()
                if ks is not None:
                    sc = sc * ks[bi, g, idx].double()
                    w = w * vs[bi, g, idx].double()[:, None]
                m = sc.amax(-1, keepdim=True)
                p = torch.exp(sc - m)
                parts.append((m[:, 0], p.sum(-1), p @ w))
            ms = torch.stack([torch.as_tensor(m, dtype=torch.float64)
                              .expand(rep) for m, _, _ in parts])
            mm = ms.amax(0)
            wt = torch.exp(ms - mm)
            ls = sum(wt[i] * l for i, (_, l, _) in enumerate(parts))
            acc = sum(wt[i][:, None] * o for i, (_, _, o) in
                      enumerate(parts))
            if kcur is not None:
                sc = q[bi, g] @ kcur[bi, g, 0].double()
                m_new = torch.maximum(mm, sc)
                a, pc = torch.exp(mm - m_new), torch.exp(sc - m_new)
                ls = ls * a + pc
                acc = acc * a[:, None] + pc[:, None] * \
                    vcur[bi, g, 0].double()
            out[bi, g] = acc / torch.where(ls > 0, ls, 1.0)[:, None]
    return out


@pytest.mark.parametrize("pieces", ["one", "chosen", "three", "most"])
@pytest.mark.parametrize("quant, current", [(False, True), (True, True),
                                            (False, False), (True, False)])
@pytest.mark.parametrize("ring, window", [(256, 200), (0, 0), (0, 40)])
def test_split_merge_replay_matches_plain(ring, window, quant, current,
                                          pieces):
    """Rings that wrap (positions 0 .. 1000 over R = 256, window 200),
    the linear cache with and without a window, empty pieces (short
    slots under a wide cut), with and without the current token."""
    rng = np.random.default_rng(21)
    b, kv, rep, hd = 7, 2, 4, 64
    s = ring + 32 if ring else 300
    q = torch.from_numpy(rng.standard_normal((b, kv, rep, hd))
                         .astype(np.float32))
    if quant:
        k, v = (torch.from_numpy(rng.integers(-127, 128, (b, kv, s, hd))
                                 .astype(np.int8)) for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(0.005, 0.03, (b, kv, s))
                                   .astype(np.float32)) for _ in range(2))
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = (torch.from_numpy(rng.standard_normal((b, kv, s, hd))
                                 .astype(np.float32)).to(torch.bfloat16)
                for _ in range(2))
        ks = vs = None
        kw = {}
    kcur = vcur = None
    if current:
        kcur, vcur = (torch.from_numpy(rng.standard_normal((b, kv, 1, hd))
                                       .astype(np.float32))
                      .to(torch.bfloat16) for _ in range(2))
        kw.update(k_current=kcur, v_current=vcur)
    # a stale position far past the cache: without a current token or a
    # slot in its window it has no output to compare (the kernel writes
    # 0, the dense plain version averages the cache), so the case without
    # a current token takes one just past the end
    stale = 10_000 if current else s + 10
    pos = torch.tensor([0, 5, 199, 255, 256, 300, 1000] if ring else
                       [0, 1, 31, 33, 200, s - 1, stale], dtype=torch.int32)
    slots = ring or s
    ns = {"one": 1, "three": 3, "chosen": ta.decode_pieces(
        b, kv, rep, window, slots), "most": ta.decode_max_pieces(
        window, slots)}[pieces]
    kc, vc = (k[:, :, :ring] if ring else k), (v[:, :, :ring] if ring else v)
    got = _split_replay(q, kc, vc, pos, ks, vs, kcur, vcur, window, ring,
                        ns)
    ref = ta.flash_decode_plain(q, k, v, pos, window=window, ring=ring, **kw)
    assert torch.isfinite(ref).all()
    tol = 1e-6 * max(1.0, ref.abs().max().item())
    assert (got - ref.double()).abs().max() <= tol


# --- K3: the int8 operands built in registers ---

def _s8_bf16(codes):
    """K3's conversion: 2^23 + (q + 128) by a byte permute, minus
    2^23 + 128, then the float32's high half as bf16."""
    u = (codes.astype(np.int32) & 0xFF) ^ 0x80
    f = (np.uint32(0x4B000000) | u.astype(np.uint32)).view(np.float32)
    f = f - np.float32(8388736.0)
    return (f.view(np.uint32) >> 16).astype(np.uint16)


def _bf16_value(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def test_int8_codes_to_bf16_exact():
    codes = np.arange(-128, 128, dtype=np.int8)
    assert np.array_equal(_bf16_value(_s8_bf16(codes)),
                          codes.astype(np.float32))


def _mma_m16n8(afrag, bfrag, kdim, per):
    """``mma.sync`` m16n8k{kdim} from its fragments (tc.cuh's layout):
    afrag[lane] = 4 registers of ``per`` values (a0: row g, k
    per*t..; a1: row g+8; a2: row g, k kdim/2 + per*t..; a3: row g+8),
    bfrag[lane] = 2 registers (b0: k per*t.., col g; b1: k kdim/2 +
    per*t..); returns C [16, 8] as float64."""
    a = np.zeros((16, kdim))
    b = np.zeros((kdim, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for f in range(4):
            row, k0 = g + 8 * (f & 1), kdim // 2 * (f >> 1) + per * t
            a[row, k0:k0 + per] = afrag[lane][f]
        for f in range(2):
            k0 = kdim // 2 * f + per * t
            b[k0:k0 + per, g] = bfrag[lane][f]
    return a @ b


def _c_frag(c, lane):
    g, t = lane // 4, lane % 4
    return [c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t],
            c[g + 8, 2 * t + 1]]


def _kappa(j, c):
    return (c >> 1) + 4 * (2 * j + (c & 1))


@pytest.mark.parametrize("hd", [64, 128])
def test_k3_int8_fragments(hd):
    """K3's int8 tile: QK^T with q's hd order permuted in groups of four
    (k pairs 2t and 2t + 8 at hd 4t, 4t+2 of each 16) and K's rows in the
    order kappa; PV with the four rows t, t+4, t+8, t+12 of a lane's
    words and the output's hd order 32 jj + 8 t + i (+4).  Both equal the
    plain products."""
    rng = np.random.default_rng(hd)
    q = rng.integers(-9, 10, (16, hd)).astype(np.float64)
    kc = rng.integers(-128, 128, (16, hd)).astype(np.int8)
    vc = rng.integers(-128, 128, (16, hd)).astype(np.int8)
    p = rng.integers(0, 7, (16, 16)).astype(np.float64)  # p[row, key]
    kb = _bf16_value(_s8_bf16(kc)).astype(np.float64)
    vb = _bf16_value(_s8_bf16(vc)).astype(np.float64)
    s = np.zeros((2, 16, 8))
    for kk in range(hd // 16):
        af = [[q[g + 8 * (f & 1), kk * 16 + 4 * (ln % 4) + 2 * (f >> 1):]
               [:2] for f in range(4)] for ln in range(32) for g in
              [ln // 4]]
        for j2 in range(2):
            bf = [[kb[_kappa(j2, ln // 4), kk * 16 + 4 * (ln % 4):][:2],
                   kb[_kappa(j2, ln // 4), kk * 16 + 4 * (ln % 4) + 2:][:2]]
                  for ln in range(32)]
            s[j2] += _mma_m16n8(af, bf, 16, 2)
    for j2 in range(2):
        for c in range(8):
            assert np.array_equal(s[j2][:, c], q @ kb[_kappa(j2, c)])
    # PV: P's A fragment from the score tiles' C fragments
    pfr = []
    for ln in range(32):
        g, t = ln // 4, ln % 4
        pfr.append([[p[g, _kappa(0, 2 * t)], p[g, _kappa(0, 2 * t + 1)]],
                    [p[g + 8, _kappa(0, 2 * t)],
                     p[g + 8, _kappa(0, 2 * t + 1)]],
                    [p[g, _kappa(1, 2 * t)], p[g, _kappa(1, 2 * t + 1)]],
                    [p[g + 8, _kappa(1, 2 * t)],
                     p[g + 8, _kappa(1, 2 * t + 1)]]])
    out = np.zeros((16, hd))
    for jj in range(hd // 32):
        for i in range(4):
            bf = []
            for ln in range(32):
                g, t = ln // 4, ln % 4
                col = 32 * jj + 4 * g + i
                w = [vb[t + 4 * r, col] for r in range(4)]
                bf.append([[w[0], w[1]], [w[2], w[3]]])
            c = _mma_m16n8(pfr, bf, 16, 2)
            for ln in range(32):
                g, t = ln // 4, ln % 4
                h = 32 * jj + 8 * t + i
                cf = _c_frag(c, ln)
                out[g, h], out[g, h + 4] = cf[0], cf[1]
                out[g + 8, h], out[g + 8, h + 4] = cf[2], cf[3]
    assert np.array_equal(out, p @ vb)


# --- K1: the int8 fragments and the summation order ---

def _bit4x(x):
    return ((x & 15) * 0x02040810) & 0x10101010


def _bytes(word):
    return [(int(word) >> (8 * i)) & 0xFF for i in range(4)]


def _weight(qtype, n, k, seed):
    base = {"q4_k": "q4_1", "q5_k": "q5_1"}.get(qtype, qtype)
    wf = np.random.default_rng(seed).normal(0, 0.05, (n, k))
    w = layout.prepare(tq.QUANTIZE[base](torch.from_numpy(
        wf.astype(np.float32))))
    if base != qtype:
        w = w._replace(qtype=qtype, d=w.d.float(), m=w.m.float())
    return w


@pytest.mark.parametrize("m", [8, 12])
@pytest.mark.parametrize("qtype", ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0",
                                   "q4_k", "q5_k"])
def test_k1_fragment_algebra(qtype, m):
    """K1's A fragment from the raw layout bytes (the low nibbles of a
    lane's 4 bytes are k 4t .., the high ones k 16+4t ..; q5 ORs in the
    fifth bits from qh; q8_0's signed bytes as stored) and its B fragment
    from the activation codes give, through m16n8k32, the exact integer
    dot of layout.codes and the codes of every block, rows and M tiles."""
    n, k = 16, 256
    w = _weight(qtype, n, k, 5)
    acts = np.random.default_rng(6).integers(-127, 128, (m, k))
    qs = w.qs.numpy().view(np.uint8).reshape(n, -1)
    qh = None if w.qh is None else w.qh.numpy().view(np.uint32)
    want = layout.codes(w).numpy().astype(np.int64).reshape(n, k // 32, 32)
    for blk in range(k // 32):
        afr = []
        for ln in range(32):
            g, t = ln // 4, ln % 4
            regs = [None] * 4
            for h in range(2):  # rows g, g + 8
                row = g + 8 * h
                if qtype == "q8_0":
                    raw = qs[row, 32 * blk:32 * blk + 32].view(np.int8)
                    regs[h] = raw[4 * t:4 * t + 4].astype(np.int64)
                    regs[2 + h] = raw[16 + 4 * t:20 + 4 * t].astype(np.int64)
                    continue
                word = int(qs[row, 16 * blk + 4 * t:16 * blk + 4 * t + 4]
                           .view(np.uint32)[0])
                lo, hi = word & 0x0F0F0F0F, (word >> 4) & 0x0F0F0F0F
                if qh is not None:
                    bits = int(qh[row, blk])
                    lo |= _bit4x(bits >> (4 * t))
                    hi |= _bit4x(bits >> (16 + 4 * t))
                regs[h], regs[2 + h] = _bytes(lo), _bytes(hi)
            afr.append(regs)
        for mt in range(-(-m // 8)):
            bfr = []
            for ln in range(32):
                g, t = ln // 4, ln % 4
                row = 8 * mt + g
                a = acts[row, 32 * blk:32 * blk + 32] if row < m else \
                    np.zeros(32, np.int64)
                bfr.append([a[4 * t:4 * t + 4], a[16 + 4 * t:20 + 4 * t]])
            c = _mma_m16n8(afr, bfr, 32, 4)
            rows = min(8, m - 8 * mt)
            assert np.array_equal(
                c[:, :rows], want[:, blk] @ acts[8 * mt:8 * mt + rows,
                                                  32 * blk:32 * blk + 32].T)


def _k1_order_scalar(terms):
    """K1's order thread by thread in float32: thread t adds
    blocks t, t + nt, ..., each warp's lane 0 after the xor butterfly,
    the warps added in order."""
    nb = terms.shape[-1]
    nt = 32 * k1_warps(nb)
    f32 = np.float32
    out = np.zeros(terms.shape[:-1], f32)
    for idx in np.ndindex(*terms.shape[:-1]):
        acc = [f32(0.0)] * nt
        for t in range(nt):
            for bb in range(t, nb, nt):
                acc[t] = f32(acc[t] + terms[idx + (bb,)])
        s = f32(0.0)
        for wg in range(nt // 32):
            v = acc[32 * wg:32 * wg + 32]
            for o in (16, 8, 4, 2, 1):
                v = [f32(v[ln] + v[ln ^ o]) for ln in range(32)]
            s = f32(s + v[0])
        out[idx] = s
    return out


def _mma_m16n8k16_s8(afrag, bfrag):
    """``mma.sync`` m16n8k16 with 8-bit operands from its fragments
    (tc.cuh's layout): afrag[lane] = 2 registers of 4 values (a0: row g,
    k 4t..4t+3; a1: row g+8), bfrag[lane] = 1 register (k 4t.., col g);
    returns C [16, 8]."""
    a = np.zeros((16, 16), np.int64)
    b = np.zeros((16, 8), np.int64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for h in range(2):
            a[g + 8 * h, 4 * t:4 * t + 4] = afrag[lane][h]
        b[4 * t:4 * t + 4, g] = bfrag[lane]
    return a @ b


@pytest.mark.parametrize("qtype", ["q6_K", "q3_K", "q2_K"])
def test_k7_sub_block_fragments(qtype):
    """K7 loads a 32-block's int8 codes as K1 loads q8_0's; the halves of
    that m16n8k32 fragment, (a0, a1, b0) and (a2, a3, b1), through two
    m16n8k16, give each 16-element sub-block's exact dot sumi_j, and an A
    fragment of ones gives q2_K's sumq_j, the sum of the sub-block's
    activation codes."""
    from quant_gemm_tpu_torch.formats import kquants as tk

    w = layout.prepare_k16(tk.random_blocks(
        qtype, 16, 512, 0.05, torch.Generator().manual_seed(6)))
    qs = w.qs.numpy().astype(np.int64)
    acts = np.random.default_rng(7).integers(-127, 128, (8, 512))
    ones = [np.ones(4, np.int64)] * 2
    for blk in range(512 // 32):
        afr, bfr = [], []
        for ln in range(32):
            g, t = ln // 4, ln % 4
            regs = [None] * 4
            for h in range(2):
                raw = qs[g + 8 * h, 32 * blk:32 * blk + 32]
                regs[h] = raw[4 * t:4 * t + 4]
                regs[2 + h] = raw[16 + 4 * t:20 + 4 * t]
            afr.append(regs)
            a = acts[g, 32 * blk:32 * blk + 32]
            bfr.append([a[4 * t:4 * t + 4], a[16 + 4 * t:20 + 4 * t]])
        for s in range(2):
            k0 = 32 * blk + 16 * s
            c = _mma_m16n8k16_s8([r[2 * s:2 * s + 2] for r in afr],
                                 [r[s] for r in bfr])
            assert np.array_equal(c, qs[:, k0:k0 + 16] @ acts[:, k0:k0 + 16].T)
            c = _mma_m16n8k16_s8([ones] * 32, [r[s] for r in bfr])
            assert np.array_equal(c, np.broadcast_to(
                acts[:, k0:k0 + 16].sum(-1), (16, 8)))


@pytest.mark.parametrize("nb", [1, 5, 32, 33, 64, 100, 128, 176, 448])
def test_k1_order_replays_k1_rows(nb):
    """The vectorised k1_order equals the scalar replay bit for bit, at
    every warp count and with blocks left over past nt."""
    rng = np.random.default_rng(nb)
    terms = (rng.standard_normal((2, 3, nb)) * 10.0 ** rng.integers(
        -3, 4, (2, 3, nb))).astype(np.float32)
    got = k1_order(torch.from_numpy(terms)).numpy()
    assert np.array_equal(got.view(np.uint32),
                          _k1_order_scalar(terms).view(np.uint32))


@pytest.mark.parametrize("m", [8, 3])
def test_k1_order_matches_plain_and_jax(m):
    """q4_0 at N = 512, K = 1024: k1_order of the plain terms against the
    plain sum and the JAX kernel in interpret mode."""
    rng = np.random.default_rng(11)
    wf = rng.normal(0, 0.05, (512, 1024)).astype(np.float32)
    w = layout.prepare(tq.quantize_q4_0(torch.from_numpy(wf)))
    x = np.random.default_rng(m).standard_normal((m, 1024)).astype(
        np.float32)
    a_np = jnr.quantize_q8_1(x)
    a = Q8_1Tensor(*(torch.from_numpy(np.asarray(t)) for t in a_np))
    got = k1_order(block_terms(w, a))
    plain = gemm_exact_plain(w, a)
    assert torch.equal(plain, gemm_exact(w, a))
    assert ((got.double() - plain.double()) ** 2).sum() \
        <= 1e-10 * (plain.double() ** 2).sum()
    want = np.asarray(j_gemm_exact(j_prepare(jnr.quantize_q4_0(wf)),
                                   jq.device_put(a_np)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# --- s_hi through forward and the Server ---

JCFG = jl.LlamaConfig(vocab=256, dim=512, n_layers=2, n_heads=8,
                      n_kv_heads=2, d_ff=1024, max_seq=128)
TCFG = tl.LlamaConfig(**JCFG._asdict())


@pytest.fixture(scope="module")
def models():
    params = jl.init_params(JCFG, seed=3)
    return jl.quantize_params(params), tl.quantize_params(params,
                                                          device="cpu")


class _Seen:
    """Ops that record flash_decode's s_hi and run the plain versions."""

    def __init__(self):
        self.s_hi = []

    def ops(self):
        def fd(*a, **kw):
            self.s_hi.append(kw.get("s_hi"))
            return registry.PLAIN.flash_decode(*a, **kw)
        return registry.PLAIN._replace(flash_decode=fd)


def test_forward_with_s_hi_same_logits(models):
    """A decode step with the Server's bound gives the logits of the step
    without it, and every layer's K3 call receives the bound."""
    _, qt = models
    rng = np.random.default_rng(4)
    cache = tl.KVCache.init(TCFG, 3, device="cpu")
    tl.forward(qt, TCFG, torch.from_numpy(rng.integers(0, 256, (3, 40))),
               cache)
    tok = torch.from_numpy(rng.integers(0, 256, (3, 1)))
    seen = _Seen()
    got, _ = tl.forward(qt, TCFG, tok, cache.clone(), s_hi=256,
                        ops=seen.ops())
    want, _ = tl.forward(qt, TCFG, tok, cache.clone())
    assert torch.equal(got, want)
    assert seen.s_hi == [256] * TCFG.n_layers


def test_server_passes_s_hi_and_matches_jax_server(models, monkeypatch):
    """Two greedy requests (48 and 100 prompt tokens): every decode step
    carries JAX's bucket (256 below 256 cached tokens), and the port's
    transcripts follow the JAX Server's under the near-tie rule."""
    qj, qt = models
    rng = np.random.default_rng(7)
    prompts = [[int(x) for x in rng.integers(0, 256, n)] for n in (48, 100)]
    news = (7, 5)
    calls = []
    fwd = tl.forward

    def forward(*a, **kw):
        if a[2].shape[1] == 1:
            calls.append(kw.get("s_hi"))
        return fwd(*a, **kw)

    monkeypatch.setattr(ts.llama, "forward", forward)
    srv_j = js.Server(qj, JCFG, n_slots=2, max_prefill_chunk=48,
                      prefill_bucket=16, cache_prompt=False)
    srv_t = ts.Server(qt, TCFG, n_slots=2, max_prefill_chunk=48,
                      prefill_bucket=16, cache_prompt=False, device="cpu")
    for srv in (srv_j, srv_t):
        for p, n in zip(prompts, news):
            srv.submit(p, max_new=n)
    out_j, out_t = srv_j.run_until_done(), srv_t.run_until_done()
    assert calls and all(s == 256 for s in calls)
    assert len(calls) == srv_t.stats()["decode_steps"]
    monkeypatch.undo()
    for rid, (p, n) in enumerate(zip(prompts, news)):
        assert len(out_t[rid]) == len(out_j[rid]) == n
        cache = tl.KVCache.init(TCFG, 1, device="cpu")
        for off in range(0, len(p), 48):
            logits, cache = tl.forward(qt, TCFG, torch.tensor([p[off:off
                                                                 + 48]]),
                                       cache)
        steps = [logits[0, -1]]
        for tok in out_j[rid][:-1]:
            logits, cache = tl.forward(qt, TCFG, torch.tensor([[tok]]),
                                       cache)
            steps.append(logits[0, -1])
        along = torch.stack(steps)
        picked = along[torch.arange(n), torch.tensor(out_j[rid])]
        slack = along.amax(-1) - picked
        assert (slack <= 2 * LOGIT_TOL * along.abs().amax(-1)).all()
        if not slack.any():
            assert out_t[rid] == out_j[rid]


def test_flash_decode_cpu_ignores_the_grid_options():
    """On CPU tensors the plain version runs whatever s_hi and pieces
    say (they shape the kernel's grid only); the wrapper refuses
    s_hi < 1."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 64)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 1, 80, 64)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    pos = torch.tensor([10, 79], dtype=torch.int32)
    want = ta.flash_decode_plain(q, k, v, pos)
    assert torch.equal(ta.flash_decode(q, k, v, pos, s_hi=256, pieces=2),
                       want)
    with pytest.raises(ValueError):
        ta.flash_decode(q, k, v, pos, s_hi=0)
