"""The arithmetic the prefill kernels K4 ``gemm_dequant`` and K5
``flash_prefill`` compute on the tensor cores, on the CPU, and the pure
functions their wrappers use to shape the grid.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``
holds them to their plain versions there); here the algebra they rely on
is replayed in PyTorch on the CPU and held to the plain versions and to
the JAX package.  Inputs are made with numpy from a seed.  Tolerances:

* K4's exact per-block scaling, sum over blocks b of ``d_b * (A_b . (q -
  off)) + m_b * sum(A_b)`` from the raw code bytes and planes of each of
  the seven per-32 forms: NMSE <= 1e-10 against ``gemm_dequant_plain``
  (the same float32 products; only the order of the float32 sums
  differs: about 1e-14), and ``1e-5 * max|C|`` against JAX ``gemm`` with
  ``mxu_dtype=float32`` in interpret mode (K4's plain-version tolerance);
* the code-to-bf16 conversion (``0x4300 | q`` minus ``128 + off``): bit
  for bit;
* K4's float32 operands as three bf16 pieces (:func:`split3`, the
  prologue's arithmetic): ``hi + mid + lo == a`` bit for bit wherever the
  pieces stay normal in bf16 (``|a| >= 2^-103``, draws at 2^-100 to
  2^100 and fake-quantized blocks, zero and f16-saturating ones
  included), every ``piece * code`` product exact for the codes of the
  seven forms; the three-piece body replayed (per-block ``T_b`` in
  float64, rounded to float32 as the accumulator holds it, then the
  float32 ``fma`` with ``d`` and with ``m * sa``): NMSE <= 1e-12 against
  ``gemm_dequant_plain`` (only the float32 summation order differs) and
  ``1e-5 * max|C|`` against JAX ``gemm`` with ``mxu_dtype=float32``
  (``Precision.HIGHEST``) in interpret mode;
* K5's hi + lo operands, ``hi = bf16(x)``, ``lo = bf16(x - hi)``: within
  ``2^-16`` of ``|x|`` (the split leaves at most ``2^-17``), and a dot
  product of hi + lo with bf16 values within ``2^-16`` of the sum of
  ``|x| |k|``;
* K5's merge of split-S pieces by running max and sum, with pieces that
  no row attends (max ``-FLT_MAX``, sum 0): ``1e-6`` against one pass over
  the whole interval.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_gemm_tpu.formats import kquants as jk
from quant_gemm_tpu.formats import numpy_ref as jnr
from quant_gemm_tpu.kernels.gemm_pallas import gemm as j_gemm
from quant_gemm_tpu.kernels.gemm_pallas import prepare as j_prepare
from quant_gemm_tpu_torch.formats import kquants as tk
from quant_gemm_tpu_torch.formats import quant as tq
from quant_gemm_tpu_torch.kernels import layout
from quant_gemm_tpu_torch.kernels.gemm_dequant import (MIN_CHUNK, SMS,
                                                       fake_quant_q8,
                                                       gemm_dequant,
                                                       gemm_dequant_plain,
                                                       k4_grid, pieces,
                                                       split3)
from quant_gemm_tpu_torch.ops.attention import (NEG_INF, PREFILL_ROWS,
                                                PREFILL_TILE,
                                                prefill_piece_bounds,
                                                prefill_pieces)

M, N, K = 8, 256, 1024
ALL32 = ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "q4_k", "q5_k"]
OFFSET = {"q4_0": 8, "q5_0": 16}


def _weights(qtype: str):
    """(JAX container, port PreparedWeight) of one [N, K] weight; q4_k and
    q5_k in their effective forms from the JAX encoders."""
    w = np.random.default_rng(21).normal(0, 0.05, (N, K)).astype(np.float32)
    if qtype in ("q4_k", "q5_k"):
        if qtype == "q4_k":
            jt, to_j, cls, to_t = (jk.quantize_q4_k(w), jk.to_effective,
                                   tk.Q4_KTensor, tk.to_effective)
        else:
            jt, to_j, cls, to_t = (jk.quantize_q5_k(w), jk.to_effective_q5_k,
                                   tk.Q5_KTensor, tk.to_effective_q5_k)
        pt = cls(*(torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
                   for a in jt))
        return to_j(jt), layout.prepare(to_t(pt))
    return (jnr.QUANTIZE[qtype](w),
            layout.prepare(tq.QUANTIZE[qtype](torch.from_numpy(w))))


def _raw_codes(w) -> torch.Tensor:
    """[N, nb, 32] integer codes from the kernel layout's bytes: byte j of
    a 4-bit block holds code j (low nibble) and code j + 16 (high), the
    fifth bit j of a q5 block is bit j of its qh word; q8_0 is int8."""
    nb = w.k // 32
    if w.qtype == "q8_0":
        return w.qs.reshape(w.n, nb, 32).to(torch.int32)
    b = w.qs.reshape(w.n, nb, 16).to(torch.int32)
    q = torch.cat([b & 15, b >> 4], dim=-1)
    if w.qh is not None:
        bit = torch.arange(32, dtype=torch.int32)
        q = q | (((w.qh.to(torch.int32)[..., None] >> bit) & 1) << 4)
    return q


def _block_scaled(w, a: torch.Tensor) -> torch.Tensor:
    """K4's per-block algebra in float32: T_b = A_b . (q - off) (exact:
    bf16 values times small integers), acc += d_b T_b, and for the min
    formats acc += m_b sum(A_b), block by block as the kernel folds."""
    nb = w.k // 32
    q = (_raw_codes(w) - OFFSET.get(w.qtype, 0)).to(torch.float32)
    ab = a.to(torch.float32).reshape(a.shape[0], nb, 32)
    d = w.d.to(torch.float32)
    acc = torch.zeros(a.shape[0], w.n, dtype=torch.float32)
    for b in range(nb):
        t = ab[:, b] @ q[:, b].T
        acc = acc + d[:, b] * t
        if w.m is not None:
            acc = acc + w.m.to(torch.float32)[:, b] * ab[:, b].sum(-1,
                                                                    True)
    return acc


def _nmse(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float(((got - ref) ** 2).sum() / (ref ** 2).sum())


@pytest.mark.parametrize("qtype", ALL32)
def test_k4_block_scaling_matches_plain_and_jax(qtype):
    jw, pw = _weights(qtype)
    x = np.random.default_rng(5).standard_normal((M, K)).astype(np.float32)
    a = torch.from_numpy(x).to(torch.bfloat16)
    got = _block_scaled(pw, a)
    assert _nmse(got, gemm_dequant_plain(pw, a)) <= 1e-10
    assert torch.equal(gemm_dequant(pw, a), gemm_dequant_plain(pw, a))
    want = np.asarray(j_gemm(j_prepare(jw), jnp.asarray(a.float().numpy()),
                             mxu_dtype=jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("off", [0, 8, 16])
def test_k4_code_to_bf16_is_exact(off):
    """``0x4300 | q`` is the bf16 of 128 + q for q in 0..31, and
    subtracting the bf16 of 128 + off leaves q - off exactly; int8 codes
    go through float exactly."""
    q = torch.arange(32, dtype=torch.int32)
    v = (0x4300 | q).to(torch.int16).view(torch.bfloat16)
    assert torch.equal(v.float(), 128.0 + q.float())
    bias = torch.tensor(128 + off, dtype=torch.bfloat16)
    assert torch.equal((v - bias).float(), (q - off).float())
    c = torch.arange(-128, 128, dtype=torch.int32)
    assert torch.equal(c.float().to(torch.bfloat16).float(), c.float())


def _exact_sum(parts) -> torch.Tensor:
    return sum(p.double() for p in parts)


def _draws():
    """float32 values at scales 2^-100 .. 2^100, signed, with zeros, and
    fake-quantized rows (an all-zero block, f16-saturating blocks)."""
    rng = np.random.default_rng(31)
    x = np.concatenate([rng.standard_normal(4096) * 2.0 ** e
                        for e in range(-100, 101, 10)]).astype(np.float32)
    x[::97] = 0.0
    a = rng.standard_normal((8, 256)).astype(np.float32) * 4.0
    a[0, :32], a[1, 32:64], a[2, 64:96] = 0.0, 7e8, -7e8
    a[3] *= 1e-30
    fq = fake_quant_q8(torch.from_numpy(a)).reshape(-1)
    return torch.cat([torch.from_numpy(x), fq])


def test_k4_split3_is_exact():
    """Exact wherever the pieces stay normal: ``a == 0`` or ``|a| >=
    2^-103`` (2^-126, the least normal, over the 23 bits below hi)."""
    a = _draws()
    a = a[(a == 0) | (a.abs() >= 2.0 ** -103)]
    hi, mid, lo = split3(a)
    assert torch.equal(_exact_sum((hi, mid, lo)), a.double())
    # the pieces stay normal in bf16 (or are zero)
    tiny = torch.finfo(torch.float32).tiny
    for p in (hi, mid, lo):
        f = p.float().abs()
        assert bool(((f == 0) | (f >= tiny)).all())
    # the tensor cores' float32 sum of lo, mid, hi in that order is exact
    assert torch.equal((lo.float() + mid.float()) + hi.float(), a)
    # a bf16 operand is its own hi: mid and lo are zero
    b = a.to(torch.bfloat16)
    h, m, lo_ = split3(b.float())
    assert torch.equal(h, b) and not m.float().any() and not lo_.float().any()


CODES = {"q4_0": range(-8, 8), "q5_0": range(-16, 16), "q4_1": range(16),
         "q4_k": range(16), "q5_1": range(32), "q5_k": range(32),
         "q8_0": range(-128, 128)}


@pytest.mark.parametrize("qtype", ALL32)
def test_k4_piece_times_code_is_exact(qtype):
    """Every product of a piece (8 significant bits) and a code of the
    form (at most 8) is exact in float32, as the MMA forms it."""
    code = torch.tensor(list(CODES[qtype]), dtype=torch.float32)
    for p in split3(_draws()):
        f = p.float()[::7]
        prod = f[:, None] * code[None, :]
        assert torch.equal(prod.double(), f.double()[:, None]
                           * code.double()[None, :])


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """float32 fma: the product and the sum rounded once (float64 holds
    the float32 product exactly)."""
    return (a.double() * b.double() + c.double()).float()


def _block_sums(a: torch.Tensor) -> torch.Tensor:
    """The prologue's sa: each lane's 8 values in order, then the lanes
    xor 1 and xor 2 of a 32-block, in float32."""
    lanes = a.reshape(a.shape[0], -1, 4, 8)
    s = lanes[..., 0]
    for i in range(1, 8):
        s = s + lanes[..., i]
    s = s + s[..., [1, 0, 3, 2]]
    return s + s[..., [2, 3, 0, 1]]  # [M, nb, 4]; lane 0's in [..., 0]


def _three_piece_body(w, a32: torch.Tensor) -> torch.Tensor:
    """The float32-operand body on the CPU: per quant block T_b = sum of
    the pieces' products with the codes (float64, then float32 as the MMA
    accumulator holds it), acc = fma(d, T_b, acc), and for the min
    formats acc = fma(m, sa, acc), block by block."""
    nb = w.k // 32
    q = (_raw_codes(w) - OFFSET.get(w.qtype, 0)).double()  # [N, nb, 32]
    pcs = sum(p.double() for p in split3(a32)).reshape(a32.shape[0], nb, 32)
    sa = _block_sums(a32)[..., 0]
    d = w.d.to(torch.float32)
    acc = torch.zeros(a32.shape[0], w.n, dtype=torch.float32)
    for b in range(nb):
        tb = (pcs[:, b] @ q[:, b].T).float()
        acc = _fma32(d[:, b][None, :], tb, acc)
        if w.m is not None:
            acc = _fma32(w.m.to(torch.float32)[:, b][None, :],
                         sa[:, b][:, None], acc)
    return acc


@pytest.mark.parametrize("fq", [False, True])
@pytest.mark.parametrize("qtype", ALL32)
def test_k4_three_pieces_match_plain_and_jax(qtype, fq):
    """A float32 operand (f32 A, or fused_quant into float32) through the
    three-piece body, against the plain version and JAX's HIGHEST."""
    jw, pw = _weights(qtype)
    x = np.random.default_rng(6).standard_normal((M, K)).astype(np.float32)
    a = torch.from_numpy(x)
    assert pieces(a, fq, torch.float32) == 3
    op = fake_quant_q8(a) if fq else a
    got = _three_piece_body(pw, op)
    ref = gemm_dequant_plain(pw, a, fused_quant=fq, a_dtype=torch.float32)
    assert _nmse(got, ref) <= 1e-12
    want = np.asarray(j_gemm(j_prepare(jw), jnp.asarray(x),
                             mxu_dtype=jnp.float32, fused_quant=fq))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _split(x: torch.Tensor):
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_k5_hi_lo_split(scale):
    """q and p as hi + lo bf16 pairs reproduce float32 to 2^-16."""
    g = np.random.default_rng(int(scale * 1000))
    x = torch.from_numpy((g.standard_normal(4096) * scale).astype(np.float32))
    hi, lo = _split(x)
    rec = hi.float() + lo.float()
    assert ((rec - x).abs() <= 2.0 ** -16 * x.abs()).all()
    # q . k with k exact in bf16: two products per term, float32 sums
    q = x.reshape(32, 128)
    k = torch.from_numpy(g.standard_normal((64, 128)).astype(
        np.float32)).to(torch.bfloat16).float()
    qh, ql = _split(q)
    two = qh.float() @ k.T + ql.float() @ k.T
    exact = q.double() @ k.double().T
    bound = 2.0 ** -16 * (q.abs().double() @ k.abs().double().T)
    assert ((two.double() - exact).abs() <= bound).all()


def _merge(ms, ls, os):
    """K5's merge kernel: pieces combined in order by running max and
    sum, the division guarded at l > 0."""
    mx = torch.stack(ms).amax(0)
    num = torch.zeros_like(os[0])
    den = torch.zeros_like(ls[0])
    for m, l, o in zip(ms, ls, os):
        w = torch.exp(m - mx)
        den = den + l * w
        num = num + o * w[:, None]
    return num / torch.where(den > 0, den, 1.0)[:, None]


def _piece(s, v, lo, hi):
    """One piece's (max, sum, unnormalised output) over slots [lo, hi),
    masked slots holding NEG_INF, as the kernel leaves them."""
    sp = s[:, lo:hi]
    m = sp.amax(-1) if hi > lo else torch.full((s.shape[0],), NEG_INF)
    m = torch.maximum(m, torch.tensor(NEG_INF))
    p = torch.where(sp == NEG_INF, 0.0, torch.exp(sp - m[:, None]))
    return m, p.sum(-1), p @ v[lo:hi]


@pytest.mark.parametrize("ns", [1, 3, 5])
def test_k5_split_s_merge(ns):
    """Pieces whose slots no row attends (m = -FLT_MAX, l = 0) weigh
    nothing; a row that attends nothing gives 0, as one pass does."""
    g = np.random.default_rng(ns)
    length = 200
    s = torch.from_numpy(g.standard_normal((6, length)).astype(np.float32))
    v = torch.from_numpy(g.standard_normal((length, 16)).astype(np.float32))
    s[:, 130:] = NEG_INF  # the causal bound: the last pieces see nothing
    s[2, :40] = NEG_INF
    s[5] = NEG_INF  # a row that attends no slot
    pieces = [_piece(s, v, lo, hi)
              for lo, hi in prefill_piece_bounds(length, ns)]
    got = _merge(*zip(*pieces))
    keep = s != NEG_INF
    p = torch.softmax(torch.where(keep, s, NEG_INF), -1) * keep
    want = p @ v
    assert torch.allclose(got, want, rtol=0, atol=1e-6)
    assert torch.equal(got[5], torch.zeros(16))


TINY = {"wqkv": (2560, 2048), "wo": (2048, 2048), "wgu": (11264, 2048),
        "w_down": (2048, 5632), "lm_head": (32000, 2048)}
MISTRAL = {"wqkv": (6144, 4096), "wo": (4096, 4096), "wgu": (28672, 4096),
           "w_down": (4096, 14336), "lm_head": (32000, 4096)}
Q4KM = {"wq": (2048, 2048), "wk": (256, 2048)}


@pytest.mark.parametrize("n, k", [*TINY.values(), *MISTRAL.values(),
                                  *Q4KM.values()])
def test_k4_grid_fills_the_card(n, k):
    """At the serving chunk (M = 128) every main-path shape gives at
    least SMS blocks; the K pieces cover the blocks once, none empty."""
    (tn, tm, pieces), chunk = k4_grid(128, n, k)
    assert tn * tm * pieces >= SMS
    nb = k // 32
    bounds = [(z * chunk, min(nb, (z + 1) * chunk)) for z in range(pieces)]
    assert all(hi > lo for lo, hi in bounds)
    assert bounds[0][0] == 0 and bounds[-1][1] == nb
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert pieces == 1 or chunk >= MIN_CHUNK


@pytest.mark.parametrize("m", [1, 13, 100, 128, 300])
def test_k4_grid_ragged(m):
    (tn, tm, pieces), chunk = k4_grid(m, 2560 + 96, 1056)
    assert (tn, tm) == (-(-2656 // 64), -(-m // 64))
    assert (pieces - 1) * chunk < 33 <= pieces * chunk


def test_k4_body_by_operand_type():
    """Every operand type takes the tensor-core body: a bf16 operand as
    one bf16 piece, a float32 operand (f32 A, or fused_quant into float32
    from an f32 or a bf16 A) as three."""
    a16 = torch.zeros(2, 32, dtype=torch.bfloat16)
    a32 = torch.zeros(2, 32)
    assert pieces(a16, False, torch.bfloat16) == 1
    assert pieces(a32, False, torch.bfloat16) == 3
    assert pieces(a32, True, torch.bfloat16) == 1
    assert pieces(a16, True, torch.bfloat16) == 1
    assert pieces(a32, True, torch.float32) == 3
    assert pieces(a16, True, torch.float32) == 3


def _interval_bound(rows, rep, window, slots):
    tokens = min(rows // rep, (PREFILL_ROWS - 1) // rep + 2)
    return min(slots, window + tokens - 1) if window else slots


@pytest.mark.parametrize("b, kv, t, rep, window, slots", [
    (1, 8, 128, 4, 4096, 4608),   # the Mistral-7B ring chunk
    (1, 8, 256, 4, 4096, 4608),   # a full ring_chunk
    (1, 4, 128, 8, 0, 2048),      # TinyLlama, the linear cache
    (3, 2, 72, 8, 40, 300),
    (3, 2, 37, 4, 0, 300),
    (8, 4, 64, 8, 0, 2048),
])
def test_k5_pieces(b, kv, t, rep, window, slots):
    """NS from host-known sizes: pieces cover the longest interval a row
    tile can walk once, none empty there; at least two blocks an SM where
    the interval has the tiles for it."""
    rows = t * rep
    ns = prefill_pieces(b, kv, rows, rep, window, slots)
    span = _interval_bound(rows, rep, window, slots)
    bounds = prefill_piece_bounds(span, ns)
    assert len(bounds) == ns and bounds[0][0] == 0 and bounds[-1][1] == span
    assert all(hi > lo for lo, hi in bounds)
    assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))
    assert all(lo % PREFILL_TILE == 0 for lo, _ in bounds)
    blocks = b * kv * -(-rows // PREFILL_ROWS) * ns
    tiles = -(-span // PREFILL_TILE)
    assert blocks >= min(2 * SMS, b * kv * -(-rows // PREFILL_ROWS) * tiles)


def test_k5_pieces_at_the_mistral_ring_chunk():
    """B 1, KV 8, T 128, rep 4, window 4096, R 4608: 64 tiles of rows,
    NS >= 4, and the grid holds at least one block per SM."""
    ns = prefill_pieces(1, 8, 128 * 4, 4, 4096, 4608)
    assert ns >= 4
    assert 1 * 8 * (128 * 4 // PREFILL_ROWS) * ns >= SMS


def test_k5_piece_bounds_past_a_short_interval():
    """At run time a row tile's interval may be shorter than the host's
    bound (pos0 = 0): the pieces past it are empty, the rest cover it."""
    bounds = prefill_piece_bounds(100, 5)
    assert bounds[0] == (0, 64) and bounds[1] == (64, 100)
    assert all(lo == hi == 100 for lo, hi in bounds[2:])
    assert prefill_piece_bounds(0, 3) == [(0, 0)] * 3
