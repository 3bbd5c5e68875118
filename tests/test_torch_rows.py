"""The row plan of K9 ``rms_norm_pallas`` and K10 ``softmax_pallas``
(``ops/rows.py``) and the kernels' reduction order, on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py`` holds
them there to their plain versions and, bit for bit, to
``rows.ordered_sum``); here the plan is checked to cover every element of
every row exactly once within the kernels' limits, and the kernels'
arithmetic is replayed in float32 (the sum of squares or of ``exp(x -
m)`` in the plan's order: a thread's slots, its chunks, the row's lanes,
warps and cluster ranks) and held to the plain versions and to the JAX
package's ``rms_norm_pallas`` / ``softmax_pallas`` in interpret mode.
Inputs are made with numpy from a seed.  Tolerances: K9 ``1e-5 *
max|y|``, K10 ``1e-6``, those chip_smoke.py holds the kernels to (the
sums are taken in other float32 orders).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_gemm_tpu_torch.formats.quant import div
from quant_gemm_tpu_torch.ops import rows
from quant_gemm_tpu_torch.ops.rms_norm import (EPS_DEFAULT,
                                               rms_norm_pallas_plain, rsqrt)
from quant_gemm_tpu_torch.ops.softmax import softmax_pallas_plain

jrms = importlib.import_module("quant_gemm_tpu.ops.rms_norm")
jsm = importlib.import_module("quant_gemm_tpu.ops.softmax")

RS = (1, 5, 7, 8, 128, 300, 4096)
CS = (1, 33, 512, 1000, 1001, 4096, 4608, 32000, 300000)


def _holders(p: rows.RowPlan, c: int) -> np.ndarray:
    """How many (rank, thread, slot) of a row hold each element, the
    mapping ``csrc/rows.cuh`` documents."""
    nv = -(-c // p.vec)
    k = np.arange(p.cluster)[:, None, None]
    t = np.arange(p.tpr)[None, :, None]
    j = np.arange(p.per)[None, None, :]
    vi = k * p.span + t + j * p.tpr
    held = vi < np.minimum((k + 1) * p.span, nv)
    el = (vi[held][:, None] * p.vec + np.arange(p.vec)).ravel()
    assert el.max() < c  # a held vector lies inside the row
    return np.bincount(el, minlength=c)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("c", CS)
@pytest.mark.parametrize("r", RS)
def test_plan_covers_every_element_once(r, c, aligned):
    p = rows.plan(r, c, aligned)
    assert np.array_equal(_holders(p, c), np.ones(c, np.int64))
    # every row in exactly one block (one cluster)
    if p.cluster > 1:
        assert p.rows == 1 and p.grid(r) == r * p.cluster
    else:
        assert (p.grid(r) - 1) * p.rows < r <= p.grid(r) * p.rows
    # the kernels' limits (rows.cuh::valid)
    assert 1 <= p.cluster <= rows.CLUSTER_MAX
    block = p.rows * p.tpr
    assert block <= rows.BLOCK_MAX and block % 32 == 0
    assert (p.tpr <= 32 and p.tpr & (p.tpr - 1) == 0) or p.tpr % 32 == 0
    assert p.stream == (c > rows.CLUSTER_MAX * rows.BLOCK_MAX * rows.REGS)
    if not p.stream:
        assert p.per * p.vec <= rows.REGS  # the row in registers
    else:
        assert p.cluster == rows.CLUSTER_MAX and p.tpr == rows.BLOCK_MAX
    assert p.vec == (4 if aligned and c % 4 == 0 else 1)
    assert (p.cluster - 1) * p.span < -(-c // p.vec)  # no empty CTA


def test_plan_splits_few_long_rows_over_clusters():
    """A decode step's 8 x 32000 logits: 8 rows x 8 CTAs, 16 floats a
    thread; many rows or short ones take no cluster."""
    p = rows.plan(8, 32000)
    assert (p.cluster, p.vec, p.per * p.vec, p.grid(8)) == (8, 4, 16, 64)
    assert rows.plan(4096, 4608).cluster == 1
    assert rows.plan(7, 1000).cluster == 1
    assert rows.plan(1, 65536).cluster == 8


# the replays' shapes: the definitions' 5 x 512, a ragged row, rows on
# a cluster (8 x 32000, 3 x 65536; C % 4 != 0 at 32001), a streamed row
REPLAY = [(5, 512), (7, 1000), (7, 33), (300, 1001), (8, 32000), (3, 65536),
          (2, 32001), (1, 300000)]


def _x(r, c, seed, scale):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((r, c)) * scale).astype(np.float32)
    return x, rng.uniform(0.5, 1.5, c).astype(np.float32)


def rms_replay(x: torch.Tensor, w: torch.Tensor, p: rows.RowPlan,
               eps: float = EPS_DEFAULT) -> torch.Tensor:
    """K9's arithmetic: the squares summed in the plan's order, then the
    plain version's steps."""
    ms = div(rows.ordered_sum(x * x, p)[:, None], x.shape[1])
    return x * rsqrt(ms + eps) * w


def softmax_replay(x: torch.Tensor, p: rows.RowPlan) -> torch.Tensor:
    """K10's arithmetic: ``e = exp(x - max)``, its sum in the plan's
    order, ``e / s``."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / rows.ordered_sum(e, p)[:, None]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("r, c", REPLAY)
def test_rms_norm_replay_matches_plain_and_jax(r, c, aligned):
    x, w = _x(r, c, r * c, 0.5)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = rms_replay(tx, tw, rows.plan(r, c, aligned))
    ref = rms_norm_pallas_plain(tx, tw)
    tol = 1e-5 * ref.abs().max().item()
    assert (got - ref).abs().max().item() <= tol
    want = np.asarray(jrms.rms_norm_pallas(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("r, c", REPLAY)
def test_softmax_replay_matches_plain_and_jax(r, c, aligned):
    x, _ = _x(r, c, r + c, 4.0)
    tx = torch.from_numpy(x)
    got = softmax_replay(tx, rows.plan(r, c, aligned))
    assert (got - softmax_pallas_plain(tx)).abs().max().item() <= 1e-6
    want = np.asarray(jsm.softmax_pallas(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_ordered_sum_is_the_cluster_order():
    """The CTAs of a cluster in rank order, not as a tree: with 1.0 at the
    start of the first CTA's part and 2^-24 (half a unit in the last place
    of 1.0) at the start of each other's, each addition ties and rounds
    back to 1.0; a tree over the ranks would add 2^-24 pairs first."""
    p = rows.plan(1, 32000)
    assert p.cluster == 8
    v = torch.zeros(1, 32000)
    v[0, ::p.span * p.vec] = 2.0 ** -24
    v[0, 0] = 1.0
    assert rows.ordered_sum(v, p).item() == 1.0
    # one CTA holding the whole row adds the small values first
    assert rows.ordered_sum(v, p._replace(cluster=1, span=8 * p.span,
                                          per=8 * p.per)).item() > 1.0


def test_plan_refuses_an_empty_matrix():
    with pytest.raises(ValueError):
        rows.plan(0, 8)
    with pytest.raises(ValueError):
        rows.plan(8, 0)
