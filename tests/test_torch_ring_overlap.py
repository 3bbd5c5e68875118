"""The ring GEMMs' overlap (``parallel/sharding.py``): each rotation is
started before its step's chunk GEMM and waited for after it, so
``harness/aot.py::overlap_report`` of one ring call on 2 and 4 spawned
gloo ranks finds ``tp - 1`` overlapped ppermutes and none blocking; the
outputs equal the blocking schedule's bit for bit, and JAX's ring GEMMs
(Pallas in interpret mode, JAX's ``shard_map`` on the virtual CPU mesh)
within the JAX tests' NMSE (``tests/test_parallel.py:86-111``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_workers as workers
from quant_gemm_tpu.formats import numpy_ref
from quant_gemm_tpu.harness.metrics import ErrorMetrics
from quant_gemm_tpu.parallel import sharding as jsh
from quant_gemm_tpu.ref import gemm as refg

QTYPES = ("q4_0", "q8_0")
RINGS = ("col_ring", "row_ring")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for world in (2, 4):
        store = tmp_path_factory.mktemp(f"ring{world}") / "store"
        out[world] = workers.spawn(workers.ring_overlap_rank, world,
                                   str(store), args=(QTYPES,))
    return out


def _inputs():
    m, n, k = workers.RING_SHAPE
    rng = np.random.default_rng(17)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((n, k)).astype(np.float32))


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("world", [2, 4])
def test_ring_overlaps_every_rotation(ranks, world, qtype, ring):
    for r in ranks[world]:
        rep = r[qtype][ring][1]
        assert rep["overlapped"] == world - 1, rep
        assert rep["blocking"] == 0 and rep["resynced"] == 0, rep
        assert rep["hidden_by"] == ["ring_gemm"] * (world - 1), rep


@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("world", [2, 4])
def test_ring_outputs_bit_equal_to_blocking_schedule(ranks, world, qtype):
    for r in ranks[world]:
        col, row, rep = r[qtype]["blocking"]
        np.testing.assert_array_equal(r[qtype]["col_ring"][0], col)
        np.testing.assert_array_equal(r[qtype]["row_ring"][0], row)
        # the blocking schedule reads as blocking: the report tells them apart
        assert rep["blocking"] == 2 * (world - 1), rep
        assert rep["overlapped"] == 0, rep


@pytest.mark.parametrize("world", [2, 4])
def test_all_reduce_reads_as_sync(ranks, world):
    for r in ranks[world]:
        rep = r["all_reduce"]
        assert rep["sync"] == 1 and rep["overlapped"] == rep["blocking"] == 0


@pytest.mark.parametrize("qtype", ["q4_0"])
def test_ring_matches_jax_rings(ranks, qtype):
    """The port's rings (tp 2) against JAX's on the same numpy inputs:
    both within the JAX tests' NMSE 1e-5 of the W x Q8_1 golden and of
    each other.  (q4_0 only: JAX's rings in interpret mode take about 20
    s a form; the port's q8_0 rings are held to the blocking schedule.)"""
    tp = 2
    if len(jax.devices()) < tp:
        pytest.skip("needs the virtual CPU mesh")
    a, w = _inputs()
    w_q = numpy_ref.QUANTIZE[qtype](w)
    mesh = jsh.make_mesh({"tp": tp}, jax.devices()[:tp])
    jcol = np.asarray(jsh.gemm_col_parallel_ring(
        jsh.shard_weight_ring(w_q, mesh, mode="col"), jnp.asarray(a), mesh,
        gather_output=True))
    jrow = np.asarray(jsh.gemm_row_parallel_ring(
        jsh.shard_weight_ring(w_q, mesh, mode="row"), jnp.asarray(a), mesh))
    gold = refg.gemm_wxa8(w_q, numpy_ref.quantize_q8_1(a))
    port = ranks[tp]
    n_l = w.shape[0] // tp
    pcol = port[0][qtype]["gathered"]
    prow = np.concatenate([r[qtype]["row_ring"][0] for r in port], axis=1)
    for i, r in enumerate(port):
        np.testing.assert_array_equal(
            r[qtype]["col_ring"][0], pcol[:, i * n_l:(i + 1) * n_l])
    for got, ref in ((pcol, jcol), (prow, jrow), (pcol, gold), (prow, gold),
                     (jcol, gold)):
        assert ErrorMetrics.compute(got, ref).nmse < 1e-5
