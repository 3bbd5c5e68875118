"""The port's tensor and data parallelism (``quant_gemm_tpu_torch.
parallel``, ``models/llama_tp.py``, the sharded trainer) on the CPU: 2 and
4 spawned processes in a gloo group (rendezvous through a file under
tmp_path, every wait bounded), held to the unsharded port and, at the JAX
test's own config, to the JAX package's ``forward_tp``."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from quant_gemm_tpu_torch.models import llama, llama_tp
from quant_gemm_tpu_torch.parallel import sharding

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-3, rtol=1e-3)  # JAX's (tests/test_parallel.py:165-173)


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    store = tmp_path_factory.mktemp("tp2") / "store"
    return workers.spawn(workers.main_rank, 2, str(store))


@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    store = tmp_path_factory.mktemp("tp4") / "store"
    return workers.spawn(workers.main_rank, 4, str(store))


GEMMS = ["col", "col_gathered", "row_psum", "row_scatter", "col_ring",
         "row_ring"]


@pytest.mark.parametrize("qtype", ["q4_0", "q8_0"])
@pytest.mark.parametrize("name", GEMMS)
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_gemm_matches_unsharded(tp2, tp4, world, name, qtype):
    """Column-parallel outputs are the unsharded K4's bit for bit; the
    K-split sums (row, ring) agree to float order."""
    for rank in (tp2 if world == 2 else tp4):
        got, want = rank["gemm"][f"{name}/{qtype}"]
        assert got.shape == want.shape
        if name.startswith("col") and name != "col_ring":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("world", [2, 4])
def test_quantize_q8_1_sharded_bit_equal(tp2, tp4, world):
    for rank in (tp2 if world == 2 else tp4):
        got, want = rank["quantize"]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["base", "q8_cache", "window", "qkv_bias"])
def test_forward_tp2_matches_single_device(tp2, case):
    for rank in tp2:
        for lt, l1 in rank["forward"][case]:  # prefill, decode
            np.testing.assert_allclose(lt, l1, **TOL)
    np.testing.assert_array_equal(tp2[0]["forward"][case][0][0],
                                  tp2[1]["forward"][case][0][0])


@pytest.mark.parametrize("case", ["base", "q8_cache"])
def test_forward_tp4_matches_single_device(tp4, case):
    for rank in tp4:
        for lt, l1 in rank["forward"][case]:
            np.testing.assert_allclose(lt, l1, **TOL)


def test_tp_decode_takes_k2(tp2):
    for rank in tp2:
        pairs, calls = rank["k2"]
        assert calls == 2, "the TP decode step did not take norm_qkv"
        for lt, l1 in pairs:
            np.testing.assert_allclose(lt, l1, **TOL)


def test_tp_routes_turn_k8_off():
    cfg = llama.LlamaConfig(vocab=64, dim=512, n_layers=1, n_heads=8,
                            n_kv_heads=8, d_ff=1024, max_seq=16)
    qp = llama.init_qparams(cfg, seed=0, device="cpu")
    mesh = sharding.Mesh({"tp": 1}, {"tp": 0}, {"tp": None},
                         torch.device("cpu"))
    local, ctx = llama_tp.tp_context(cfg, mesh)
    from quant_gemm_tpu_torch.kernels import gemm_megalayer

    old = gemm_megalayer.ENABLE_TAIL
    gemm_megalayer.ENABLE_TAIL = True
    try:
        assert llama.routes(qp, cfg, 2, 1) == (True, True)
        assert llama.routes(qp, local, 2, 1, tp_ctx=ctx) == (True, False)
    finally:
        gemm_megalayer.ENABLE_TAIL = old


def test_q4_k_tp2_forward_and_tp4_split(tp2):
    """d_ff 1536: tp 2 gives w_down K 768 = 3 x 256, served (wo K 256);
    tp 4 gives 384, no multiple of q4_K's 256 (as TinyLlama's 5632 gives
    1408), which raises, as JAX's does."""
    for rank in tp2:
        for lt, l1 in rank["q4_k"]:
            np.testing.assert_allclose(lt, l1, **TOL)
    cfg = llama.LlamaConfig(vocab=64, dim=1024, n_layers=1, n_heads=4,
                            n_kv_heads=4, d_ff=1536, max_seq=16)
    params = llama.init_params(cfg, seed=4)
    mesh = sharding.Mesh({"tp": 4}, {"tp": 1}, {"tp": None},
                         torch.device("cpu"))
    with pytest.raises(ValueError, match="K=384 must be a multiple of 256"):
        llama_tp.shard_params_tp(params, cfg, mesh, "q4_k")
    from quant_gemm_tpu.models import llama as jllama
    from quant_gemm_tpu.models import llama_tp as jllama_tp
    from quant_gemm_tpu.parallel.sharding import make_mesh

    with pytest.raises(AssertionError):
        jllama_tp.shard_params_tp(params, jllama.LlamaConfig(
            **cfg._asdict()), make_mesh({"tp": 4}), "q4_k")


def test_per16_and_uneven_splits_raise():
    cfg = llama.LlamaConfig(vocab=64, dim=128, n_layers=1, n_heads=2,
                            n_kv_heads=2, d_ff=256, max_seq=16)
    params = llama.init_params(cfg, seed=0)
    mesh = sharding.Mesh({"tp": 4}, {"tp": 0}, {"tp": None},
                         torch.device("cpu"))
    with pytest.raises(ValueError, match="split"):
        llama_tp.shard_params_tp(params, cfg, mesh, "q4_0")
    mesh2 = sharding.Mesh({"tp": 2}, {"tp": 0}, {"tp": None},
                          torch.device("cpu"))
    with pytest.raises(NotImplementedError):
        llama_tp.shard_params_tp(params, cfg, mesh2, "q6_k")
    from quant_gemm_tpu_torch.formats.quant import quantize_q4_0

    w = quantize_q4_0(torch.randn(64, 96))  # K 96: no 2 x 32-block split
    with pytest.raises(ValueError, match="ring sharding"):
        sharding.shard_weight_ring(w, mesh2)


@pytest.mark.parametrize("world", [2, 4])
def test_health_check_ok(tp2, tp4, world):
    for rank in (tp2 if world == 2 else tp4):
        r = rank["health"]
        assert r.ok, r.row()
        assert r.n_devices == r.n_processes == world
        assert r.heartbeat_ms is not None


def test_health_check_times_out_on_absent_rank(tmp_path):
    (report, seconds), _ = workers.spawn(workers.absent_rank, 2,
                                         str(tmp_path / "store"), (3.0,))
    assert not report.ok and report.heartbeat_ms is None
    assert "TIMEOUT" in report.row()
    assert seconds < 10


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_sharded_step_dp2_tp2_matches_single_process(tp4, opt):
    """The loss to 1e-5 relative; SGD's params (p - lr g: the gradients)
    to 1e-5.  AdamW's first step is ``lr g / (|g| + eps)``, which float
    order noise in a gradient near eps = 1e-8 moves by up to ``lr``:
    its params agree to 1e-5 wherever |g| >= 1e-6 (100 eps), and within
    2 lr everywhere."""
    for rank in tp4:
        loss, loss1, params, params1 = rank["train"][opt]
        np.testing.assert_allclose(loss, loss1, rtol=1e-5)
        for a, b, g in zip(params, params1, rank["train"]["grads"]):
            firm = np.abs(g) >= 1e-6 if opt == "adamw" else np.ones(
                g.shape, bool)
            np.testing.assert_allclose(a[firm], b[firm], rtol=0, atol=1e-5)
            assert np.abs(a - b).max() <= 2e-3


def test_gloo_cpu_needs_no_host_copy(tp2, tp4):
    assert all(not rank["host_copies"] for rank in tp2 + tp4)


@pytest.mark.slow  # JAX's Pallas kernels in interpret mode: about 170 s
def test_forward_tp_matches_jax_forward_tp(tp4):
    """The port's tp-4 logits against JAX's own forward_tp at
    tests/test_parallel.py:140's config (Pallas in interpret mode)."""
    import jax
    import jax.numpy as jnp

    from quant_gemm_tpu.models import llama as jllama
    from quant_gemm_tpu.models import llama_tp as jllama_tp
    from quant_gemm_tpu.parallel.sharding import make_mesh

    kw, qtype, _, shape, seed = workers.FORWARD_CASES["base"]
    cfg = jllama.LlamaConfig(**kw)
    params = llama.init_params(llama.LlamaConfig(**kw), seed=seed)
    mesh = make_mesh({"tp": 4}, jax.devices()[:4])
    qtp = jllama_tp.shard_params_tp(params, cfg, mesh, qtype)
    toks = np.random.default_rng(seed).integers(1, cfg.vocab, shape)
    cache = jllama_tp.init_cache_tp(cfg, shape[0], mesh)
    port = tp4[0]["forward"]["base"]
    out, cache = jllama_tp.forward_tp(qtp, cfg, jnp.asarray(toks, jnp.int32),
                                      cache, mesh)
    np.testing.assert_allclose(np.asarray(out), port[0][0], **TOL)
    nxt = np.argmax(port[0][1][:, -1:], -1).astype(np.int32)
    d, _ = jllama_tp.forward_tp(qtp, cfg, jnp.asarray(nxt), cache, mesh)
    np.testing.assert_allclose(np.asarray(d), port[1][0], **TOL)


def test_multihost_script_ok():
    out = subprocess.run(
        [sys.executable, "-m", "quant_gemm_tpu_torch.scripts.multihost",
         "--nproc", "2", "--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=180)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "multihost OK" in out.stdout
