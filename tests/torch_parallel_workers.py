"""Rank programs of tests/test_torch_parallel.py: each runs in a spawned
process of a gloo group on the CPU (rendezvous through a file under the
test's tmp_path) and returns plain numpy results to the test.  It imports
neither JAX nor the JAX package."""

from __future__ import annotations

import datetime
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

M, N, K = 4, 512, 2048


def spawn(target, world: int, store: str, args=(), timeout_s: float = 240):
    """Run ``target(rank, world, *args)`` on ``world`` spawned ranks joined
    through ``store``; returns each rank's result.  A rank that raises
    fails the run with its traceback; one that has not finished within
    ``timeout_s`` is killed and fails it too."""
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_main, args=(target, r, world, store, q, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))}"
                                   f" did not finish in {timeout_s} s")
            try:
                rank, ok, val = q.get(timeout=min(left, 1.0))
            except Exception:  # queue.Empty: check for dead ranks
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"ranks {dead} died") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            out[rank] = val
    finally:
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
    return [out[r] for r in range(world)]


def _main(target, rank, world, store, q, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        val = target(rank, world, *args)
        q.put((rank, True, val))
    except BaseException:  # noqa: BLE001 - sent to the test
        q.put((rank, False, traceback.format_exc()))
    q.close()
    q.join_thread()  # the result is in the pipe
    # leave at once: a rank must not wait on its peers' teardown
    os._exit(0)


# ---------------------------------------------------------------------------
# GEMMs, quantize, forward, training
# ---------------------------------------------------------------------------


def _gemm_cases(mesh, tp):
    from quant_gemm_tpu_torch.formats.quant import QUANTIZE, quantize_q8_1
    from quant_gemm_tpu_torch.kernels import layout, registry
    from quant_gemm_tpu_torch.parallel import sharding as sh

    rng = np.random.default_rng(1)
    a = torch.tensor(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.tensor(rng.standard_normal((N, K)).astype(np.float32))
    out = {}
    for qtype in ("q4_0", "q8_0"):
        w_q = QUANTIZE[qtype](w)
        whole = layout.prepare(w_q)
        f32 = dict(a_dtype=torch.float32)
        ref = registry.KERNELS.gemm_dequant(whole, a)  # K4, float32 operand
        ref8 = registry.KERNELS.gemm_exact(whole, quantize_q8_1(a))  # K1
        col = sh.shard_weight(w_q, mesh, mode="col")
        row = sh.shard_weight(w_q, mesh, mode="row")
        idx = mesh.index("tp")
        n_l = N // tp
        got = {
            "col": (sh.gemm_col_parallel(col, a, mesh, **f32),
                    ref[:, idx * n_l:(idx + 1) * n_l]),
            "col_gathered": (sh.gemm_col_parallel(
                col, a, mesh, gather_output=True, **f32), ref),
            "row_psum": (sh.gemm_row_parallel(row, a, mesh, **f32), ref),
            "row_scatter": (sh.gemm_row_parallel(
                row, a, mesh, scatter_output=True, **f32),
                ref[:, idx * n_l:(idx + 1) * n_l]),
            "col_ring": (sh.gemm_col_parallel_ring(
                sh.shard_weight_ring(w_q, mesh, mode="col"), a, mesh,
                gather_output=True), ref8),
            "row_ring": (sh.gemm_row_parallel_ring(
                sh.shard_weight_ring(w_q, mesh, mode="row"), a, mesh),
                ref8[:, idx * n_l:(idx + 1) * n_l]),
        }
        for name, (g, r) in got.items():
            out[f"{name}/{qtype}"] = (g.numpy(), r.numpy())
    return out


def _quantize_case(mesh):
    from quant_gemm_tpu_torch.formats.quant import quantize_q8_1
    from quant_gemm_tpu_torch.parallel import sharding as sh

    x = torch.tensor(np.random.default_rng(9).standard_normal(
        (8, 256)).astype(np.float32))
    mine = sh.quantize_q8_1_sharded(x, mesh, axis="tp")
    full = quantize_q8_1(x)
    got = [sh.all_gather(f, mesh, "tp", dim=0).numpy() for f in mine]
    return got, [f.numpy() for f in full]


def _forward_pair(mesh, cfg, params, qtype, cache_qtype, toks, steps=1,
                  ops=None):
    """Prefill then ``steps`` greedy decode steps through forward_tp and
    the single-device forward: the logits of each call, both paths."""
    from quant_gemm_tpu_torch.kernels import registry
    from quant_gemm_tpu_torch.models import llama, llama_tp

    ops = ops or registry.KERNELS
    qtp = llama_tp.shard_params_tp(params, cfg, mesh, qtype)
    q1 = llama.quantize_params(params, qtype, device="cpu")
    b = toks.shape[0]
    ct = llama_tp.init_cache_tp(cfg, b, mesh, qtype=cache_qtype)
    c1 = llama.KVCache.init(cfg, b, cache_qtype, device="cpu")
    pairs = []
    cur = torch.tensor(toks)
    for _ in range(1 + steps):
        lt, ct = llama_tp.forward_tp(qtp, cfg, cur, ct, mesh, ops=ops)
        l1, c1 = llama.forward(q1, cfg, cur, c1)
        pairs.append((lt.numpy(), l1.numpy()))
        cur = torch.argmax(l1[:, -1:], -1)
    return pairs


FORWARD_CASES = {
    # tests/test_parallel.py:140's config, and its q8-cache and window ones
    "base": (dict(vocab=64, dim=256, n_layers=2, n_heads=8, n_kv_heads=8,
                  d_ff=512, max_seq=32), "q4_0", "bf16", (2, 5), 5),
    "q8_cache": (dict(vocab=64, dim=256, n_layers=1, n_heads=4,
                      n_kv_heads=4, d_ff=512, max_seq=32), "q4_0", "q8",
                 (2, 5), 2),
    "window": (dict(vocab=64, dim=128, n_layers=1, n_heads=4, n_kv_heads=4,
                    d_ff=256, max_seq=64, window=8), "q8_0", "bf16",
               (2, 20), 5),
    # a Qwen-style QKV bias with grouped KV heads, and a 64-token chunk
    "qkv_bias": (dict(vocab=64, dim=256, n_layers=2, n_heads=8,
                      n_kv_heads=4, d_ff=512, max_seq=80), "q4_0", "bf16",
                 (2, 64), 6),
}


def _params(cfg, seed, bias=False):
    from quant_gemm_tpu_torch.models import llama

    params = llama.init_params(cfg, seed=seed)
    if bias:
        rng = np.random.default_rng(seed + 100)
        for lyr in params["layers"]:
            for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
                lyr[name] = (rng.standard_normal(n * cfg.head_dim)
                             * 0.1).astype(np.float32)
    return params


def _forward_cases(mesh, names):
    from quant_gemm_tpu_torch.models import llama

    out = {}
    for name in names:
        kw, qtype, cache_qtype, shape, seed = FORWARD_CASES[name]
        cfg = llama.LlamaConfig(**kw)
        params = _params(cfg, seed, bias=name == "qkv_bias")
        toks = np.random.default_rng(seed).integers(1, cfg.vocab, shape)
        out[name] = _forward_pair(mesh, cfg, params, qtype, cache_qtype, toks)
    return out


def _k2_case(mesh):
    """At a K2-eligible width the TP decode step takes norm_qkv on the
    rank's wqkv shard (JAX tests/test_parallel.py:176-215)."""
    from quant_gemm_tpu_torch.kernels import registry
    from quant_gemm_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab=64, dim=512, n_layers=2, n_heads=8,
                            n_kv_heads=8, d_ff=1024, max_seq=16)
    calls = []

    def norm_qkv(*a, **kw):
        calls.append(1)
        return registry.KERNELS.norm_qkv(*a, **kw)

    ops = registry.KERNELS._replace(norm_qkv=norm_qkv)
    toks = np.random.default_rng(3).integers(1, cfg.vocab, (1, 4))
    pairs = _forward_pair(mesh, cfg, llama.init_params(cfg, seed=6), "q4_0",
                          "bf16", toks, ops=ops)
    return pairs, len(calls)


def _q4k_case(mesh):
    from quant_gemm_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab=64, dim=512, n_layers=1, n_heads=4,
                            n_kv_heads=4, d_ff=1536, max_seq=16)
    toks = np.random.default_rng(4).integers(1, cfg.vocab, (2, 4))
    return _forward_pair(mesh, cfg, llama.init_params(cfg, seed=4), "q4_k",
                         "bf16", toks)


def _train_case(mesh_shape):
    """One sharded AdamW QAT step (remat) and one sharded SGD step on a
    dp x tp mesh, each beside the single-process step on the whole
    batch."""
    from quant_gemm_tpu_torch.models import llama, train
    from quant_gemm_tpu_torch.parallel import sharding as sh

    mesh = sh.make_mesh(mesh_shape, device="cpu")
    cfg = llama.LlamaConfig(vocab=64, dim=128, n_layers=2, n_heads=2,
                            n_kv_heads=2, d_ff=128, max_seq=32)
    params = llama.init_params(cfg, seed=1)
    toks = np.random.default_rng(2).integers(1, 64, (4, 16))
    dp, di = mesh.shape["dp"], mesh.index("dp")
    mine = toks[di * (4 // dp):(di + 1) * (4 // dp)]
    p, opt, step = train.make_state_step(params, cfg, mesh=mesh,
                                         optimizer="adamw", remat=True)
    p, opt, loss = step(p, opt, mine)
    full = train.gather_params(p, mesh)
    p1, o1, step1 = train.make_state_step(params, cfg, optimizer="adamw",
                                          remat=True, device="cpu")
    p1, o1, loss1 = step1(p1, o1, toks)
    sp, sstep = train.make_sharded_step(params, cfg, mesh, lr=1e-2)
    sp, sloss = sstep(sp, mine)
    sfull = train.gather_params(sp, mesh)
    tp1, sloss1 = train.train_step(
        train.unflatten(params, [torch.tensor(x) for x in
                                 train.leaves(params)]), cfg,
        torch.tensor(toks), lr=1e-2)

    _, g1 = train.value_and_grad(
        train.unflatten(params, [torch.tensor(x) for x in
                                 train.leaves(params)]), cfg,
        torch.tensor(toks), "q4_0")

    def arrays(tree):
        return [x.detach().numpy() for x in train.leaves(tree)]

    return {"adamw": (float(loss), float(loss1), arrays(full), arrays(p1)),
            "sgd": (float(sloss), float(sloss1), arrays(sfull), arrays(tp1)),
            "grads": arrays(g1)}


def main_rank(rank, world):
    """Everything one group of ``world`` ranks checks (tp = world)."""
    from quant_gemm_tpu_torch.parallel import health
    from quant_gemm_tpu_torch.parallel import sharding as sh

    mesh = sh.make_mesh({"tp": world}, device="cpu")
    out = {"gemm": _gemm_cases(mesh, world),
           "quantize": _quantize_case(mesh),
           "forward": _forward_cases(
               mesh, FORWARD_CASES if world == 2 else ("base", "q8_cache")),
           "health": health.check(timeout_s=30.0, mesh=mesh)}
    if world == 2:
        out["k2"] = _k2_case(mesh)
        out["q4_k"] = _q4k_case(mesh)
    else:
        out["train"] = _train_case({"dp": 2, "tp": 2})
    out["host_copies"] = dict(sh.HOST_COPIES)
    return out


def absent_rank(rank, world, timeout_s):
    """Rank 0 checks health while rank 1 never joins the heartbeat."""
    from quant_gemm_tpu_torch.parallel import health

    if rank == 0:
        t0 = time.monotonic()
        report = health.check(timeout_s=timeout_s, device="cpu")
        return report, time.monotonic() - t0
    time.sleep(timeout_s + 1)
    return None


# ---------------------------------------------------------------------------
# the ring GEMMs' overlap (tests/test_torch_ring_overlap.py)
# ---------------------------------------------------------------------------

RING_SHAPE = (4, 256, 1024)  # M, N, K


def ring_overlap_rank(rank, world, qtypes):
    """Each ring GEMM once under ``torch.profiler`` (CPU activity) with
    its ``overlap_report``, beside the blocking schedule's outputs, for
    each weight type; also one all-reduce's report.  Returns numpy."""
    from torch.profiler import ProfilerActivity, profile

    from quant_gemm_tpu_torch.formats.quant import QUANTIZE
    from quant_gemm_tpu_torch.harness.aot import overlap_report
    from quant_gemm_tpu_torch.parallel import sharding as sh

    mesh = sh.make_mesh({"tp": world}, device="cpu")
    m, n, k = RING_SHAPE
    rng = np.random.default_rng(17)
    a = torch.tensor(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.tensor(rng.standard_normal((n, k)).astype(np.float32))
    out = {}
    for qtype in qtypes:
        w_q = QUANTIZE[qtype](w)
        sw_col = sh.shard_weight_ring(w_q, mesh, mode="col")
        sw_row = sh.shard_weight_ring(w_q, mesh, mode="row")
        got = {}
        rings = {"col_ring": lambda: sh.gemm_col_parallel_ring(
                     sw_col, a, mesh),
                 "row_ring": lambda: sh.gemm_row_parallel_ring(
                     sw_row, a, mesh)}
        for name, fn in rings.items():
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                y = fn()
            got[name] = (y.numpy(), overlap_report(prof))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            col = sh.gemm_col_parallel_ring(sw_col, a, mesh, overlap=False)
            row = sh.gemm_row_parallel_ring(sw_row, a, mesh, overlap=False)
        got["blocking"] = (col.numpy(), row.numpy(), overlap_report(prof))
        got["gathered"] = sh.gemm_col_parallel_ring(
            sw_col, a, mesh, gather_output=True).numpy()
        out[qtype] = got
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sh.all_reduce(torch.ones(4), mesh, "tp")
    out["all_reduce"] = overlap_report(prof)
    return out
