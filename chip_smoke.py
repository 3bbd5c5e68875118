#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (quant_gemm_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and builds every kernel of the serving path from
   ``quant_gemm_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. kernel phase: each of K1-K5 at the shapes the serving path gives it
   (K3 and K5 also with the int8 cache and a window of 256), against its
   plain PyTorch version at the stated tolerance, timed with CUDA events
   (L2 flushed before every timed launch) beside its bound and, where one
   PyTorch call computes the same function, that call's time;
3. main path: the q4_0 W4A8 continuous-batching ``Server(qp, cfg,
   n_slots=8)`` at its defaults (prefill chunk 128, prompt caching) at
   TinyLlama-1.1B width (22 layers, random weights from a seed, quantized
   on the card) serves 16 greedy requests, eight of them opening with a
   shared 256-token system prompt, with the bf16 cache and again with the
   int8 cache; each kernel's launches, counted from 0 for each run, must
   match the path's, and the reused prompt tokens the traffic's; then two
   128-token prefill chunks and one decode step per cache run through the
   kernels and through the plain versions from the same hidden state at
   every layer, and each layer's output and the logits must agree;
4. prints one JSON line of the kernels, the card, and last the result line.

Exits non-zero, with no result line, when CUDA is unavailable or any phase
fails.  TF32 is off for every float32 product (``allow_tf32 = False``), so
the plain versions are full float32.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}

# TinyLlama-1.1B (huggingface.co/TinyLlama/TinyLlama-1.1B-Chat-v1.0
# config.json): hidden 2048, intermediate 5632, 22 layers, 32 heads,
# 4 KV heads, vocab 32000, rope_theta 10000, rms_norm_eps 1e-5
DIM, D_FF, LAYERS, HEADS, KV_HEADS, VOCAB = 2048, 5632, 22, 32, 4, 32000
HD = DIM // HEADS
REP = HEADS // KV_HEADS


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median device time of single launches, L2 flushed before each.

    The card first spins for a few tens of milliseconds (``_sleep``) while
    the host enqueues every rep (flush, event, launch, event) behind it,
    so each pair of events brackets device work only, never a wait for
    the host to enqueue the next launch."""

    def __init__(self, dev):
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, reps: int = 25, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)  # cycles: ~25 ms at the H100's clock
        marks = []
        for _ in range(reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            marks.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in marks)


def bound(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def q4_bytes(n: int, k: int) -> int:
    return n * k // 2 + n * (k // 32) * 2


def nmse(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return ((got - ref).pow(2).sum() / ref.pow(2).sum()).item()


def kernel_phase(dev, timer):
    from quant_gemm_tpu_torch.formats.quant import quantize_q4_0, quantize_q8_1
    from quant_gemm_tpu_torch.kernels import layout
    from quant_gemm_tpu_torch.kernels.gemm_dequant import (
        gemm_dequant, gemm_dequant_plain)
    from quant_gemm_tpu_torch.kernels.gemm_exact import (
        gemm_exact, gemm_exact_plain)
    from quant_gemm_tpu_torch.kernels.gemm_megalayer import (
        norm_qkv, norm_qkv_plain)
    from quant_gemm_tpu_torch.kernels.registry import fold_q8_1
    from quant_gemm_tpu_torch.ops.attention import (
        flash_decode, flash_decode_plain, flash_prefill, flash_prefill_plain)

    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def weight(n, k):
        return layout.prepare(quantize_q4_0(randn(n, k, scale=k ** -0.5)))

    shapes = {"wo": (DIM, DIM), "wgu": (2 * D_FF, DIM),
              "w_down": (DIM, D_FF), "lm_head": (VOCAB, DIM)}
    weights = {name: weight(n, k) for name, (n, k) in shapes.items()}
    rows = []  # per-shape detail

    def record(kernel, shape, err, check, ms, plain_ms, bnd, lib_ms,
               main=True):
        """One row; ``main``: the variant the default server runs (the
        kernels line sums those, and lists every row)."""
        rows.append({"kernel": kernel, "shape": shape, "max_abs_err": err,
                     "check": check, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd[0], "bound_by": bnd[1],
                     "library_ms": lib_ms, "main": main})
        lib = "null" if lib_ms is None else f"{lib_ms:.5f}"
        print(f"  {kernel:13s} {shape:50s} kernel_ms={ms:.5f} "
              f"plain_ms={plain_ms:.5f} bound_ms={bnd[0]:.5f} ({bnd[1]}) "
              f"library_ms={lib} max_abs_err={err:.3e} [{check}]",
              flush=True)

    # K1: exact decode GEMM at M = 8
    m = 8
    for name, w in weights.items():
        a = quantize_q8_1(randn(m, w.k))
        got, ref = gemm_exact(w, a), gemm_exact_plain(w, a)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item()
        if not err <= tol:
            fail(f"K1 gemm_exact {name}: max|err| {err} > {tol}")
        nbytes = q4_bytes(w.n, w.k) + m * w.k + 2 * m * (w.k // 32) * 2 \
            + m * w.n * 4
        record("gemm_exact", f"{name} M={m} N={w.n} K={w.k}", err,
               f"max|err| <= {tol:.3e}", timer(lambda: gemm_exact(w, a)),
               timer(lambda: gemm_exact_plain(w, a), reps=5),
               bound(nbytes, 2 * m * w.n * w.k, "int8"), None)

    # K2: norm + quantize + wqkv at M = 8
    wqkv = weight(HEADS * HD + 2 * KV_HEADS * HD, DIM)
    x = randn(m, DIM, scale=3.0)
    nw = 1.0 + 0.1 * randn(DIM)
    got, ref = norm_qkv(wqkv, x, nw, 1e-5), norm_qkv_plain(wqkv, x, nw, 1e-5)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    tol = 2e-3 * ref.abs().max().item()
    if not err <= tol:
        fail(f"K2 norm_qkv: max|err| {err} > {tol}")
    nbytes = q4_bytes(wqkv.n, DIM) + m * DIM * 4 + DIM * 4 + m * wqkv.n * 4
    record("norm_qkv", f"wqkv M={m} N={wqkv.n} K={DIM}", err,
           f"max|err| <= {tol:.3e}",
           timer(lambda: norm_qkv(wqkv, x, nw, 1e-5)),
           timer(lambda: norm_qkv_plain(wqkv, x, nw, 1e-5), reps=5),
           bound(nbytes, 2 * m * wqkv.n * DIM, "int8"), None)

    # K3: flash decode, B=8 slots at context 512 over the stacked cache:
    # bf16, int8 codes with per-token scales, and a window of 256
    b, s, ctx, layer = 8, 2048, 512, 5
    shape = (LAYERS, b, KV_HEADS, s, HD)
    kc = randn(*shape).to(torch.bfloat16)
    vc = randn(*shape).to(torch.bfloat16)
    k8, v8 = (torch.randint(-127, 128, shape, generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    s8 = dict(k_scale=0.005 + 0.025 * torch.rand(
                  shape[:-1], generator=g, device=dev),
              v_scale=0.005 + 0.025 * torch.rand(
                  shape[:-1], generator=g, device=dev))
    caches = {"bf16": (kc, vc, {}), "int8": (k8, v8, s8)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    span = torch.arange(s, device=dev)
    q = randn(b, KV_HEADS, REP, HD)
    kcur = randn(b, KV_HEADS, 1, HD).to(torch.bfloat16)
    vcur = randn(b, KV_HEADS, 1, HD).to(torch.bfloat16)
    pos = torch.full((b,), ctx, dtype=torch.int32, device=dev)
    for ctype, window in (("bf16", 0), ("int8", 0), ("bf16", 256)):
        k_, v_, sc = caches[ctype]
        kw = dict(k_current=kcur, v_current=vcur, layer=layer, window=window,
                  **sc)
        got = flash_decode(q, k_, v_, pos, **kw)
        ref = flash_decode_plain(q, k_, v_, pos, **kw)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not err <= 2e-3:
            fail(f"K3 flash_decode {ctype} window={window}: max|err| {err} "
                 "> 2e-3")
        # cache slots attended besides the current token
        seen = min(ctx, window - 1) if window else ctx
        elt = 1 if ctype == "int8" else 2
        nbytes = 2 * b * KV_HEADS * seen * (HD * elt + (4 if sc else 0)) \
            + 2 * b * KV_HEADS * HD * 2 + 2 * b * HEADS * HD * 4 + b * 4
        ops = 4 * b * HEADS * (seen + 1) * HD
        lib_ms = None
        if not sc:
            # yardstick: SDPA over the cache with the current token
            # written at pos (the same attention), bf16, boolean mask
            kl, vl = kc[layer].clone(), vc[layer].clone()
            kl[:, :, ctx], vl[:, :, ctx] = kcur[:, :, 0], vcur[:, :, 0]
            qh = q.reshape(b, HEADS, 1, HD).to(torch.bfloat16)
            keep = span <= ctx
            if window:
                keep = keep & (span > ctx - window)
            mask = keep.expand(b, 1, 1, s)
            lib = sdpa(qh, kl, vl, attn_mask=mask, enable_gqa=True)
            lib_err = (lib.float().reshape(got.shape) - ref).abs().max().item()
            if not lib_err <= 2e-2:
                fail(f"K3 yardstick SDPA disagrees: {lib_err}")
            lib_ms = timer(lambda: sdpa(qh, kl, vl, attn_mask=mask,
                                        enable_gqa=True))
        variant = ctype + (f" window={window}" if window else "")
        record("flash_decode", f"{variant} B={b} KV={KV_HEADS} rep={REP} "
               f"hd={HD} S={s} ctx={ctx}", err, "max|err| <= 2e-3",
               timer(lambda: flash_decode(q, k_, v_, pos, **kw)),
               timer(lambda: flash_decode_plain(q, k_, v_, pos, **kw), reps=5),
               bound(nbytes, ops, "bf16"), lib_ms,
               main=(ctype, window) == ("bf16", 0))

    # K5: flash prefill of one 128-token chunk of one slot (the server's
    # one-slot view of its stacked cache, read in place) at the start of
    # a prompt and after 384 cached tokens: bf16, int8, window 256
    t5, slot = 128, 3
    q5 = randn(1, KV_HEADS, t5 * REP, HD)
    for ctype, p0, window in (("bf16", 0, 0), ("bf16", 384, 0),
                              ("int8", 0, 0), ("int8", 384, 0),
                              ("bf16", 384, 256)):
        k_, v_, sc = caches[ctype]
        view = slice(slot, slot + 1)
        k_, v_ = k_[:, view], v_[:, view]
        kw = dict(rep=REP, layer=layer, window=window,
                  **{n: x[:, view] for n, x in sc.items()})
        pos0 = torch.tensor([p0], dtype=torch.int32, device=dev)
        got = flash_prefill(q5, k_, v_, pos0, **kw)
        ref = flash_prefill_plain(q5, k_, v_, pos0, **kw)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not err <= 2e-3:
            fail(f"K5 flash_prefill {ctype} pos0={p0} window={window}: "
                 f"max|err| {err} > 2e-3")
        qpos = p0 + np.arange(t5)
        seen = np.minimum(qpos + 1, window) if window else qpos + 1
        lo = max(p0 - window + 1, 0) if window else 0
        seen_rows = p0 + t5 - lo  # cache rows any query row attends
        elt = 1 if ctype == "int8" else 2
        nbytes = 2 * q5.numel() * 4 + 4 \
            + 2 * KV_HEADS * seen_rows * (HD * elt + (4 if sc else 0))
        ops = 4 * HEADS * HD * int(seen.sum())
        lib_ms = None
        if not sc:
            # yardstick: SDPA over the bf16 cache, boolean causal (and
            # window) mask, grouped heads
            qh = (q5.reshape(1, KV_HEADS, t5, REP, HD).transpose(2, 3)
                  .reshape(1, HEADS, t5, HD).to(torch.bfloat16))
            kl, vl = k_[layer], v_[layer]
            qp = torch.as_tensor(qpos, device=dev)[:, None]
            keep = span[None, :] <= qp
            if window:
                keep = keep & (span[None, :] > qp - window)
            lib = sdpa(qh, kl, vl, attn_mask=keep, enable_gqa=True)
            lib = (lib.float().reshape(1, KV_HEADS, REP, t5, HD)
                   .transpose(2, 3).reshape(got.shape))
            lib_err = (lib - ref).abs().max().item()
            if not lib_err <= 2e-2:
                fail(f"K5 yardstick SDPA disagrees: {lib_err}")
            lib_ms = timer(lambda: sdpa(qh, kl, vl, attn_mask=keep,
                                        enable_gqa=True))
        variant = ctype + (f" window={window}" if window else "")
        record("flash_prefill", f"{variant} B=1 KV={KV_HEADS} rep={REP} "
               f"hd={HD} S={s} T={t5} pos0={p0}", err, "max|err| <= 2e-3",
               timer(lambda: flash_prefill(q5, k_, v_, pos0, **kw)),
               timer(lambda: flash_prefill_plain(q5, k_, v_, pos0, **kw),
                     reps=5),
               bound(nbytes, ops, "bf16"), lib_ms,
               main=(ctype, window) == ("bf16", 0))

    # K4: dequant GEMM at the prefill chunk M = 128
    m = 128
    for name, w in [("wqkv", wqkv), *weights.items()]:
        a = fold_q8_1(quantize_q8_1(randn(m, w.k)))
        got, ref = gemm_dequant(w, a), gemm_dequant_plain(w, a)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        e = nmse(got, ref)
        if not e <= 1e-4:
            fail(f"K4 gemm_dequant {name}: NMSE {e} > 1e-4")
        wb = layout.dequantize(w, torch.bfloat16)  # yardstick's own weight
        nbytes = q4_bytes(w.n, w.k) + m * w.k * 2 + m * w.n * 4
        record("gemm_dequant", f"{name} M={m} N={w.n} K={w.k}", err,
               f"NMSE {e:.3e} <= 1e-4", timer(lambda: gemm_dequant(w, a)),
               timer(lambda: gemm_dequant_plain(w, a), reps=5),
               bound(nbytes, 2 * m * w.n * w.k, "bf16"),
               timer(lambda: torch.matmul(a, wb.T)))
    return rows


def traffic(rng):
    """16 prompts of 64-512 tokens; requests 4-11 open with one shared
    256-token system prompt, so that the second wave (8-15, admitted when
    the first eight finish together) finds it in four freed slots.
    Returns the prompts and each one's expected reused prefix length."""
    shared = rng.integers(0, VOCAB, 256).tolist()
    prompts, reuse = [], []
    for i in range(16):
        if 4 <= i < 12:
            n = int(rng.integers(272, 513))
            prompts.append(shared + rng.integers(0, VOCAB, n - 256).tolist())
        else:
            prompts.append(rng.integers(0, VOCAB,
                                        int(rng.integers(64, 513))).tolist())
        reuse.append(256 if 8 <= i < 12 else 0)
    return prompts, reuse


def flash_chunks(prompts, reuse, chunk=128, bucket=16):
    """Prefill chunks of 64 or more tokens (bucket-padded): the calls
    that take K5."""
    n = 0
    for p, r in zip(prompts, reuse):
        for off in range(r, len(p), chunk):
            t = max(bucket, -(-min(chunk, len(p) - off) // bucket) * bucket)
            n += t >= 64
    return n


def main_path(dev, wrappers):
    from quant_gemm_tpu_torch.kernels import registry
    from quant_gemm_tpu_torch.models import llama, serve

    cfg = llama.LlamaConfig(vocab=VOCAB, dim=DIM, n_layers=LAYERS,
                            n_heads=HEADS, n_kv_heads=KV_HEADS, d_ff=D_FF,
                            max_seq=2048, rope_base=10000.0, eps=1e-5)
    t0 = time.perf_counter()
    qp = llama.init_qparams(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"main path: TinyLlama-1.1B width, {LAYERS} layers, random q4_0 "
          f"weights built on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)

    rng = np.random.default_rng(0)
    prompts, reuse = traffic(rng)
    want_flash = LAYERS * flash_chunks(prompts, reuse)
    main_launches = None
    for qtype in ("bf16", "q8"):
        # the JAX defaults: bucket 16, chunk 128, cache_prompt=True
        kw = {} if qtype == "bf16" else {"cache_qtype": "q8"}
        warm = serve.Server(qp, cfg, n_slots=8, device=dev, **kw)
        warm.submit(list(range(1, 65)), max_new=2)  # first-use costs
        warm.run_until_done()
        del warm
        srv = serve.Server(qp, cfg, n_slots=8, device=dev, **kw)
        for p in prompts:
            srv.submit(p, max_new=32)
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        results = srv.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
        st = srv.stats()
        name = f"Server(qp, cfg, n_slots=8{', cache_qtype=q8' if kw else ''})"
        if sorted(results) != list(range(16)):
            fail(f"{name}: not every request finished: {sorted(results)}")
        if any(len(t) != 32 for t in results.values()):
            fail(f"{name}: a request stopped short of max_new=32")
        if not all(0 <= t < VOCAB for ts in results.values() for t in ts):
            fail(f"{name}: a generated token is outside the vocabulary")
        if not all(launches.values()):
            fail(f"{name}: a kernel of the path never launched: {launches}")
        if st["cached_prompt_tokens"] != sum(reuse):
            fail(f"{name}: reused {st['cached_prompt_tokens']} cached "
                 f"prompt tokens, expected {sum(reuse)}")
        print(f"  {name}: 16 requests, {st['prefill_tokens']} prompt tokens "
              f"prefilled and {st['cached_prompt_tokens']} reused from the "
              f"cache, {st['generated_tokens']} generated, "
              f"{st['decode_steps']} decode steps in {wall:.2f} s", flush=True)
        pre = st["prefill_tokens"] / st["prefill_seconds"]
        dec = st["decode_tokens"] / st["decode_seconds"]
        print(f"    prefill {pre:.1f} tok/s, decode {dec:.1f} tok/s, median "
              f"decode step {st['decode_step_ms_median']:.3f} ms", flush=True)
        print(f"    launches: {json.dumps(launches)}", flush=True)
        # every decode step runs K2 and K3 once per layer and K1 for wo,
        # wgu, w_down and lm_head; prefill (M >= 16) never reaches K1, and
        # every chunk of 64 tokens or more runs K5 once per layer
        steps = st["decode_steps"]
        want = {"gemm_exact": steps * (3 * LAYERS + 1),
                "norm_qkv": steps * LAYERS, "flash_decode": steps * LAYERS,
                "flash_prefill": want_flash}
        if any(launches[k] != v for k, v in want.items()):
            fail(f"{name}: launches {launches} differ from the path's {want}")
        if qtype == "bf16":  # the default server: the main path
            main_launches = launches

    def layerwise(tokens, cache):
        """Kernels and plain versions from the same hidden state at every
        layer (the kernels'): the largest NMSE of a layer's update
        (output - input) and the NMSE of the logits of the last state.
        A last-bit difference that moves a Q8_1 code across a .5 rounding
        tie then shows in its own layer only, not compounded over all."""
        cache_p = cache.clone()
        x, step = llama.begin(qp, cfg, tokens, cache)
        worst = 0.0
        for li, lyr in enumerate(qp["layers"]):
            xk, _ = llama.layer(lyr, li, cfg, x, cache, step)
            xp, _ = llama.layer(lyr, li, cfg, x, cache_p, step,
                                registry.PLAIN)
            worst = max(worst, nmse(xk - x, xp - x))
            x = xk
        lk = llama.head(qp, cfg, x)
        if not bool(torch.isfinite(lk).all()):
            fail("non-finite logits through the kernels")
        return worst, nmse(lk, llama.head(qp, cfg, x, registry.PLAIN))

    def check(tokens, cache):
        """layerwise() and the free run of both op sets end to end."""
        free = nmse(llama.forward(qp, cfg, tokens, cache.clone())[0],
                    llama.forward(qp, cfg, tokens, cache.clone(),
                                  ops=registry.PLAIN)[0])
        return (*layerwise(tokens, cache.clone()), free)

    cases = []
    for qtype in ("bf16", "q8"):
        # two 128-token chunks of one slot (K5 at pos0 0 and 128), then
        # one 8-slot decode step at ragged positions
        toks = torch.as_tensor(rng.integers(0, VOCAB, (1, 256)), device=dev)
        cache = llama.KVCache.init(cfg, 1, qtype, device=dev)
        cases.append((f"{qtype} chunk 128 at pos0 0",
                      check(toks[:, :128], cache)))
        llama.forward(qp, cfg, toks[:, :128], cache)
        cases.append((f"{qtype} chunk 128 at pos0 128",
                      check(toks[:, 128:], cache)))
        cache = llama.KVCache.init(cfg, 8, qtype, device=dev)
        llama.forward(qp, cfg, torch.as_tensor(
            rng.integers(0, VOCAB, (8, 48)), device=dev), cache)
        cache.pos = torch.tensor([48, 40, 33, 47, 20, 48, 1, 16],
                                 dtype=torch.int32, device=dev)
        nt = torch.as_tensor(rng.integers(0, VOCAB, (8, 1)), device=dev)
        cases.append((f"{qtype} decode step", check(nt, cache)))
    for name, (layer_e, logit_e, free) in cases:
        print(f"  {name}, kernels vs plain versions: worst layer update "
              f"NMSE {layer_e:.3e}, logits NMSE {logit_e:.3e} (limits "
              f"1e-4); run free end to end: logits NMSE {free:.3e} "
              "(limit 1e-2)", flush=True)
        if not (layer_e <= 1e-4 and logit_e <= 1e-4):
            fail(f"{name}: the kernels disagree with the plain versions")
        # Q8_1 tie flips compounding over 22 layers give NMSE near 6e-4
        # at this width (PERF.md); a wrong kernel gives order 1
        if not free <= 1e-2:
            fail(f"{name}: the free run through the kernels diverges")
    return main_launches


KERNEL_INFO = {
    "gemm_exact": ("quant_gemm_tpu_torch/csrc/gemm_exact.cu",
                   "quant_gemm_tpu/kernels/gemm_exact.py:775"),
    "norm_qkv": ("quant_gemm_tpu_torch/csrc/norm_qkv.cu",
                 "quant_gemm_tpu/kernels/gemm_megalayer.py:309"),
    "flash_decode": ("quant_gemm_tpu_torch/csrc/flash_decode.cu",
                     "quant_gemm_tpu/ops/attention.py:339"),
    "gemm_dequant": ("quant_gemm_tpu_torch/csrc/gemm_dequant.cu",
                     "quant_gemm_tpu/kernels/gemm_pallas.py:660"),
    "flash_prefill": ("quant_gemm_tpu_torch/csrc/flash_prefill.cu",
                      "quant_gemm_tpu/ops/attention.py:548"),
}


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    from quant_gemm_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    built = _build.build()
    print(f"kernel build: {built['seconds']:.1f} s "
          f"({', '.join(_build.source_names())})", flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    timer = Timer(dev)
    print("kernel phase:", flush=True)
    rows = kernel_phase(dev, timer)
    from quant_gemm_tpu_torch.kernels.gemm_dequant import gemm_dequant
    from quant_gemm_tpu_torch.kernels.gemm_exact import gemm_exact
    from quant_gemm_tpu_torch.kernels.gemm_megalayer import norm_qkv
    from quant_gemm_tpu_torch.ops.attention import flash_decode, flash_prefill

    wrappers = {"gemm_exact": gemm_exact, "norm_qkv": norm_qkv,
                "flash_decode": flash_decode, "gemm_dequant": gemm_dequant,
                "flash_prefill": flash_prefill}
    launches = main_path(dev, wrappers)

    kernels = []
    for name, (src, rep) in KERNEL_INFO.items():
        every = [r for r in rows if r["kernel"] == name]
        mine = [r for r in every if r["main"]]
        lib = [r["library_ms"] for r in mine]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in every),
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in mine)
            else "operations",
            "library_ms": None if None in lib else sum(lib),
            "variants": [{k: r[k] for k in ("shape", "ms", "plain_ms",
                                            "bound_ms", "library_ms",
                                            "max_abs_err")}
                         for r in every if not r["main"]]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
