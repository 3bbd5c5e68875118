#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (quant_gemm_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and builds every kernel of the serving path from
   ``quant_gemm_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. kernel phase: each of K1-K4 at the shapes the serving path gives it,
   against its plain PyTorch version at the stated tolerance, timed with
   CUDA events (L2 flushed before every timed launch) beside its bound and,
   where one PyTorch call computes the same function, that call's time;
3. main path: the q4_0 W4A8 continuous-batching ``Server`` at
   TinyLlama-1.1B width (22 layers, random weights from a seed, quantized
   on the card) serves 16 greedy requests; every kernel's launch count must
   grow; then one prefill chunk and one decode step run through the kernels
   and through the plain versions from the same hidden state at every
   layer, and each layer's output and the logits must agree;
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
        flash_decode, flash_decode_plain)

    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def weight(n, k):
        return layout.prepare(quantize_q4_0(randn(n, k, scale=k ** -0.5)))

    shapes = {"wo": (DIM, DIM), "wgu": (2 * D_FF, DIM),
              "w_down": (DIM, D_FF), "lm_head": (VOCAB, DIM)}
    weights = {name: weight(n, k) for name, (n, k) in shapes.items()}
    rows = []  # per-shape detail

    def record(kernel, shape, err, check, ms, plain_ms, bnd, lib_ms):
        rows.append({"kernel": kernel, "shape": shape, "max_abs_err": err,
                     "check": check, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd[0], "bound_by": bnd[1],
                     "library_ms": lib_ms})
        lib = "null" if lib_ms is None else f"{lib_ms:.5f}"
        print(f"  {kernel:13s} {shape:28s} kernel_ms={ms:.5f} "
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

    # K3: flash decode, B=8 slots at context 512 over the stacked cache
    b, s, ctx, layer = 8, 2048, 512, 5
    kc = randn(LAYERS, b, KV_HEADS, s, HD).to(torch.bfloat16)
    vc = randn(LAYERS, b, KV_HEADS, s, HD).to(torch.bfloat16)
    q = randn(b, KV_HEADS, REP, HD)
    kcur = randn(b, KV_HEADS, 1, HD).to(torch.bfloat16)
    vcur = randn(b, KV_HEADS, 1, HD).to(torch.bfloat16)
    pos = torch.full((b,), ctx, dtype=torch.int32, device=dev)
    kw = dict(k_current=kcur, v_current=vcur, layer=layer)
    got = flash_decode(q, kc, vc, pos, **kw)
    ref = flash_decode_plain(q, kc, vc, pos, **kw)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    if not err <= 2e-3:
        fail(f"K3 flash_decode: max|err| {err} > 2e-3")
    # yardstick: SDPA over the cache with the current token written at
    # pos (the same attention), bf16 inputs, boolean mask slots <= pos
    kl, vl = kc[layer].clone(), vc[layer].clone()
    kl[:, :, ctx], vl[:, :, ctx] = kcur[:, :, 0], vcur[:, :, 0]
    qh = q.reshape(b, HEADS, 1, HD).to(torch.bfloat16)
    mask = (torch.arange(s, device=dev) <= ctx).expand(b, 1, 1, s)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qh, kl, vl, attn_mask=mask, enable_gqa=True)
    lib_err = (lib.float().reshape(got.shape) - ref).abs().max().item()
    if not lib_err <= 2e-2:
        fail(f"K3 yardstick SDPA disagrees: {lib_err}")
    nbytes = 2 * b * KV_HEADS * ctx * HD * 2 + 2 * b * KV_HEADS * HD * 2 \
        + 2 * b * HEADS * HD * 4 + b * 4
    ops = 4 * b * HEADS * (ctx + 1) * HD
    record("flash_decode", f"B={b} KV={KV_HEADS} rep={REP} hd={HD} "
           f"S={s} ctx={ctx}", err, "max|err| <= 2e-3",
           timer(lambda: flash_decode(q, kc, vc, pos, **kw)),
           timer(lambda: flash_decode_plain(q, kc, vc, pos, **kw), reps=5),
           bound(nbytes, ops, "bf16"),
           timer(lambda: sdpa(qh, kl, vl, attn_mask=mask, enable_gqa=True)))

    # K4: dequant GEMM at the prefill chunk M = 48
    m = 48
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

    def server():
        return serve.Server(qp, cfg, n_slots=8, max_prefill_chunk=48,
                            prefill_bucket=16, cache_qtype="bf16",
                            cache_prompt=False, device=dev)

    warm = server()  # first-use costs (allocator, cuBLAS handles) off the run
    warm.submit(list(range(1, 65)), max_new=2)
    warm.run_until_done()
    del warm

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, int(n)).tolist()
               for n in rng.integers(64, 513, 16)]
    srv = server()
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
    if sorted(results) != list(range(16)):
        fail(f"not every request finished: {sorted(results)}")
    if any(len(t) != 32 for t in results.values()):
        fail("a request stopped short of max_new=32")
    if not all(0 <= t < VOCAB for ts in results.values() for t in ts):
        fail("a generated token is outside the vocabulary")
    if not all(launches.values()):
        fail(f"a kernel of the path never launched: {launches}")
    print(f"  served 16 requests: {st['prefill_tokens']} prompt tokens, "
          f"{st['generated_tokens']} generated, {st['decode_steps']} decode "
          f"steps in {wall:.2f} s", flush=True)
    print(f"  prefill {st['prefill_tokens'] / st['prefill_seconds']:.1f} "
          f"tok/s, decode {st['decode_tokens'] / st['decode_seconds']:.1f} "
          f"tok/s, median decode step {st['decode_step_ms_median']:.3f} ms",
          flush=True)
    print(f"  launches: {json.dumps(launches)}", flush=True)

    # every decode step runs K2 and K3 once per layer and K1 for wo, wgu,
    # w_down and lm_head; prefill (M >= 16) never reaches K1
    steps = st["decode_steps"]
    want = {"gemm_exact": steps * (3 * LAYERS + 1),
            "norm_qkv": steps * LAYERS, "flash_decode": steps * LAYERS}
    if any(launches[k] != v for k, v in want.items()):
        fail(f"decode launches {launches} differ from the path's {want}")

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

    # one prefill chunk (the server's shape, 1 x 48) and one 8-slot decode
    # step, each also run free through both op sets end to end
    toks = torch.as_tensor(rng.integers(0, VOCAB, (1, 48)), device=dev)
    fresh = llama.KVCache.init(cfg, 1, device=dev)
    pre = layerwise(toks, fresh.clone())
    free_pre = nmse(llama.forward(qp, cfg, toks, fresh.clone())[0],
                    llama.forward(qp, cfg, toks, fresh,
                                  ops=registry.PLAIN)[0])
    cache = llama.KVCache.init(cfg, 8, device=dev)
    llama.forward(qp, cfg, torch.as_tensor(rng.integers(0, VOCAB, (8, 48)),
                                           device=dev), cache)
    cache.pos = torch.tensor([48, 40, 33, 47, 20, 48, 1, 16],
                             dtype=torch.int32, device=dev)
    nt = torch.as_tensor(rng.integers(0, VOCAB, (8, 1)), device=dev)
    dec = layerwise(nt, cache.clone())
    free_dec = nmse(llama.forward(qp, cfg, nt, cache.clone())[0],
                    llama.forward(qp, cfg, nt, cache, ops=registry.PLAIN)[0])
    for name, (layer_e, logit_e), free in (("prefill chunk", pre, free_pre),
                                           ("decode step", dec, free_dec)):
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
    return launches


KERNEL_INFO = {
    "gemm_exact": ("quant_gemm_tpu_torch/csrc/gemm_exact.cu",
                   "quant_gemm_tpu/kernels/gemm_exact.py:775"),
    "norm_qkv": ("quant_gemm_tpu_torch/csrc/norm_qkv.cu",
                 "quant_gemm_tpu/kernels/gemm_megalayer.py:309"),
    "flash_decode": ("quant_gemm_tpu_torch/csrc/flash_decode.cu",
                     "quant_gemm_tpu/ops/attention.py:339"),
    "gemm_dequant": ("quant_gemm_tpu_torch/csrc/gemm_dequant.cu",
                     "quant_gemm_tpu/kernels/gemm_pallas.py:660"),
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
    from quant_gemm_tpu_torch.ops.attention import flash_decode

    wrappers = {"gemm_exact": gemm_exact, "norm_qkv": norm_qkv,
                "flash_decode": flash_decode, "gemm_dequant": gemm_dequant}
    launches = main_path(dev, wrappers)

    kernels = []
    for name, (src, rep) in KERNEL_INFO.items():
        mine = [r for r in rows if r["kernel"] == name]
        lib = [r["library_ms"] for r in mine]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in mine)
            else "operations",
            "library_ms": None if None in lib else sum(lib)})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
