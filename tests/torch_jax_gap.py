"""Measure how far the port's logits sit from the JAX package's, on the CPU.

    python tests/torch_jax_gap.py

At the small Llama of ``tests/test_torch_model.py`` (same weights) it
prints, as JSON lines:

* ``free``: max|delta| / max|logits| and NMSE of the port's forward against
  the JAX forward, each side quantizing its own activations, over 6 seeds
  x 2 caches (bf16, q8) x (prefill T=16, T=48, T=128 through flash
  prefill, three decode steps after the T=48 prefill) = 72 cases, with the
  largest of each per route;
* ``jax_codes``: the same for prefill with every Q8_1 activation of the
  JAX forward recorded and fed to the port, and the number of codes that
  the port's own quantizer would have set differently (by at most one) at
  each quantizer call (T=16, 48 and 128);
* ``server``: the greedy transcripts of the JAX and the port ``Server`` on
  the test's two interleaved requests, whether they are equal, and the
  smallest top-1/top-2 margin along them, relative to max|logits|.

The tolerances of ``tests/test_torch_model.py`` are set from these
readings.  The script imports the JAX package as the tests do; the port
itself never does.
"""

import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from quant_gemm_tpu.formats import jax_quant as jq  # noqa: E402
from quant_gemm_tpu.models import llama as jl  # noqa: E402
from quant_gemm_tpu.models import serve as js  # noqa: E402
from quant_gemm_tpu_torch.formats.blocks import Q8_1Tensor  # noqa: E402
from quant_gemm_tpu_torch.kernels import registry  # noqa: E402
from quant_gemm_tpu_torch.models import llama as tl  # noqa: E402
from quant_gemm_tpu_torch.models import serve as ts  # noqa: E402

JCFG = jl.LlamaConfig(vocab=256, dim=512, n_layers=2, n_heads=8,
                      n_kv_heads=2, d_ff=1024, max_seq=128)
TCFG = tl.LlamaConfig(**JCFG._asdict())


def gap(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return {"max_rel": float(np.abs(got - want).max() / np.abs(want).max()),
            "nmse": float(((got - want) ** 2).sum() / (want ** 2).sum())}


def free_run(qj, qt):
    rows = []
    for qtype in ("bf16", "q8"):
        for seed in range(6):
            for t in (16, 48, 128):
                tokens = np.random.default_rng(100 * seed + t).integers(
                    0, 256, (2, t)).astype(np.int32)
                lj, cj = jl.jit_forward(qj, JCFG, jnp.asarray(tokens),
                                        jl.KVCache.init(JCFG, 2, qtype))
                lt, ct = tl.forward(qt, TCFG, torch.from_numpy(tokens),
                                    tl.KVCache.init(TCFG, 2, qtype,
                                                    device="cpu"))
                rows.append({"case": f"{qtype} prefill T={t} seed={seed}",
                             "route": f"{qtype} prefill T={t}",
                             **gap(lt, lj)})
                if t != 48:
                    continue
                rng = np.random.default_rng(seed)
                for step in range(3):
                    nt = rng.integers(0, 256, (2, 1)).astype(np.int32)
                    dj, cj = jl.jit_forward(qj, JCFG, jnp.asarray(nt), cj)
                    dt, ct = tl.forward(qt, TCFG, torch.from_numpy(nt), ct)
                    rows.append({"case": f"{qtype} decode step {step} "
                                         f"seed={seed}",
                                 "route": f"{qtype} decode", **gap(dt, dj)})
    return rows


def with_jax_codes(qj, qt, t):
    tokens = np.random.default_rng(t).integers(0, 256, (2, t)).astype(np.int32)
    recorded, quantize_j = [], jq.quantize_q8_1

    def record(x):
        recorded.append(quantize_j(x))
        return recorded[-1]

    jq.quantize_q8_1 = record
    try:  # eager, so that every quantizer call hands over its arrays
        lj, _ = jl.forward(qj, JCFG, jnp.asarray(tokens),
                           jl.KVCache.init(JCFG, 2))
    finally:
        jq.quantize_q8_1 = quantize_j
    replay, flips, quantize_t = iter(recorded), [], registry.quantize_q8_1

    def jax_codes(x):
        want = Q8_1Tensor(*(torch.from_numpy(np.array(a))
                            for a in next(replay)))
        own = quantize_t(x).qs.int() - want.qs.int()
        flips.append({"differ": int((own != 0).sum()),
                      "max": int(own.abs().max())})
        return want

    registry.quantize_q8_1 = jax_codes
    try:
        lt, _ = tl.forward(qt, TCFG, torch.from_numpy(tokens),
                           tl.KVCache.init(TCFG, 2, device="cpu"))
    finally:
        registry.quantize_q8_1 = quantize_t
    return {"case": f"prefill T={t}", **gap(lt, lj), "flips": flips}


def servers(qj, qt):
    rng = np.random.default_rng(6)
    prompts = [[int(x) for x in rng.integers(0, 256, n)] for n in (96, 48)]
    news = (6, 9)
    srv_j = js.Server(qj, JCFG, n_slots=2, max_prefill_chunk=48,
                      prefill_bucket=16, cache_prompt=False)
    srv_t = ts.Server(qt, TCFG, n_slots=2, max_prefill_chunk=48,
                      prefill_bucket=16, cache_prompt=False, device="cpu")
    for srv in (srv_j, srv_t):
        for p, n in zip(prompts, news):
            srv.submit(p, max_new=n)
    out_j, out_t = srv_j.run_until_done(), srv_t.run_until_done()
    rows = []
    for rid, p in enumerate(prompts):
        cache = tl.KVCache.init(TCFG, 1, device="cpu")
        for off in range(0, len(p), 48):
            logits, cache = tl.forward(qt, TCFG, torch.tensor([p[off:off + 48]]),
                                       cache)
        margins = []
        for tok in out_t[rid]:
            top2 = logits[0, -1].topk(2).values
            margins.append(float((top2[0] - top2[1])
                                 / logits[0, -1].abs().max()))
            logits, cache = tl.forward(qt, TCFG, torch.tensor([[tok]]), cache)
        rows.append({"request": rid, "tokens": len(out_t[rid]),
                     "equal": out_t[rid] == out_j[rid],
                     "min_margin": min(margins)})
    return rows


def main():
    params = jl.init_params(JCFG, seed=3)
    qj = jl.quantize_params(params)
    qt = tl.quantize_params(params, device="cpu")
    free = free_run(qj, qt)
    for row in free:
        print(json.dumps({"free": row}))
    for route in dict.fromkeys(r["route"] for r in free):
        mine = [r for r in free if r["route"] == route]
        print(json.dumps({"free_max": {
            "route": route, "max_rel": max(r["max_rel"] for r in mine),
            "nmse": max(r["nmse"] for r in mine), "cases": len(mine),
            "below_2e-7": sum(r["max_rel"] < 2e-7 for r in mine)}}))
    print(json.dumps({"free_max": {
        "route": "all", "max_rel": max(r["max_rel"] for r in free),
        "nmse": max(r["nmse"] for r in free), "cases": len(free)}}))
    for t in (16, 48, 128):
        print(json.dumps({"jax_codes": with_jax_codes(qj, qt, t)}))
    for row in servers(qj, qt):
        print(json.dumps({"server": row}))


if __name__ == "__main__":
    main()
