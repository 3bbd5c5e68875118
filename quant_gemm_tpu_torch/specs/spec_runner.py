"""Spec-driven differential runner of the port: the counterpart of the JAX
package's ``specs/spec_runner.py``.

Each committed definition (``specs/definitions/**.json``, copies of the
JAX package's) names an operation, its parameters and an accuracy
threshold.  :func:`run_spec` draws the inputs from a seed with numpy (the
same draws as the JAX runner), runs the port's implementation on
``device`` (the card by default; ``device="cpu"`` runs every kernel's
plain version) and scores it against a numpy golden:

* ``gemm_quant``: the weight (and a Q8_1 activation) quantized by the
  torch quantizers on the device, the GEMM through
  ``registry.LADDER[impl]`` (default ``pallas_f32``: K4 on a float32
  activation), NMSE against the float32 product of the unquantized inputs;
* ``quantize``: the torch quantizer on the device, held bit for bit to
  ``formats.numpy_ref`` (container and dequantized values; a mismatch
  raises), round-trip NMSE;
* ``quantize_kquant``: the q4_K / q5_K encoders (numpy host code), the
  container decoded on the device and its GGUF bytes round-tripped bit for
  bit (a mismatch raises), round-trip NMSE;
* element ops: ``rmsnorm`` through K9 ``rms_norm_pallas``, ``softmax``
  through K10 ``softmax_pallas``, ``gelu``/``gelu_quick``/``silu`` and
  ``rope`` in plain torch, NMSE against the numpy goldens;
* ``attention``: K3 ``flash_decode`` / K5 ``flash_prefill`` on a cache
  whose k/v are ``bfloat16``, as the definitions give them (the JAX runner
  passes float32 arrays; the port's kernels take bf16 or int8 caches).
  The dense reference is computed in float32 numpy from the same
  bf16-rounded k/v, so the threshold measures the kernel and not the
  cast.  The JAX runner's tile arguments (``tq``, ``ts``) are TPU knobs
  and are dropped.  Metric: max|out - ref|.

``python -m quant_gemm_tpu_torch.specs.spec_runner [--device cpu]`` sweeps
every definition, prints the table and exits non-zero on any failure.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from dataclasses import dataclass

import numpy as np
import torch

from ..formats import kquants, numpy_ref
from ..formats import quant as tq
from ..harness import datagen
from ..harness.metrics import ErrorMetrics
from ..kernels.registry import LADDER
from ..ref import gemm as refg
from ..utils import resolve_device

HERE = pathlib.Path(__file__).parent
DEFAULT_GEMM_IMPL = "pallas_f32"


@dataclass
class SpecResult:
    name: str
    metric: str
    nmse: float
    threshold: float
    passed: bool

    def row(self) -> str:
        status = "PASS" if self.passed else "FAIL"
        return (f"{self.name:<28s} {self.metric:<18s} {self.nmse:10.3e} < "
                f"{self.threshold:g}  {status}")


def load(path) -> dict:
    return json.loads(pathlib.Path(path).read_text())


def definitions() -> list[pathlib.Path]:
    return sorted((HERE / "definitions").rglob("*.json"))


def _result(d: dict, err: float) -> SpecResult:
    thr = d["accuracy"]["threshold"]
    return SpecResult(d["name"], d["accuracy"]["metric"], err, thr,
                      bool(err < thr))


def _memo(memo: dict | None, key, make):
    """``make()``, or what an earlier call put in the caller's ``memo``
    under ``key`` (None: always ``make()``)."""
    if memo is None:
        return make()
    if key not in memo:
        memo[key] = make()
    return memo[key]


def _run_gemm(d: dict, impl: str, params: dict, dev,
              memo: dict | None) -> SpecResult:
    m, n, k = params["M"], params["N"], params["K"]
    a_np = _memo(memo, ("A", m, k), lambda: datagen.normal((m, k), seed=42))
    w_np = _memo(memo, ("W", n, k), lambda: datagen.normal((n, k), seed=43))
    golden = _memo(memo, ("C", m, n, k), lambda: refg.gemm_fp32(a_np, w_np))
    a = torch.tensor(a_np, device=dev)
    w = torch.tensor(w_np, device=dev)
    w_q = tq.QUANTIZE[d["inputs"]["W"]["dtype"]](w)
    act = tq.quantize_q8_1(a) if d["inputs"]["A"]["dtype"] == "q8_1" else a
    out = LADDER[impl](w_q, act)
    metrics = ErrorMetrics.compute(out.cpu().numpy(), golden)
    return _result(d, metrics.nmse)


def _run_quantize(d: dict, params: dict, dev) -> SpecResult:
    qtype = d["outputs"]["y"]["dtype"]
    x = datagen.uniform((params["R"], params["K"]), seed=42)
    golden = numpy_ref.QUANTIZE[qtype](x)
    t = tq.QUANTIZE[qtype](torch.tensor(x, device=dev))
    back = tq.dequantize(t).cpu().numpy()
    same = all(np.array_equal(np.asarray(g), f.cpu().numpy())
               for g, f in zip(golden, t))
    if not (same and np.array_equal(back, numpy_ref.dequantize(golden))):
        raise AssertionError(f"torch/numpy divergence for {qtype}")
    return _result(d, ErrorMetrics.compute(back, x).nmse)


def _run_kquant(d: dict, params: dict, dev) -> SpecResult:
    qtype = d["outputs"]["y"]["dtype"]
    x = datagen.uniform((params["R"], params["K"]), seed=42)
    if qtype == "q4_k":
        encode, decode = kquants.quantize_q4_k, kquants.dequantize_q4_k
        to_b, from_b = kquants.to_bytes, kquants.from_bytes
    else:
        encode, decode = kquants.quantize_q5_k, kquants.dequantize_q5_k
        to_b, from_b = kquants.to_bytes_q5_k, kquants.from_bytes_q5_k
    t = encode(x)
    t = type(t)(*(f.to(dev) for f in t))
    back = decode(t).cpu().numpy()
    rt = from_b(to_b(t))
    if not all(torch.equal(a, b) for a, b in zip(t, rt)):
        raise AssertionError(f"{qtype}: the GGUF bytes do not round-trip")
    return _result(d, ErrorMetrics.compute(back, x).nmse)


def _run_elementop(d: dict, params: dict, dev) -> SpecResult:
    from ..ops import activations, rope
    from ..ops.rms_norm import rms_norm_pallas, rms_norm_ref
    from ..ops.softmax import softmax_pallas, softmax_ref

    name = d["name"]
    if name == "rope":
        s, h, hd = params["S"], params["H"], params["D"]
        x = datagen.normal((s, h, hd), seed=42)
        pos = np.arange(3, 3 + s)
        ref = rope.rope_ref(x, pos)
        cache = rope.rope_cache(64, hd, params.get("base", 10000.0),
                                device=dev)
        out = rope.apply_rope(torch.tensor(x, device=dev),
                              torch.tensor(pos, device=dev), cache)
    else:
        x = datagen.normal((params["R"], params["C"]), seed=42)
        xt = torch.tensor(x, device=dev)
        if name == "rmsnorm":
            wt = datagen.uniform((params["C"],), 0.5, 1.5, seed=1)
            ref = rms_norm_ref(x, wt)
            out = rms_norm_pallas(xt, torch.tensor(wt, device=dev))
        elif name == "softmax":
            ref = softmax_ref(x)
            out = softmax_pallas(xt)
        else:
            ref = getattr(activations, f"{name}_ref")(x)
            out = getattr(activations, name)(xt)
    return _result(d, ErrorMetrics.compute(out.cpu().numpy(), ref).nmse)


def _dense_attention(q, k, v, mask) -> np.ndarray:
    """Float32 numpy attention of q [B, G, T, R, hd] over k, v [B, G, S,
    hd] with ``mask`` [B, T, S] True where a slot is hidden."""
    sc = np.einsum("bgtrd,bgsd->bgtrs", q, k, dtype=np.float32)
    sc /= np.float32(np.sqrt(q.shape[-1]))
    sc = np.where(mask[:, None, :, None, :], -np.inf, sc)
    sc -= sc.max(-1, keepdims=True)
    pr = np.exp(sc)
    pr /= pr.sum(-1, keepdims=True)
    return np.einsum("bgtrs,bgsd->bgtrd", pr, v, dtype=np.float32)


def _run_attention(d: dict, params: dict, dev) -> SpecResult:
    from ..ops.attention import flash_decode, flash_prefill

    b, kv, rep = params["B"], params["KV"], params["REP"]
    s, hd = params["S"], params["HD"]
    k = torch.tensor(datagen.normal((b, kv, s, hd), seed=43),
                     device=dev).to(torch.bfloat16)
    v = torch.tensor(datagen.normal((b, kv, s, hd), seed=44),
                     device=dev).to(torch.bfloat16)
    k32, v32 = (t.to(torch.float32).cpu().numpy() for t in (k, v))
    span = np.arange(s)
    if d["name"] == "flash_prefill":
        t = params["T"]
        q = datagen.normal((b, kv, t * rep, hd), seed=42)
        pos0 = np.linspace(0, s - t, b).astype(np.int32)
        out = flash_prefill(torch.tensor(q, device=dev), k, v,
                            torch.tensor(pos0, device=dev), rep=rep)
        mask = span[None, None, :] > (pos0[:, None] + np.arange(t))[:, :, None]
        ref = _dense_attention(q.reshape(b, kv, t, rep, hd), k32, v32, mask)
    else:
        q = datagen.normal((b, kv, rep, hd), seed=42)
        pos = np.linspace(0, s - 1, b).astype(np.int32)
        out = flash_decode(torch.tensor(q, device=dev), k, v,
                           torch.tensor(pos, device=dev))
        mask = span[None, None, :] > pos[:, None, None]
        ref = _dense_attention(q[:, :, None], k32, v32, mask)
    err = float(np.abs(out.cpu().numpy() - ref.reshape(out.shape)).max())
    return _result(d, err)


def run_spec(path, impl: str | None = None, params: dict | None = None,
             device="cuda", memo: dict | None = None) -> SpecResult:
    """One definition on ``device``; ``params`` override the definition's
    (for example full-width GEMM shapes), ``impl`` names the GEMM's rung
    of ``registry.LADDER``.  A ``memo`` dict that the caller passes to
    several calls keeps the GEMM's seeded draws and golden product for
    the next call at the same shape (a full-width sweep draws each operand
    once); the caller drops it when done.  None draws anew."""
    dev = resolve_device(device)
    d = load(path)
    p = dict(d.get("params", {}))
    p.update(params or {})
    op = d["op_type"]
    if op == "gemm_quant":
        return _run_gemm(d, impl or DEFAULT_GEMM_IMPL, p, dev, memo)
    if op == "quantize":
        return _run_quantize(d, p, dev)
    if op == "quantize_kquant":
        return _run_kquant(d, p, dev)
    if op == "attention":
        return _run_attention(d, p, dev)
    return _run_elementop(d, p, dev)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Run every committed spec definition on the port.")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (default): the kernels on the card; cpu: "
                        "their plain PyTorch versions")
    args = parser.parse_args(argv)
    results = [run_spec(p, device=args.device) for p in definitions()]
    for r in results:
        print(r.row())
    failed = [r for r in results if not r.passed]
    print(f"\n{len(results) - len(failed)}/{len(results)} specs passed")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
