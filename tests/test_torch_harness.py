"""The port's measuring tools on the CPU (``harness/benchmark.py``,
``harness/profiling.py``, ``harness/aot.py``).

* ``interleaved_medians``: JAX's seven robustness cases
  (``tests/test_harness.py``) on the port's runner with a scripted timer,
  and the same scripted samples through JAX's runner and the port's, which
  must return the same dict;
* ``weight_bytes`` against JAX's (its layout switches off, the per-32
  GGUF bytes) and against ``prepared_bytes`` of the port's layout;
* ``roofline`` / ``bound`` against the arithmetic ``chip_smoke.py`` used
  for its kernel rows (and the bounds PERF.md section 6 records);
* ``resource_report`` on a ``ptxas -v`` log an H100 build printed;
* ``device_breakdown``'s grouping and ``overlap_report``'s classes on
  synthetic profiler events; ``trace`` and ``benchmark_kernel`` on the
  CPU when asked.
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from quant_gemm_tpu.harness import benchmark as jbm
from quant_gemm_tpu_torch.formats import kquants
from quant_gemm_tpu_torch.formats import quant as tq
from quant_gemm_tpu_torch.harness import aot
from quant_gemm_tpu_torch.harness import benchmark as bm
from quant_gemm_tpu_torch.harness import profiling as pf
from quant_gemm_tpu_torch.kernels import layout


class FakeTimer:
    """Scripted stand-in for benchmark_kernel: pops per-case time queues
    (``None``: an invalid rep).  ``mod`` is the benchmark module whose
    BenchResult it returns."""

    def __init__(self, queues, mod=bm):
        self.queues = {k: list(v) for k, v in queues.items()}
        self.calls = 0
        self.mod = mod

    def __call__(self, fn, args, *, name="", bytes_accessed=0, **kw):
        self.calls += 1
        base = name.rsplit(" #", 1)[0]
        q = self.queues[base]
        t = q.pop(0) if q else q.append(None) or 1.0
        if t is None:
            return self.mod.BenchResult(base, 1e-9, valid=False)
        return self.mod.BenchResult(base, t, bytes=bytes_accessed)


def _run(monkeypatch, queues, cases, **kw):
    timer = FakeTimer(queues)
    monkeypatch.setattr(bm, "benchmark_kernel", timer)
    return bm.interleaved_medians(cases, verbose=False, **kw), timer


def test_median_of_clean_reps(monkeypatch):
    med, _ = _run(monkeypatch, {"a": [100e-6, 101e-6, 99e-6, 102e-6, 98e-6]},
                  [("a", None, (), 0)])
    assert med["a"] == pytest.approx(100e-6)


def test_outlier_rejected_and_replaced(monkeypatch):
    med, timer = _run(
        monkeypatch,
        {"a": [100e-6, 10000e-6, 99e-6, 101e-6, 100e-6, 100e-6, 100e-6]},
        [("a", None, (), 0)])
    assert med["a"] == pytest.approx(100e-6)
    assert timer.calls >= 6  # at least one extra round ran


def test_physically_impossible_rep_rejected(monkeypatch):
    # 1 GB in 0.2 ms = 5000 GB/s > PHYS_MAX_GBPS (the H100's 3350 + 5%):
    # rejected outright though it survives the 3x-of-median window
    by = int(1e9)
    med, _ = _run(monkeypatch,
                  {"a": [0.5e-3, 0.2e-3, 0.5e-3, 0.5e-3, 0.5e-3, 0.5e-3]},
                  [("a", None, (), by)])
    assert med["a"] == pytest.approx(0.5e-3)
    assert by / 0.2e-3 / 1e9 > bm.PHYS_MAX_GBPS > by / 0.5e-3 / 1e9


def test_invalid_reps_skipped(monkeypatch):
    med, _ = _run(monkeypatch,
                  {"a": [None, 50e-6, 50e-6, None, 50e-6, 50e-6, 50e-6]},
                  [("a", None, (), 0)])
    assert med["a"] == pytest.approx(50e-6)


def test_raising_case_dropped_not_fatal(monkeypatch):
    class Boom(FakeTimer):
        def __call__(self, fn, args, *, name="", bytes_accessed=0, **kw):
            if name.startswith("bad"):
                raise RuntimeError("launch failed")
            return super().__call__(fn, args, name=name,
                                    bytes_accessed=bytes_accessed, **kw)

    monkeypatch.setattr(bm, "benchmark_kernel", Boom({"ok": [1e-3] * 8,
                                                      "bad": []}))
    med = bm.interleaved_medians([("ok", None, (), 0), ("bad", None, (), 0)],
                                 verbose=False)
    assert med == {"ok": pytest.approx(1e-3)}


def test_raises_when_no_valid_samples(monkeypatch):
    with pytest.raises(RuntimeError, match="no valid samples"):
        _run(monkeypatch, {"a": [None] * 20}, [("a", None, (), 0)])


def test_interleaving_order(monkeypatch):
    order = []

    class Rec(FakeTimer):
        def __call__(self, fn, args, *, name="", bytes_accessed=0, **kw):
            order.append(name)
            return super().__call__(fn, args, name=name,
                                    bytes_accessed=bytes_accessed, **kw)

    monkeypatch.setattr(bm, "benchmark_kernel", Rec({"a": [1e-3] * 5,
                                                     "b": [2e-3] * 5}))
    med = bm.interleaved_medians([("a", None, (), 0), ("b", None, (), 0)],
                                 verbose=False)
    assert med == {"a": pytest.approx(1e-3), "b": pytest.approx(2e-3)}
    assert order[:4] == ["a #0", "b #0", "a #1", "b #1"]


SCRIPTS = {
    "clean": ({"a": [100e-6, 101e-6, 99e-6, 102e-6, 98e-6]}, 0),
    "outlier": ({"a": [100e-6, 10000e-6, 99e-6, 101e-6, 100e-6, 100e-6,
                       100e-6], "b": [3e-3, 3.1e-3, 2.9e-3, 3e-3, 3e-3]}, 0),
    "invalid": ({"a": [None, 50e-6, 50e-6, None, 50e-6, 50e-6, 50e-6]}, 0),
    "sub_30us": ({"a": [10e-6, 12e-6, 9e-6, 11e-6, 10e-6, 13e-6, 8e-6, 10e-6],
                  "b": [1e-3] * 8}, 0),
    "fast_bytes": ({"a": [2e-3, 0.05e-3, 2e-3, 2e-3, 2e-3, 2e-3, 2e-3]},
                   int(1e9)),
}


@pytest.mark.parametrize("script", SCRIPTS)
def test_same_samples_same_medians_as_jax(monkeypatch, script):
    """One script through JAX's runner and the port's: the same dict (the
    algorithm is JAX's, word for word; the physical cap's samples lie
    beyond both packages' caps)."""
    queues, by = SCRIPTS[script]
    cases = [(k, None, (), by) for k in queues]
    got = {}
    for mod in (jbm, bm):
        monkeypatch.setattr(mod, "benchmark_kernel", FakeTimer(queues, mod))
        got[mod] = mod.interleaved_medians(cases, verbose=False)
    assert got[bm] == got[jbm]


@pytest.mark.parametrize("qtype", ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0",
                                   "q4_k", "q5_k"])
def test_weight_bytes_match_jax(qtype):
    """The per-32 formats at their GGUF bytes (JAX's f16 scales, qh
    plane); q4_k and q5_k at JAX's f32 (d', m') planes with the q5 family's
    bit plane (``qh2=False``, the port's ``qh``)."""
    n, k = 768, 2048
    want = jbm.weight_bytes(qtype, n, k, f32_scales=qtype in ("q4_k", "q5_k"),
                            qh2=False)
    assert bm.weight_bytes(qtype, n, k) == want
    if qtype == "q4_k":
        assert bm.weight_bytes(qtype, n, k) == jbm.weight_bytes(qtype, n, k)


def _prepared(qtype, n, k):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(n, k, generator=g) * 0.05
    if qtype == "q4_k":
        return layout.prepare(kquants.to_effective(kquants.quantize_q4_k(
            x.numpy(), search=False)))
    if qtype == "q5_k":
        return layout.prepare(kquants.to_effective_q5_k(
            kquants.quantize_q5_k(x.numpy(), search=False)))
    return layout.prepare(tq.QUANTIZE[qtype](x))


@pytest.mark.parametrize("qtype", ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0",
                                   "q4_k", "q5_k"])
def test_prepared_bytes_equal_weight_bytes(qtype):
    n, k = 96, 512  # unpadded: the port's layout pads nothing
    assert bm.prepared_bytes(_prepared(qtype, n, k)) == \
        bm.weight_bytes(qtype, n, k)


def _old_bound(nbytes, ops, kind):
    """chip_smoke.py's ``bound`` before it moved here, verbatim."""
    hbm = 3.35e12
    peak = {"int8": 1979e12, "bf16": 989e12, "bf16x3": 989e12 / 3,
            "f32": 67e12}
    t_bytes = nbytes / hbm * 1e3
    t_ops = ops / peak[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _q4_bytes(n, k):
    return n * k // 2 + n * (k // 32) * 2


# PERF.md section 6, q4_0 at TinyLlama width: K1 (M 8) wo / wgu / w_down /
# lm_head, K4 (M 128, bf16 A) wqkv / wo / wgu / w_down / lm_head
TINY = {"wqkv": (2560, 2048), "wo": (2048, 2048), "wgu": (11264, 2048),
        "w_down": (2048, 5632), "lm_head": (32000, 2048)}
PERF_K1 = {"wo": 0.00073, "wgu": 0.00399, "w_down": 0.00197,
           "lm_head": 0.01132}
PERF_K4 = {"wqkv": (0.00143, "bytes"), "wo": (0.00117, "bytes"),
           "wgu": (0.00597, "operations"), "w_down": (0.00299, "operations"),
           "lm_head": (0.01696, "operations")}


@pytest.mark.parametrize("name", list(TINY))
def test_roofline_equals_the_old_bound_and_perf_rows(name):
    n, k = TINY[name]
    m = 8  # K1: Q8_1 codes + f16 d and s per 32
    old = _old_bound(_q4_bytes(n, k) + m * k + 2 * m * (k // 32) * 2
                     + m * n * 4, 2 * m * n * k, "int8")
    rf = pf.roofline("q4_0", m, n, k, act_bytes_per_elem=1.125, peak="int8")
    assert rf.time_us / 1e3 == pytest.approx(old[0], rel=1e-12)
    assert (rf.bound == "memory") == (old[1] == "bytes")
    assert pf.bound(rf.bytes, rf.flops, "int8") == old
    if name in PERF_K1:
        assert round(rf.time_us / 1e3, 5) == PERF_K1[name]
    m = 128  # K4: the bf16 operand
    old = _old_bound(_q4_bytes(n, k) + m * k * 2 + m * n * 4,
                     2 * m * n * k, "bf16")
    rf = pf.roofline("q4_0", m, n, k, act_bytes_per_elem=2.0, peak="bf16")
    assert rf.time_us / 1e3 == pytest.approx(old[0], rel=1e-12)
    assert (round(rf.time_us / 1e3, 5), old[1]) == PERF_K4[name]
    assert rf.efficiency(rf.time_us / 1e6) == pytest.approx(1.0)


@pytest.mark.parametrize("kind", ["int8", "bf16", "bf16x3", "f32"])
def test_bound_matches_old_arithmetic(kind):
    for nbytes, ops in ((1e6, 1e9), (1e9, 1e9), (5e7, 3e12)):
        assert pf.bound(nbytes, ops, kind) == _old_bound(nbytes, ops, kind)
    # a number as the peak is TFLOP/s, as JAX's mxu_tflops
    assert pf.roofline("q8_0", 16, 256, 512, peak=989.0).compute_time_us == \
        pytest.approx(pf.roofline("q8_0", 16, 256, 512).compute_time_us)


# ``nvcc -Xptxas -v`` output of chip_smoke.py's start-up build on an H100
# machine (CUDA 12.8): csrc/act_quant.cu, csrc/attn_tail.cu
# and the first two entries of csrc/flash_prefill.cu (one spills)
PTXAS_ACT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__8405fffc_12_act_quant_cu_eafe0a7d16act_quant_kernelILb0EEEvPKfPaP6__halfS5_P13__nv_bfloat16ii' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__8405fffc_12_act_quant_cu_eafe0a7d16act_quant_kernelILb0EEEvPKfPaP6__halfS5_P13__nv_bfloat16ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 28 registers, used 0 barriers
ptxas info    : Compile time = 109.269 ms
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__8405fffc_12_act_quant_cu_eafe0a7d16act_quant_kernelILb1EEEvPKfPaP6__halfS5_P13__nv_bfloat16ii' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__8405fffc_12_act_quant_cu_eafe0a7d16act_quant_kernelILb1EEEvPKfPaP6__halfS5_P13__nv_bfloat16ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, used 0 barriers
ptxas info    : Compile time = 33.366 ms
"""
PTXAS_TAIL = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__57842295_12_attn_tail_cu_eafe0a7d16attn_tail_kernelENS_8TailArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__57842295_12_attn_tail_cu_eafe0a7d16attn_tail_kernelENS_8TailArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 165 registers, used 1 barriers, 64 bytes smem
ptxas info    : Compile time = 2428.281 ms
"""
PTXAS_PREFILL = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__f7727340_16_flash_prefill_cu_eafe0a7d20flash_prefill_kernelILi128ELb0EEEvPKfPKvS4_S2_S2_PKiPfS7_S7_iiiixxiif' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__f7727340_16_flash_prefill_cu_eafe0a7d20flash_prefill_kernelILi128ELb0EEEvPKfPKvS4_S2_S2_PKiPfS7_S7_iiiixxiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 254 registers, used 1 barriers
ptxas info    : Compile time = 1181.923 ms
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__f7727340_16_flash_prefill_cu_eafe0a7d20flash_prefill_kernelILi128ELb1EEEvPKfPKvS4_S2_S2_PKiPfS7_S7_iiiixxiif' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__f7727340_16_flash_prefill_cu_eafe0a7d20flash_prefill_kernelILi128ELb1EEEvPKfPKvS4_S2_S2_PKiPfS7_S7_iiiixxiif
    16 bytes stack frame, 12 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 16 bytes cumulative stack size
ptxas info    : Compile time = 1379.745 ms
"""


def test_resource_report_parses_ptxas():
    rows = aot.resource_report({"act_quant": PTXAS_ACT,
                                "attn_tail": PTXAS_TAIL,
                                "flash_prefill": PTXAS_PREFILL})
    assert [r.source for r in rows] == ["act_quant", "act_quant",
                                        "attn_tail", "flash_prefill",
                                        "flash_prefill"]
    assert [r.registers for r in rows] == [28, 24, 165, 254, 255]
    assert [r.smem for r in rows] == [0, 0, 64, 0, 0]
    assert all(r.cmem == 0 for r in rows)  # this ptxas prints no cmem
    p = rows[-1]
    assert (p.stack, p.spill_stores, p.spill_loads) == (16, 12, 28)
    assert all(r.spill_stores == r.spill_loads == r.stack == 0
               for r in rows[:-1])
    assert rows[0].mangled.startswith("_ZN45_GLOBAL__N__8405fffc_12_act_")
    if aot.shutil.which("c++filt"):
        assert rows[0].name.startswith(
            "void (anonymous namespace)::act_quant_kernel<false>(")
        assert rows[-1].name.startswith(
            "void (anonymous namespace)::flash_prefill_kernel<128, true>(")
    text = aot.format_report(rows)
    assert "act_quant: 2 entries, registers 24-28, most spill 0/0 B" in text
    assert ("flash_prefill: 2 entries, registers 254-255, most spill 12/28 B"
            in text)
    assert aot.resource_report(PTXAS_ACT)[0].source == ""
    # a cmem figure, where a ptxas prints one, is summed over its banks
    line = "ptxas info    : Used 8 registers, 400 bytes cmem[0], 8 bytes cmem[2]"
    cm = aot.resource_report(PTXAS_ACT.replace(
        "ptxas info    : Used 28 registers, used 0 barriers", line))
    assert (cm[0].registers, cm[0].cmem) == (8, 408)


def test_aot_flags_follow_the_build():
    flags = aot._flags("sm_90a")
    from quant_gemm_tpu_torch.kernels import _build

    assert flags == _build.NVCC_FLAGS
    assert "arch=compute_80,code=sm_80" in aot._flags("sm_80")
    assert "-v" in flags and "-Xptxas" in flags


def test_aot_compile_raises_without_nvcc(monkeypatch):
    from quant_gemm_tpu_torch.kernels import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    with pytest.raises(RuntimeError, match="nvcc"):
        aot.aot_compile(["gemm_exact"])


def _ev(name, start, end, cuda=False):
    return SimpleNamespace(
        name=name, device_type="DeviceType.CUDA" if cuda else
        "DeviceType.CPU", time_range=SimpleNamespace(
            start=start, end=end, elapsed_us=lambda: end - start))


def test_overlap_report_classes():
    evs = [_ev("ppermute.start#3", 0, 5), _ev("ring_gemm", 6, 20),
           _ev("ppermute.wait#3", 21, 30),
           _ev("ppermute.start#4", 40, 45), _ev("ppermute.wait#4", 46, 50),
           _ev("ppermute.start#5", 60, 62), _ev("gemm_exact_kernel", 63, 90,
                                                cuda=True),
           _ev("ppermute.wait#5", 64, 70),
           # a host copy in a span hides nothing: #6 is blocking
           _ev("ppermute.start#6", 71, 73),
           _ev("Memcpy HtoD (Pageable -> Device)", 74, 75, cuda=True),
           _ev("ppermute.wait#6", 74, 76),
           _ev("collective.all_reduce", 100, 120), _ev("ring_gemm", 130, 140)]
    rep = aot.overlap_report(evs)
    assert rep == {"overlapped": 2, "blocking": 2, "resynced": 0, "sync": 1,
                   "hidden_by": ["ring_gemm", "gemm_exact_kernel"]}
    with pytest.raises(ValueError, match="not waited"):
        aot.overlap_report(evs[:1])


def test_device_breakdown_groups():
    names = {"void gemm_exact_kernel<4>(...)": "K1 gemm_exact",
             "gemm_exact_fused_kernel": "K6 gemm_exact_fused",
             "norm_qkv_kernel": "K2 norm_qkv",
             "flash_decode_kernel<64>": "K3 flash_decode",
             "attn_merge_kernel": "K3/K5 split-S merge",
             "act_quant_kernel": "Q8_1 quantize (act_quant)",
             "sm90_xmma_gemm_bf16": "library matmul (the plain K16 "
                                    "prefill route, LoRA deltas)",
             "Memcpy HtoD": "memcpy/memset",
             "elementwise_kernel": pf.OTHER}
    for n, label in names.items():
        assert pf.group(n) == label
    kern = [_ev("gemm_exact_kernel", 0, 10, True),
            _ev("norm_qkv", 10, 14, True), _ev("elementwise_kernel", 20, 22,
                                                True)]
    out = pf.summarize("synthetic", kern, host_ms=1.0)
    assert out["busy_ms"] == pytest.approx(0.016)
    assert out["device_span_ms"] == pytest.approx(0.022)
    assert out["idle_share"] == pytest.approx(1 - 16 / 22)
    assert list(out["groups"]) == ["K1 gemm_exact", "K2 norm_qkv", pf.OTHER]
    with pytest.raises(pf.ProfileError, match="none of the hand kernels"):
        pf.summarize("no hand kernel", kern[2:], 1.0)


def test_trace_and_cpu_timing_when_asked(tmp_path):
    with pf.trace(str(tmp_path)) as path:
        with torch.profiler.record_function("qgt.marker"):
            torch.ones(64).sum()
    events = json.loads(open(path).read())["traceEvents"]
    assert any(e.get("name") == "qgt.marker" for e in events)
    r = bm.benchmark_kernel(torch.add, (torch.ones(8), 1.0), name="add",
                            reps=5, device="cpu")
    assert r.valid and r.device == "cpu" and r.time_s > 0
    with pytest.raises(ValueError, match="CUDA device"):
        bm.DeviceTimer("cpu")


def test_strip_lead_removes_the_lead_kernels():
    """``trace``'s lead graph on the card: its surviving kernels leave the
    Chrome trace and are counted; a trace that kept none of them raises,
    since the block's first graph kernels may then be lost too."""
    other = [{"cat": "kernel", "name": "gemm_exact_kernel<4>", "ts": 9.0},
             {"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 1.0},
             {"cat": "cpu_op", "name": pf.LEAD_NAME, "ts": 2.0}]
    lead = [{"cat": "kernel", "ts": float(t),
             "name": f"at::cuda::(anonymous namespace)::{pf.LEAD_NAME}(long)"}
            for t in range(3)]
    doc = {"traceEvents": lead + other}
    assert pf.strip_lead(doc) == 3
    assert doc["traceEvents"] == other
    with pytest.raises(pf.ProfileError, match="lead graph"):
        pf.strip_lead({"traceEvents": list(other)})


def test_trace_loss_needs_the_card():
    """``scripts/trace_loss.py`` measures the profiler on the card and
    refuses to run without one."""
    from quant_gemm_tpu_torch.scripts import trace_loss

    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run")
    with pytest.raises(RuntimeError, match="cuda"):
        trace_loss.main(["--seconds", "0"])


def test_benchmark_kernel_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the default device on a machine without a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        bm.benchmark_kernel(torch.add, (torch.ones(2), 1.0))
