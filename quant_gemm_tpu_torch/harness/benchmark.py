"""Kernel timing on the card: :func:`benchmark_kernel` and the robust
:func:`interleaved_medians` runner.

Counterpart of ``quant_gemm_tpu/harness/benchmark.py``.  Method
(:class:`DeviceTimer`): the card first spins (``torch.cuda._sleep``) for
twice the host's time to enqueue every rep (L2 flush, event, launch,
event), at least 25 ms, while the host enqueues the reps behind it, so
each pair of CUDA events brackets device work only, never a wait for the
host, also for a chain of many eager ops; before every timed launch a
128 MB buffer is zeroed, so the H100's 50 MB L2 holds none of the
kernel's operands; the result is the median of the reps.

JAX's ``default_chain`` and its two-length loop slope exist to stop XLA
from hoisting a kernel out of a ``fori_loop`` and to cancel a remote
runtime's dispatch latency.  Eager launches bracketed by events have
neither hazard, so the port has neither (``tests/test_torch_parity.py``
lists ``default_chain`` with that reason).

:func:`interleaved_medians` is JAX's algorithm unchanged: interleaved
rounds, a case that raises is dropped, invalid reps are skipped, reps
above :data:`PHYS_MAX_GBPS` are rejected, samples outside 3x of the
median are dropped, extra full rounds run until ``reps`` survive (and for
sub-30 us cases), and a case with no valid sample raises.

:func:`weight_bytes` counts the bytes the port's device layout streams
(``kernels/layout.py``), :func:`prepared_bytes` those a prepared weight
holds.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Sequence

import torch

from ..utils import resolve_device

#: H100 SXM HBM3, NVIDIA's data sheet: 3.35 TB/s
HBM_GBPS = 3350.0
#: anything above this is a measurement artefact, not physics: the data
#: sheet's HBM rate plus 5%
PHYS_MAX_GBPS = HBM_GBPS * 1.05

_FLUSH_BYTES = 128 << 20  # more than twice the H100's 50 MB L2


class DeviceTimer:
    """Median device time of single launches of ``fn`` on one card, L2
    flushed before each (the module docstring's method).  Holds the
    flush buffer: make one per device for many timings."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        if self.device.type != "cuda":
            raise ValueError(f"DeviceTimer times a CUDA device, not "
                             f"{self.device}")
        self.flush = torch.empty(_FLUSH_BYTES, dtype=torch.uint8,
                                 device=self.device)

    def __call__(self, fn: Callable, reps: int = 25, warmup: int = 3) -> float:
        """Median milliseconds of ``fn()``."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        fn()  # one enqueue on the host clock: a chain of eager ops is long
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize(self.device)
        # spin for twice the enqueue of every rep, and at least 25 ms, at
        # the H100's clock of about 2e9 cycles a second
        torch.cuda._sleep(int(max(50e6, 2 * reps * (host_s + 20e-6) * 2e9)))
        marks = []
        for _ in range(reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            marks.append((a, b))
        torch.cuda.synchronize(self.device)
        return statistics.median(a.elapsed_time(b) for a, b in marks)


@dataclasses.dataclass
class BenchResult:
    name: str
    time_s: float
    flops: int = 0
    bytes: int = 0
    # False when the measurement is no time (a zero or negative reading):
    # time_s is then a placeholder that callers must not record
    valid: bool = True
    device: str = ""  # what it ran on: the card's name, or "cpu"

    @property
    def tflops(self) -> float:
        return self.flops / self.time_s / 1e12 if self.flops else 0.0

    @property
    def gbps(self) -> float:
        return self.bytes / self.time_s / 1e9 if self.bytes else 0.0

    def row(self) -> str:
        tag = "" if self.valid else "  INVALID"
        return (
            f"{self.name:<28s} {self.time_s*1e6:10.1f} us"
            f" {self.tflops:9.2f} TFLOPS {self.gbps:9.1f} GB/s{tag}"
        )


def benchmark_kernel(
    kernel: Callable,
    args: Sequence = (),
    *,
    name: str = "kernel",
    flops: int = 0,
    bytes_accessed: int = 0,
    reps: int = 25,
    warmup: int = 3,
    device="cuda",
) -> BenchResult:
    """Median time of ``kernel(*args)``.  On a CUDA device by
    :class:`DeviceTimer` (events, L2 flushed; its flush buffer comes back
    from the caching allocator on later calls); with ``device="cpu"``, on
    the host clock, for the CPU only (never a device number)."""
    dev = resolve_device(device)
    args = tuple(args)
    if dev.type == "cuda":
        ms = DeviceTimer(dev)(lambda: kernel(*args), reps=reps,
                              warmup=warmup)
        t = ms / 1e3
        where = torch.cuda.get_device_name(dev)
    else:
        for _ in range(warmup):
            kernel(*args)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            kernel(*args)
            times.append(time.perf_counter() - t0)
        t = statistics.median(times)
        where = "cpu"
    if t <= 0:
        return BenchResult(name, 1e-9, flops, bytes_accessed, valid=False,
                           device=where)
    return BenchResult(name, t, flops, bytes_accessed, device=where)


def interleaved_medians(
    cases: Sequence,
    *,
    reps: int = 5,
    max_extra_rounds: int = 3,
    min_time_s: float = 30e-6,
    verbose: bool = True,
) -> dict:
    """Robust per-case medians over interleaved rounds.

    ``cases`` is a sequence of ``(name, fn, args, bytes_accessed)``.  Every
    round measures each case once (so drift hits all rows equally):

    * reps whose implied bandwidth exceeds :data:`PHYS_MAX_GBPS` or that
      are not valid are rejected outright;
    * after the base rounds, samples outside 3x of the per-case median are
      dropped, and extra FULL rounds run (up to ``max_extra_rounds``) until
      every case has >= ``reps`` surviving samples;
    * cases whose median lands under ``min_time_s`` get the extra rounds
      too (sub-30 us rows need more samples to stabilize).

    Returns ``{name: median_seconds}``; a case whose kernel raises is
    dropped (and left out of the dict); raises if a case cannot produce
    a single valid sample.
    """
    samples: dict[str, list[float]] = {c[0]: [] for c in cases}
    dead: dict[str, str] = {}

    def run_round(rep: int) -> None:
        for name, fn, args, by in cases:
            if name in dead:
                continue
            try:
                r = benchmark_kernel(fn, args, name=f"{name} #{rep}",
                                     bytes_accessed=by)
            except Exception as e:  # noqa: BLE001 — build/launch failure
                dead[name] = repr(e)
                print(f"  {name}: case DROPPED — {e!r:.300}", flush=True)
                continue
            if verbose:
                print(f"  {r.row()}", flush=True)
            if not r.valid:
                continue
            if by and by / r.time_s / 1e9 > PHYS_MAX_GBPS:
                if verbose:
                    print(f"    ^ rejected: {by / r.time_s / 1e9:.0f} GB/s "
                          f"> {PHYS_MAX_GBPS:.0f} physical cap", flush=True)
                continue
            samples[name].append(r.time_s)

    def surviving(name: str) -> list[float]:
        vals = samples[name]
        if not vals:
            return vals
        med = statistics.median(vals)
        return [v for v in vals if med / 3 <= v <= med * 3]

    rnd = 0
    for rnd in range(reps):
        run_round(rnd)
    for _ in range(max_extra_rounds):
        live = [c for c in cases if c[0] not in dead]
        if not live:
            break
        need_more = any(
            len(surviving(c[0])) < reps
            or statistics.median(surviving(c[0])) < min_time_s
            and len(surviving(c[0])) < reps + max_extra_rounds
            for c in live
            if surviving(c[0])
        ) or any(not samples[c[0]] for c in live)
        if not need_more:
            break
        rnd += 1
        run_round(rnd)

    out = {}
    for name, *_ in cases:
        if name in dead:
            continue
        vals = surviving(name)
        if not vals:
            raise RuntimeError(f"{name}: no valid samples after "
                               f"{rnd + 1} rounds")
        out[name] = statistics.median(vals)
    return out


#: bytes of one 32-weight block as the port's layout streams it
#: (``kernels/layout.py``): codes plus f16 scales for the per-32 GGUF
#: formats (their GGUF block bytes); q4_k / q5_k as effective q4_1 / q5_1
#: with f32 ``d'`` and ``m'`` (6 and 7 bits a weight); iq4_xs as q8_0's
#: int8 codes with an f32 ``d``
_BLOCK_BYTES = {"q4_0": 18, "q4_1": 20, "q5_0": 22, "q5_1": 24,
                "q8_0": 34, "q4_k": 16 + 8, "q5_k": 16 + 4 + 8,
                "iq4_xs": 32 + 4}


def weight_bytes(qtype: str, n: int, k: int) -> int:
    """Device bytes STREAMED per GEMM for an ``n`` x ``k`` weight of
    ``qtype`` in the port's layout (the roofline's weight bytes)."""
    if k % 32:
        raise ValueError(f"K={k} is not a multiple of 32")
    return n * (k // 32) * _BLOCK_BYTES[qtype]


def prepared_bytes(w) -> int:
    """Bytes a ``layout.PreparedWeight`` / ``PreparedK16`` holds on its
    device, padding included."""
    return sum(t.numel() * t.element_size() for t in w
               if isinstance(t, torch.Tensor))


def gemm_flops(m: int, n: int, k: int) -> int:
    return 2 * m * n * k


def print_table(results: Sequence[BenchResult]) -> None:
    print(f"{'kernel':<28s} {'time':>13s} {'compute':>16s} {'memory':>14s}")
    for r in results:
        print(r.row())


__all__ = [
    "BenchResult",
    "DeviceTimer",
    "benchmark_kernel",
    "interleaved_medians",
    "weight_bytes",
    "prepared_bytes",
    "gemm_flops",
    "print_table",
    "HBM_GBPS",
    "PHYS_MAX_GBPS",
]
