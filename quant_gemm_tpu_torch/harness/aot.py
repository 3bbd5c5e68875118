"""The deviceless compile gate and the overlap report.

Counterpart of ``quant_gemm_tpu/harness/aot.py``.  There, libtpu's
compiler lowers every Pallas kernel for a TPU topology on a host without
a chip, so Mosaic rejects a kernel before any run.  Here ``nvcc`` needs
no card either: :func:`aot_compile` compiles the port's CUDA sources
(``csrc/*.cu``) for ``sm_90a`` with the build's own flags
(``kernels/_build.NVCC_FLAGS``, ``-Xptxas -v`` among them) in a process
that sees no GPU (``CUDA_VISIBLE_DEVICES=""``), into a temporary
directory, and raises with the compiler's output when a source fails.

:func:`resource_report` reads the ``ptxas info`` blocks of such a log
(or of ``_build.BUILD_LOG``, the same text for every library a process
built) into one :class:`Resources` row per entry function: registers,
stack frame, spill stores and loads, static shared memory, constant
memory.  :func:`overlap_report` classifies the collectives of a
``torch.profiler`` window as the JAX one classifies those of a scheduled
HLO module: a ring GEMM's ``ppermute`` is *overlapped* when a chunk GEMM
(or a kernel on the card) ran between its start and its wait.

CLI (where ``nvcc`` exists)::

    python -m quant_gemm_tpu_torch.harness.aot            # every source
    python -m quant_gemm_tpu_torch.harness.aot gemm_exact --log out.txt

JAX's ``topology``, ``topology_available``, ``topology_mesh``,
``shape_structs``, ``compiled_hlo``, ``OVERLAP_OPTS`` and
``DEFAULT_TOPOLOGY`` describe libtpu's deviceless topologies and XLA's
scheduler options; they have no counterpart (``tests/
test_torch_parity.py`` lists them with that reason).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

from ..kernels import _build


def _flags(arch: str) -> tuple:
    """``_build.NVCC_FLAGS`` with its target replaced by ``arch``."""
    out = list(_build.NVCC_FLAGS)
    i = out.index("-gencode")
    out[i + 1] = f"arch=compute_{arch[3:]},code={arch}"
    return tuple(out)


def aot_compile(names=None, arch: str = "sm_90a") -> dict:
    """Compile ``csrc/<name>.cu`` for each name (default: every source)
    for ``arch`` with the build's flags, all at once, in subprocesses
    that see no GPU, into a temporary directory that is removed after.
    Returns ``{"logs": {name: compiler output}, "seconds": wall
    seconds}``; raises ``RuntimeError`` with the output of each source
    that failed (and when no ``nvcc`` is found)."""
    names = _build.source_names() if names is None else list(names)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="qgt-aot-") as tmp:
        logs = _build.compile_sources(
            names, {n: os.path.join(tmp, f"{n}.so") for n in names},
            flags=_flags(arch), env=env)
    return {"logs": logs, "seconds": time.perf_counter() - t0}


@dataclasses.dataclass
class Resources:
    """What ``ptxas`` reports for one entry function."""

    source: str
    name: str  # demangled where c++filt is on PATH
    mangled: str
    registers: int = 0
    stack: int = 0  # bytes of stack frame
    spill_stores: int = 0
    spill_loads: int = 0
    smem: int = 0  # bytes of static shared memory
    cmem: int = 0  # bytes of constant memory, all banks

    def row(self) -> str:
        return (f"{self.source:<17s} {self.registers:4d} regs "
                f"{self.stack:5d} B stack {self.spill_stores:4d}/"
                f"{self.spill_loads:<4d} B spill st/ld {self.smem:6d} B smem "
                f"{self.cmem:5d} B cmem  {self.name[:110]}")


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_CMEM = re.compile(r"(\d+) bytes cmem\[\d+\]")


def _demangle(names: list) -> dict:
    tool = shutil.which("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60)
    plain = out.stdout.splitlines()
    if out.returncode != 0 or len(plain) != len(names):
        return {n: n for n in names}
    return dict(zip(names, plain))


def resource_report(ptxas_log) -> list:
    """:class:`Resources` of every entry function in a ``ptxas -v`` log:
    a string (source ``""``) or ``{source: log}`` as
    ``_build.BUILD_LOG`` and :func:`aot_compile` give it.  Rows in the
    log's order, grouped by source in the mapping's order."""
    logs = ptxas_log if isinstance(ptxas_log, dict) else {"": ptxas_log}
    rows: list = []
    for source, log in logs.items():
        entries: dict = {}
        props = used = None
        for line in log.splitlines():
            m = _ENTRY.search(line)
            if m:
                used = entries.setdefault(
                    m.group(1), Resources(source, m.group(1), m.group(1)))
                continue
            m = _PROPS.search(line)
            if m:
                props = m.group(1)
                continue
            m = _FRAME.search(line)
            if m and props in entries:
                r = entries[props]
                r.stack, r.spill_stores, r.spill_loads = map(int, m.groups())
                continue
            m = _USED.search(line)
            if m and used is not None:
                used.registers = int(m.group(1))
                s = _SMEM.search(line)
                used.smem = int(s.group(1)) if s else 0
                used.cmem = sum(int(c) for c in _CMEM.findall(line))
        rows.extend(entries.values())
    plain = _demangle([r.mangled for r in rows])
    for r in rows:
        r.name = plain[r.mangled]
    return rows


def format_report(rows) -> str:
    """One line per entry function; a line per source ahead of its rows
    (entries, the most registers, the most spill bytes)."""
    lines = []
    by_source: dict = {}
    for r in rows:
        by_source.setdefault(r.source, []).append(r)
    for source, rs in by_source.items():
        lines.append(f"{source or '(log)'}: {len(rs)} entries, registers "
                     f"{min(r.registers for r in rs)}-"
                     f"{max(r.registers for r in rs)}, most spill "
                     f"{max(r.spill_stores for r in rs)}/"
                     f"{max(r.spill_loads for r in rs)} B st/ld, most smem "
                     f"{max(r.smem for r in rs)} B")
        lines.extend("  " + r.row() for r in rs)
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the overlap report
# ---------------------------------------------------------------------------

_START = re.compile(r"^ppermute\.start#(\d+)$")
_WAIT = re.compile(r"^ppermute\.wait#(\d+)$")
#: a ring step's GEMM (``parallel/sharding.py::_ring_gemm``)
RING_GEMM = "ring_gemm"
#: the prefix of a collective run without a handle (``sharding.all_reduce``
#: and the others)
SYNC_PREFIX = "collective."


def _events(prof_or_events) -> list:
    if hasattr(prof_or_events, "events"):
        return list(prof_or_events.events())
    return list(prof_or_events)


def _on_card(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _is_copy(e) -> bool:
    """A copy or fill on the card: a collective's own host copies are no
    compute that hides it."""
    return e.name.lower().startswith(("memcpy", "memset"))


def overlap_report(prof_or_events) -> dict:
    """Classify the collectives of a ``torch.profiler`` window (the
    profile, or its ``events()``), with the keys of JAX's report:

    * ``overlapped``: a ``ppermute`` (ranges ``ppermute.start#t`` ..
      ``ppermute.wait#t``) whose start-to-wait span encloses a
      ``ring_gemm`` range, or in which a kernel (not a copy) began on the
      card after the start returned;
    * ``blocking``: a ``ppermute`` whose span encloses neither;
    * ``sync``: a collective without a handle (a ``collective.*`` range:
      the TP decode step's all-reduces, the all-gathers);
    * ``resynced``: always 0, kept for parity: no scheduler merges a
      started collective back into a synchronous one here;
    * ``hidden_by``: the names of what hid each overlapped ``ppermute``
      (its ring GEMMs and card kernels), in order.

    "Overlapped" reads the code's order: the GEMM was issued between the
    start and the wait.  It does not show that the transfer and the
    compute ran at the same time.
    """
    evs = _events(prof_or_events)
    starts, waits = {}, {}
    gemms, kernels = [], []
    out = {"overlapped": 0, "blocking": 0, "resynced": 0, "sync": 0,
           "hidden_by": []}
    for e in evs:
        if _on_card(e):
            if not _is_copy(e):
                kernels.append(e)
            continue
        m = _START.match(e.name)
        if m:
            starts[m.group(1)] = e
            continue
        m = _WAIT.match(e.name)
        if m:
            waits[m.group(1)] = e
        elif e.name == RING_GEMM:
            gemms.append(e)
        elif e.name.startswith(SYNC_PREFIX):
            out["sync"] += 1
    for tag in sorted(starts, key=int):
        s, w = starts[tag], waits.get(tag)
        if w is None:
            raise ValueError(f"ppermute #{tag} started in the window but "
                             "was not waited for in it")
        lo, hi = s.time_range.start, w.time_range.end
        hid = [g.name for g in gemms
               if g.time_range.start >= lo and g.time_range.end <= hi]
        hid += [k.name for k in kernels
                if s.time_range.end <= k.time_range.start < hi]
        if hid:
            out["overlapped"] += 1
            out["hidden_by"].extend(hid)
        else:
            out["blocking"] += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help="sources (default: all)")
    ap.add_argument("--arch", default="sm_90a")
    ap.add_argument("--log", help="write the compiler's output here too")
    args = ap.parse_args(argv)
    res = aot_compile(args.names or None, args.arch)
    if args.log:
        with open(args.log, "w") as f:
            for n, log in res["logs"].items():
                f.write(f"=== {n}.cu ===\n{log}\n")
    print(format_report(resource_report(res["logs"])))
    print(f"compiled {len(res['logs'])} sources for {args.arch} in "
          f"{res['seconds']:.1f} s")
    return 0


__all__ = ["aot_compile", "resource_report", "format_report", "Resources",
           "overlap_report", "RING_GEMM", "SYNC_PREFIX"]


if __name__ == "__main__":
    sys.exit(main())
