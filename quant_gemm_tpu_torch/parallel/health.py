"""Multi-process health check: an all-reduce heartbeat under a timeout.

Counterpart of ``quant_gemm_tpu/parallel/health.py``: every rank
contributes 1 on its device and the sum must equal the number of ranks; a
wrong sum means an inconsistent group, a timeout a hung or absent rank or
interconnect.  The heartbeat runs in a daemon thread, so a rank that never
joins turns into ``ok=False`` after ``timeout_s`` instead of a stall (the
blocked collective is left to the process group's own timeout).  Call it
on every rank of the group.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..utils import resolve_device
from . import sharding


@dataclasses.dataclass
class HealthReport:
    ok: bool
    n_devices: int
    n_processes: int
    heartbeat_ms: Optional[float]  # None on timeout/failure
    detail: str

    def row(self) -> str:
        hb = f"{self.heartbeat_ms:.1f} ms" if self.heartbeat_ms else "TIMEOUT"
        status = "OK" if self.ok else "FAIL"
        return (f"health: {status}  devices={self.n_devices} "
                f"processes={self.n_processes} heartbeat={hb}  {self.detail}")


def check(timeout_s: float = 30.0, mesh=None, device="cuda") -> HealthReport:
    """The heartbeat over the whole world (each process one device), on
    ``mesh.device`` or ``device``."""
    init = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if init else 1
    dev = mesh.device if mesh is not None else resolve_device(device)
    world = sharding.Mesh({"world": n}, {"world": dist.get_rank() if init
                                         else 0},
                          {"world": dist.group.WORLD if init else None}, dev)
    result: dict = {}

    def beat():
        try:
            one = torch.ones((), dtype=torch.int32, device=dev)
            t0 = time.perf_counter()
            total = int(sharding.all_reduce(one, world, "world"))
            ms = (time.perf_counter() - t0) * 1e3
            if total != n:
                raise RuntimeError(f"heartbeat sum {total} != device count "
                                   f"{n}")
            result["ms"] = ms
        except Exception as e:  # noqa: BLE001 - reported, not raised
            result["error"] = f"{type(e).__name__}: {e}"

    thread = threading.Thread(target=beat, daemon=True)
    thread.start()
    thread.join(timeout_s)
    if thread.is_alive():
        return HealthReport(False, n, n, None, f"heartbeat exceeded "
                            f"{timeout_s}s: hung or absent rank")
    if "error" in result:
        return HealthReport(False, n, n, None, result["error"])
    return HealthReport(True, n, n, result["ms"], "all devices reachable")


__all__ = ["check", "HealthReport"]
