"""Multi-process bootstrap: joining the group, the global mesh, per-process
data.

Counterpart of ``quant_gemm_tpu/parallel/multihost.py`` over
``torch.distributed``, one process per device:

* :func:`initialize` joins the process group with an explicit backend:
  NCCL when each rank has a GPU of its own (``local_device_ids``), gloo
  on a machine without CUDA, and otherwise the caller's choice (ranks
  sharing a GPU need gloo: NCCL refuses two ranks on one device);
* :func:`global_mesh` is the mesh over every process, its first axis the
  outermost (spanning hosts when a host runs consecutive ranks);
* :func:`host_array` takes the rows this process loaded and returns them
  as the rank's shard on its device; :func:`replicated` makes a value the
  same on every rank (rank 0's).
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import sharding


def initialize(coordinator_address: str, num_processes: int,
               process_id: int,
               local_device_ids: Optional[Sequence[int]] = None,
               backend: Optional[str] = None,
               timeout_s: float = 300.0) -> None:
    """Join the process group (once per process; a second call returns).

    ``coordinator_address``: ``host:port`` (TCP) or an init URL
    (``tcp://...``, ``file://...``).  With ``local_device_ids`` the rank
    takes the first as its CUDA device."""
    if dist.is_initialized():
        return
    if backend is None:
        if not torch.cuda.is_available():
            backend = "gloo"
        elif local_device_ids:
            backend = "nccl"
        else:
            raise ValueError(
                "CUDA is available but no local_device_ids were given: pass "
                "backend='nccl' (one GPU per rank) or 'gloo' (ranks sharing "
                "a GPU)")
    if local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def global_mesh(axis_sizes: dict, device="cuda") -> sharding.Mesh:
    """The mesh over every process (``sharding.make_mesh``): the first
    axis outermost, so ``global_mesh({"dp": hosts, "tp": per_host})`` with
    consecutive ranks on a host keeps tp within hosts."""
    return sharding.make_mesh(axis_sizes, device)


def host_array(mesh: sharding.Mesh, local_data) -> torch.Tensor:
    """The rows this process loaded (its shard of a batch split over an
    axis, or a whole replicated value), on the rank's device."""
    return torch.as_tensor(np.asarray(local_data), device=mesh.device)


def replicated(mesh: sharding.Mesh, value) -> torch.Tensor:
    """``value`` on the rank's device, rank 0's on every rank."""
    t = torch.as_tensor(np.asarray(value), device=mesh.device).contiguous()
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.broadcast(t, 0)
    return t


__all__ = ["initialize", "global_mesh", "host_array", "replicated"]
