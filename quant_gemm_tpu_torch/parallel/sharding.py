"""Tensor and data parallelism for packed quantized weights over
``torch.distributed``.

Counterpart of ``quant_gemm_tpu/parallel/sharding.py``.  JAX runs one
program over a mesh of devices and keeps a sharded weight as one global
``[tp, ...]`` array; here each device is a process, a :class:`Mesh` names
its axes over the processes (each axis with its process group), and every
rank holds only its own chunk of a weight:

* :func:`shard_weight` splits a block container (``formats.blocks``, the
  port's torch tensors) as JAX's ``_split_container`` does (``sharding.py:
  55-100``): out-features (``mode="col"``) by slicing every field's rows,
  K (``mode="row"``) in natural K order (the planar nibble split is row
  global: codes unpacked, sliced and packed again per chunk), and lays out
  this rank's chunk (``layout.prepare``) on the mesh's device;
* :func:`gemm_col_parallel` (K4 on the rank's rows, optionally
  all-gathered) and :func:`gemm_row_parallel` (K4 on the rank's K slice,
  then an all-reduce, or a reduce-scatter on N);
* :func:`shard_weight_ring`, :func:`gemm_col_parallel_ring` and
  :func:`gemm_row_parallel_ring`: JAX's ring schedule (``sharding.py:
  325-432``) with ``ppermute`` as ``batch_isend_irecv`` to the left
  neighbour, started before a step's chunk GEMM and waited for after it
  (:func:`ppermute_start`), so the rotation runs under the GEMM;
  quantized chunks take K1 (``gemm_exact``) and float chunks K4
  (``gemm_dequant``), as ``_ring_gemm`` picks;
* :func:`quantize_q8_1_sharded`: each rank quantizes its rows (bit-equal
  to the whole quantize: the blocks are row-local);
* Megatron's autograd pair for tp training (:func:`copy_to`,
  :func:`reduce_from`), :func:`gather_from`, and :func:`megatron_chunk`,
  a float weight's chunk by its role (training and ``llama_tp``).

The collectives (:func:`all_reduce`, :func:`all_gather`,
:func:`reduce_scatter`, :func:`ppermute`) run on the tensors' device with
the group's backend.  Gloo runs all-reduce, broadcast, all-gather and
reduce-scatter on CUDA tensors itself (copying through the host inside);
its point-to-point does not, so :func:`ppermute` takes an explicit copy to
the host and back on a gloo group, counted in :data:`HOST_COPIES`.  Each
collective is a span of :mod:`..tracing`, so a ``torch.profiler`` range
(``collective.<name>``; ``ppermute.start#t`` / ``ppermute.wait#t`` and
``ring_gemm`` for the rings), which ``harness/aot.py::overlap_report``
classifies.  Nothing else
changes a backend or a device: several ranks sharing one GPU run gloo
(NCCL refuses two ranks on one device), one GPU per rank runs NCCL.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import tracing
from ..formats.blocks import QK, Q8_1Tensor
from ..formats.quant import codes, pack_planar_4bit, pack_planar_bits
from ..kernels import layout, registry
from ..utils import resolve_device

#: collectives that went through the host on a gloo group, by name (gloo
#: runs all-reduce, broadcast, all-gather and reduce-scatter on CUDA
#: tensors itself; its point-to-point hands the CUDA pointer to its TCP
#: transport, which fails with "writev: Bad address", torch 2.11)
HOST_COPIES: collections.Counter = collections.Counter()


@dataclasses.dataclass
class Mesh:
    """Named axes over the processes: ``shape`` {axis: size}, this rank's
    ``coords`` {axis: index}, ``groups`` {axis: process group of the
    ranks that differ from this one only on that axis} (None in a
    one-process world), and the rank's ``device``."""

    shape: dict
    coords: dict
    groups: dict
    device: torch.device

    def index(self, axis: str) -> int:
        return self.coords[axis]


def make_mesh(axis_sizes: dict, device="cuda") -> Mesh:
    """A mesh over every process of the initialized ``torch.distributed``
    world (or over the one process when it is not), e.g. ``make_mesh(
    {"dp": 2, "tp": 2})``: rank r sits at the row-major coordinates of r,
    the first axis outermost.  Collective: every rank calls it, in the
    same order as its other ``new_group`` calls."""
    names = tuple(axis_sizes)
    sizes = tuple(int(s) for s in axis_sizes.values())
    init = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if init else 1
    rank = dist.get_rank() if init else 0
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {dict(axis_sizes)} needs {int(np.prod(sizes))}"
                         f" processes, the world has {world}")
    grid = np.arange(world).reshape(sizes)
    coords = dict(zip(names, (int(c) for c in np.unravel_index(rank, sizes))))
    groups = {}
    for ax, name in enumerate(names):
        groups[name] = None
        if not init:
            continue
        lines = np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax])
        for ranks in lines:  # every rank creates every group, in order
            g = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                groups[name] = g
    return Mesh(dict(zip(names, sizes)), coords, groups,
                resolve_device(device))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _trivial(mesh: Mesh, axis: str) -> bool:
    return mesh.shape[axis] == 1 or mesh.groups[axis] is None


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``mesh[axis]``, in place: ``x`` is
    overwritten and returned (pass a copy to keep it)."""
    if not _trivial(mesh, axis):
        with tracing.span("collective.all_reduce"):
            dist.all_reduce(x.detach(), group=mesh.groups[axis])
    return x


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` over ``mesh[axis]`` concatenated on ``dim`` in
    axis order."""
    if _trivial(mesh, axis):
        return x.detach().clone()
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    with tracing.span("collective.all_gather"):
        dist.all_gather(parts, x, group=mesh.groups[axis])
    return torch.cat(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str,
                   dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over ``mesh[axis]``, split on ``dim`` into as many
    chunks as the axis has ranks: this rank's chunk."""
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"{n} ways")
    if _trivial(mesh, axis):
        return x.detach().clone()
    src = x.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    with tracing.span("collective.reduce_scatter"):
        dist.reduce_scatter_tensor(out, src, group=mesh.groups[axis])
    return out.movedim(0, dim)


class Permute:
    """A started :func:`ppermute_start`: :meth:`wait` gives what the right
    neighbour sent, on the device of what this rank sent."""

    def __init__(self, x, reqs=(), outs=(), devs=(), keep=(), tag=None):
        self._x = x  # the result itself on a one-rank axis
        self._reqs, self._outs, self._devs = reqs, outs, devs
        self._keep = keep  # the send buffers, alive until the wait
        self.tag = tag

    def wait(self):
        if self.tag is None:
            return self._x
        with tracing.span(f"ppermute.wait#{self.tag}"):
            for r in self._reqs:
                r.wait()
            outs = [o.to(d) for o, d in zip(self._outs, self._devs)]
        self._keep = ()
        if hasattr(self._x, "_fields"):
            return type(self._x)(*outs)
        return outs[0]


_TAGS = itertools.count()


def ppermute_start(x, mesh: Mesh, axis: str) -> Permute:
    """Start sending ``x`` (a tensor or a block container of tensors) to
    the left neighbour on ``mesh[axis]`` and receiving the right one's
    (JAX ``ppermute`` with ``perm = [(i, (i - 1) % n)]``) and return at
    once: work queued before :meth:`Permute.wait` runs under the
    transfer.  On a gloo group a CUDA tensor is copied to the host here
    (which waits for the work that wrote it) and back in the wait.  The
    start and the wait are ``torch.profiler`` ranges ``ppermute.start#t``
    and ``ppermute.wait#t`` of one tag t (:func:`harness.aot.
    overlap_report` reads them)."""
    n = mesh.shape[axis]
    if _trivial(mesh, axis):
        return Permute(x)
    tag = next(_TAGS)
    with tracing.span(f"ppermute.start#{tag}"):
        group = mesh.groups[axis]
        idx = mesh.index(axis)
        left = dist.get_global_rank(group, (idx - 1) % n)
        right = dist.get_global_rank(group, (idx + 1) % n)
        gloo = dist.get_backend(group) == "gloo"
        fields = tuple(x) if hasattr(x, "_fields") else (x,)
        ops, srcs, outs, devs = [], [], [], []
        for f in fields:
            src = f.detach().contiguous()
            devs.append(src.device)
            if src.is_cuda and gloo:
                HOST_COPIES["ppermute"] += 1
                src = src.cpu()
            out = torch.empty_like(src)
            ops += [dist.P2POp(dist.isend, src, left, group),
                    dist.P2POp(dist.irecv, out, right, group)]
            srcs.append(src)
            outs.append(out)
        reqs = dist.batch_isend_irecv(ops)
    return Permute(x, reqs, outs, devs, srcs, tag)


def ppermute(x, mesh: Mesh, axis: str):
    """Each rank's ``x`` (a tensor or a block container of tensors) to its
    left neighbour on ``mesh[axis]`` (JAX ``ppermute`` with ``perm = [(i,
    (i - 1) % n)]``): returns the right neighbour's.  Blocking:
    :func:`ppermute_start` and its wait."""
    return ppermute_start(x, mesh, axis).wait()


class _CopyTo(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's ``g``: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mark_dirty(x)  # summed in place: x is a fresh linear output
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    """All-gather on ``dim`` forward, this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        n, idx = ctx.mesh.shape[ctx.axis], ctx.mesh.index(ctx.axis)
        return g.chunk(n, dim=ctx.dim)[idx].contiguous(), None, None, None


def copy_to(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The input of column-parallel linears: ``x`` forward, its gradient
    summed over ``mesh[axis]`` backward."""
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The output of row-parallel linears: summed over ``mesh[axis]``
    forward (in place), the gradient as it is backward."""
    return _ReduceFrom.apply(x, mesh, axis)


def gather_from(x: torch.Tensor, mesh: Mesh, axis: str,
                dim: int = -1) -> torch.Tensor:
    """Column-parallel outputs gathered on ``dim`` forward, the rank's
    slice of the gradient backward."""
    return _GatherFrom.apply(x, mesh, axis, dim % x.dim())


# ---------------------------------------------------------------------------
# sharded weights
# ---------------------------------------------------------------------------


def megatron_chunk(x: torch.Tensor, role: str, mesh: Mesh,
                   axis: str = "tp") -> torch.Tensor:
    """This rank's chunk of a float weight by its Megatron role
    (``train.param_shardings``): ``"col"`` its out-feature rows (a vector
    its entries), ``"row"`` its K columns, ``"rep"`` the whole."""
    if role == "rep":
        return x
    tp, dim = mesh.shape[axis], 0 if role == "col" else 1
    if x.shape[dim] % tp:
        raise ValueError(f"a {role}-parallel weight of shape "
                         f"{tuple(x.shape)} does not split {tp} ways")
    return x.chunk(tp, dim=dim)[mesh.index(axis)]



def _split_container(w_q, axis_n: bool, parts: int) -> list:
    """A row-major block container split into ``parts`` containers: on N
    every field's rows, on K in natural K order (codes unpacked, sliced,
    packed again per chunk; the scalars' block columns sliced)."""
    fields = w_q._asdict()
    n = next(iter(fields.values())).shape[0]
    if axis_n:
        if n % parts:
            raise ValueError(f"N={n} does not split {parts} ways")
        size = n // parts
        return [type(w_q)(**{f: v[i * size:(i + 1) * size]
                             for f, v in fields.items()})
                for i in range(parts)]
    c = codes(w_q)
    k = c.shape[1]
    if k % (parts * QK):
        raise ValueError(f"K={k} does not split {parts} ways into whole "
                         f"{QK}-blocks")
    kl, nb = k // parts, k // parts // QK
    bits = w_q.spec.bits
    outs = []
    for i in range(parts):
        ci = c[:, i * kl:(i + 1) * kl]
        out = {f: v[:, i * nb:(i + 1) * nb] for f, v in fields.items()
               if f in ("d", "m", "s")}
        if bits == 8:
            out["qs"] = ci.to(torch.int8)
        else:
            out["packed"] = pack_planar_4bit(ci & 0xF)
            if bits == 5:
                out["qh"] = pack_planar_bits((ci >> 4) & 1)
        outs.append(type(w_q)(**out))
    return outs


def _shape(w_q) -> tuple:
    if hasattr(w_q, "qs"):
        return tuple(w_q.qs.shape)
    n, half = w_q.packed.shape
    return n, 2 * half


def _prepare(w_q, dev) -> layout.PreparedWeight:
    return layout.prepare(type(w_q)(*(t.to(dev) for t in w_q)))


@dataclasses.dataclass
class ShardedWeight:
    """This rank's share of a weight of global ``n`` x ``k``: ``local``
    (``mode`` "col": its N rows, "row": its K columns), or for the ring
    modes ("col_ring", "row_ring") ``chunks``, ``tp`` prepared chunks (of
    K for col_ring, of N for row_ring)."""

    qtype: str
    n: int
    k: int
    mode: str
    axis: str
    local: Optional[layout.PreparedWeight] = None
    chunks: Optional[list] = None


def shard_weight(w_q, mesh: Mesh, axis: str = "tp",
                 mode: str = "col") -> ShardedWeight:
    """This rank's chunk of a block container over ``mesh[axis]``:
    ``mode="col"`` splits out-features (N), ``mode="row"`` the reduction
    (K); laid out on the mesh's device."""
    n, k = _shape(w_q)
    parts = _split_container(w_q, mode == "col", mesh.shape[axis])
    return ShardedWeight(w_q.spec.name, n, k, mode, axis,
                         local=_prepare(parts[mesh.index(axis)],
                                        mesh.device))


def shard_weight_ring(w_q, mesh: Mesh, axis: str = "tp",
                      mode: str = "col") -> ShardedWeight:
    """This rank's share for the ring GEMMs: ``mode="col"``, its N rows
    split again into ``tp`` K-chunks; ``mode="row"``, its K columns split
    into ``tp`` N-chunks.  K must split into ``tp * 32`` and N into
    ``tp``, as JAX asserts."""
    tp = mesh.shape[axis]
    n, k = _shape(w_q)
    if k % (tp * QK) or n % tp:
        raise ValueError(f"ring sharding needs K % {tp * QK} == 0 and N % "
                         f"{tp} == 0, got N={n}, K={k}")
    mine = _split_container(w_q, mode == "col", tp)[mesh.index(axis)]
    chunks = [_prepare(c, mesh.device)
              for c in _split_container(mine, mode != "col", tp)]
    return ShardedWeight(w_q.spec.name, n, k, mode + "_ring", axis,
                         chunks=chunks)


def _k4(w, act, a_dtype, ops: registry.Ops):
    """JAX ``gemm_pallas.gemm`` on the port: K4 on a float activation in
    ``a_dtype`` (bf16 by default), a Q8_1 one folded to it."""
    dt = a_dtype or torch.bfloat16
    if isinstance(act, Q8_1Tensor):
        return ops.gemm_dequant(w, registry.fold_q8_1(act, dt))
    return ops.gemm_dequant(w, act.to(dt))


def _cols(act, k0: int, k1: int):
    """Columns [k0, k1) of a float or Q8_1 activation."""
    if isinstance(act, Q8_1Tensor):
        return Q8_1Tensor(act.qs[:, k0:k1], act.d[:, k0 // QK:k1 // QK],
                          act.s[:, k0 // QK:k1 // QK])
    return act[:, k0:k1]


def _k_of(act) -> int:
    return (act.qs if isinstance(act, Q8_1Tensor) else act).shape[1]


def _local_k(sw: ShardedWeight, act, mesh: Mesh):
    """The rank's K slice of ``act``: [M, K] sliced, or [M, K/tp] as
    given."""
    tp, idx = mesh.shape[sw.axis], mesh.index(sw.axis)
    kl = sw.k // tp
    if _k_of(act) == kl:
        return act
    if _k_of(act) != sw.k:
        raise ValueError(f"activation K={_k_of(act)} is neither K={sw.k} "
                         f"nor the rank's {kl}")
    return _cols(act, idx * kl, (idx + 1) * kl)


def gemm_col_parallel(sw: ShardedWeight, act, mesh: Mesh, *,
                      gather_output: bool = False, a_dtype=None,
                      ops: registry.Ops = registry.KERNELS) -> torch.Tensor:
    """This rank's [M, N/tp] of ``act @ W^T`` (activations replicated,
    float or Q8_1), or the gathered [M, N] with ``gather_output``."""
    if sw.mode != "col":
        raise ValueError(f"gemm_col_parallel takes a 'col' weight, not "
                         f"{sw.mode!r}")
    out = _k4(sw.local, act, a_dtype, ops)
    return all_gather(out, mesh, sw.axis, dim=1) if gather_output else out


def gemm_row_parallel(sw: ShardedWeight, act, mesh: Mesh, *,
                      scatter_output: bool = False, a_dtype=None,
                      ops: registry.Ops = registry.KERNELS) -> torch.Tensor:
    """``act @ W^T`` summed over the K shards: [M, N] (all-reduce), or
    this rank's [M, N/tp] with ``scatter_output`` (reduce-scatter).
    ``act``: [M, K] (sliced here) or the rank's [M, K/tp]."""
    if sw.mode != "row":
        raise ValueError(f"gemm_row_parallel takes a 'row' weight, not "
                         f"{sw.mode!r}")
    part = _k4(sw.local, _local_k(sw, act, mesh), a_dtype, ops)
    if scatter_output:
        return reduce_scatter(part, mesh, sw.axis, dim=1)
    return all_reduce(part, mesh, sw.axis)


def _ring_gemm(w, chunk, quantized: bool, a_dtype, ops: registry.Ops):
    """One ring step's GEMM, the ``torch.profiler`` range ``ring_gemm``."""
    with tracing.span("ring_gemm"):
        if quantized:
            return ops.gemm_exact(w, chunk)
        return _k4(w, chunk, a_dtype, ops)


def gemm_col_parallel_ring(sw: ShardedWeight, act, mesh: Mesh, *,
                           quantize_act: bool = True,
                           gather_output: bool = False, a_dtype=None,
                           ops: registry.Ops = registry.KERNELS,
                           overlap: bool = True):
    """Column-parallel GEMM with the activation all-gather as a ring:
    the rank quantizes its K-chunk of ``act`` to Q8_1 once (with
    ``quantize_act``), then at step s multiplies the chunk it holds (that
    of rank ``idx + s``) by its weight's matching K-chunk while the chunk
    passes to the left: the rotation starts before the step's GEMM and is
    waited for after it, so the transfer runs under the GEMM (JAX's
    ``collective-permute-start`` / ``-done`` around the chunk GEMM).
    ``overlap=False`` is the blocking schedule this one replaces (the
    rotation after the GEMM), with the same sums: the yardstick of the
    overlap.  Returns the rank's [M, N/tp] (the gathered [M, N] with
    ``gather_output``)."""
    if sw.mode != "col_ring":
        raise ValueError(f"takes a 'col_ring' weight, not {sw.mode!r}")
    tp, idx = mesh.shape[sw.axis], mesh.index(sw.axis)
    chunk = _local_k(sw, act, mesh)
    if quantize_act:
        chunk = registry.quantize(chunk.to(torch.float32), ops)
    acc = None
    for s in range(tp):
        last = s == tp - 1
        rot = ppermute_start(chunk, mesh, sw.axis) \
            if overlap and not last else None
        part = _ring_gemm(sw.chunks[(idx + s) % tp], chunk, quantize_act,
                          a_dtype, ops)
        acc = part if acc is None else acc + part
        if not last:
            chunk = rot.wait() if overlap else ppermute(chunk, mesh, sw.axis)
    return all_gather(acc, mesh, sw.axis, dim=1) if gather_output else acc


def gemm_row_parallel_ring(sw: ShardedWeight, act, mesh: Mesh, *,
                           quantize_act: bool = True, a_dtype=None,
                           ops: registry.Ops = registry.KERNELS,
                           overlap: bool = True):
    """Row-parallel GEMM with the reduce-scatter as a ring: at step s the
    rank adds its partial for output chunk ``(idx + s + 1) % tp`` to the
    accumulator from its right neighbour and passes it on; after ``tp``
    steps it holds its own chunk summed.  The rotation of step s's sum
    starts as soon as it is summed, and step s + 1's partial GEMM runs
    before the wait, under the transfer; the sums keep the blocking
    form's order (received + partial).  ``overlap=False`` waits for each
    rotation before the next GEMM: the blocking schedule, the same sums.
    Returns the rank's [M, N/tp]."""
    if sw.mode != "row_ring":
        raise ValueError(f"takes a 'row_ring' weight, not {sw.mode!r}")
    tp, idx = mesh.shape[sw.axis], mesh.index(sw.axis)
    aq = _local_k(sw, act, mesh)
    if quantize_act:
        aq = registry.quantize(aq.to(torch.float32), ops)
    acc = rot = None
    for s in range(tp):
        part = _ring_gemm(sw.chunks[(idx + s + 1) % tp], aq, quantize_act,
                          a_dtype, ops)
        if rot is not None:
            acc = rot.wait()
        acc = part if acc is None else acc + part
        if s < tp - 1:
            if overlap:
                rot = ppermute_start(acc, mesh, sw.axis)
            else:
                acc = ppermute(acc, mesh, sw.axis)
    return acc


def quantize_q8_1_sharded(x: torch.Tensor, mesh: Mesh,
                          axis: str = "dp",
                          ops: registry.Ops = registry.KERNELS) -> Q8_1Tensor:
    """Q8_1 of this rank's rows of ``x`` [M, K] (M split over
    ``mesh[axis]``): no communication, the blocks being row-local."""
    n, idx = mesh.shape[axis], mesh.index(axis)
    if x.shape[0] % n:
        raise ValueError(f"M={x.shape[0]} does not split {n} ways")
    rows = x.shape[0] // n
    local = x[idx * rows:(idx + 1) * rows].to(mesh.device, torch.float32)
    return registry.quantize(local, ops)


__all__ = ["Mesh", "make_mesh", "HOST_COPIES", "all_reduce",
           "all_gather", "reduce_scatter", "ppermute", "ppermute_start",
           "Permute", "copy_to", "reduce_from", "gather_from",
           "megatron_chunk", "ShardedWeight", "shard_weight",
           "shard_weight_ring", "gemm_col_parallel", "gemm_row_parallel",
           "gemm_col_parallel_ring", "gemm_row_parallel_ring",
           "quantize_q8_1_sharded"]
