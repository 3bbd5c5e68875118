"""The row plan of K9 ``rms_norm_pallas`` and K10 ``softmax_pallas``: how
the rows of a float32 [R, C] matrix map onto the threads, blocks and
thread-block clusters of an H100 (``csrc/rows.cuh``).

A row is ``nv = ceil(C / vec)`` vectors of ``vec`` floats: 4 (16-byte
loads) where the data is 16-byte aligned and ``C % 4 == 0``, else 1.  It
is split over ``cluster`` CTAs of a thread-block cluster, rank ``k``
holding vectors ``[k * span, min(nv, (k + 1) * span))``, and within a
CTA over ``tpr`` threads, thread ``t`` holding vectors ``k * span + t + j
* tpr`` for ``j < per``.  A block holds ``rows`` whole rows (one in a
cluster).  The aims:

* the whole row in registers, at most ``REGS`` floats a thread, so it is
  read once and a thread issues all its loads before its first reduction
  (one DRAM round trip); about ``PER`` floats a thread, so a short row
  still spreads over many threads (the kernel's array holds ``hold``
  floats: 16 where they suffice, as under the aim, else 32);
* a long row (at least ``LONG`` floats) over a cluster of up to
  ``CLUSTER_MAX`` CTAs where the rows alone would leave more than half of
  the ``SMS`` idle (8 x 32000: 8 rows x 8 CTAs), each CTA holding at least
  ``SPAN_MIN`` floats;
* a row that a full cluster's registers cannot hold (``C > 8 * 1024 *
  32``) is streamed: ``per * vec > REGS``, read again for each pass, in
  chunks of ``HOLD_MIN`` floats a thread.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SMS = 132          # the H100's streaming multiprocessors
REGS = 32          # most floats a thread holds (rows.cuh::REGS)
HOLD_MIN = 16      # floats a thread's array holds at least
BLOCK_MAX = 1024   # threads a block
CLUSTER_MAX = 8    # CTAs a cluster (the portable most)
PER = 16           # floats a thread aims to hold
LONG = 8192        # floats of a row worth a cluster
SPAN_MIN = 1024    # fewest floats a CTA of a cluster holds
ROWS_BLOCK = 256   # threads a block of several short rows aims at


class RowPlan(NamedTuple):
    vec: int      # floats a load: 4 or 1
    tpr: int      # threads a row in a CTA: 1-32, a power of two, or k * 32
    rows: int     # rows a block (1 in a cluster)
    cluster: int  # CTAs a row
    span: int     # vectors a CTA holds (the last one of a row fewer)
    per: int      # vectors a thread holds

    @property
    def stream(self) -> bool:
        """Whether the row is too long for registers and is read again."""
        return self.per * self.vec > REGS

    @property
    def hold(self) -> int:
        """Floats of a thread's register array (a chunk when streamed):
        ``rows.cuh::dispatch_vec``'s choice."""
        if self.stream or self.per * self.vec <= HOLD_MIN:
            return HOLD_MIN
        return REGS

    def grid(self, r: int) -> int:
        """Blocks of the launch for ``r`` rows."""
        return r * self.cluster if self.cluster > 1 else -(-r // self.rows)


def _pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def plan(r: int, c: int, aligned: bool = True) -> RowPlan:
    """The plan for ``r`` rows of ``c`` floats; ``aligned``: the data (x,
    and RMSNorm's weight) starts on a 16-byte boundary."""
    if r < 1 or c < 1:
        raise ValueError(f"rows of a [{r}, {c}] matrix")
    vec = 4 if aligned and c % 4 == 0 else 1
    nv = -(-c // vec)
    cap = BLOCK_MAX * (REGS // vec)  # vectors a CTA holds in registers
    cluster = min(CLUSTER_MAX, -(-nv // cap))
    if c >= LONG and r * cluster <= SMS // 2:
        cluster = max(cluster, min(CLUSTER_MAX, SMS // r, c // SPAN_MIN))
    span = -(-nv // cluster)
    want = -(-span // (PER // vec))
    if want <= 32:
        tpr = 1 << (want - 1).bit_length()
    else:
        tpr = min(BLOCK_MAX, -(-want // 32) * 32)
    per = -(-span // tpr)
    rows = 1
    if cluster == 1:
        rows = _pow2_floor(max(32 // tpr,
                               min(ROWS_BLOCK // tpr, r // SMS)))
    return RowPlan(vec, tpr, rows, cluster, span, per)


def _halves(a: torch.Tensor) -> torch.Tensor:
    """The last axis (a power of two long) summed as a tree: first half +
    second half, down to one."""
    while a.shape[-1] > 1:
        h = a.shape[-1] // 2
        a = a[..., :h] + a[..., h:]
    return a[..., 0]


def ordered_sum(v: torch.Tensor, p: RowPlan) -> torch.Tensor:
    """Each row's float32 sum of ``v`` [R, C] in the kernels' order under
    plan ``p``: a thread's ``p.hold`` slots (slot ``vec * j + e`` is
    element ``e`` of its vector ``j``; padding 0) as a tree, its chunks in
    order,
    the row's lanes of a warp as a tree (the xor butterfly gives every
    lane that sum), its warps in order, its CTAs in rank order.  With the
    same float32 values on the card, K9's sum of squares and K10's sum of
    ``exp(x - m)`` equal it bit for bit."""
    r, c = v.shape
    nv = -(-c // p.vec)
    hold = p.hold // p.vec  # vectors a chunk
    chunks = -(-p.per // hold)
    j = torch.arange(chunks * hold, device=v.device)
    k = torch.arange(p.cluster, device=v.device)[:, None, None]
    t = torch.arange(p.tpr, device=v.device)[None, :, None]
    vi = k * p.span + t + j * p.tpr  # [cluster, tpr, J]: the vectors
    held = (j < p.per) & (vi < torch.clamp((k + 1) * p.span, max=nv))
    el = vi[..., None] * p.vec + torch.arange(p.vec, device=v.device)
    vals = torch.where(held[..., None], v[:, el.clamp(max=c - 1)],
                       torch.zeros((), dtype=v.dtype, device=v.device))
    part = _halves(vals.reshape(r, p.cluster, p.tpr, chunks, p.hold))
    acc = part[..., 0]
    for q in range(1, chunks):
        acc = acc + part[..., q]
    if p.tpr <= 32:
        acc = _halves(acc)[..., None]
    else:
        acc = _halves(acc.reshape(r, p.cluster, p.tpr // 32, 32))
    cta = acc[..., 0]  # [R, cluster]: each CTA's warps in order
    for w in range(1, acc.shape[-1]):
        cta = cta + acc[..., w]
    out = cta[:, 0]
    for rank in range(1, p.cluster):
        out = out + cta[:, rank]
    return out


__all__ = ["RowPlan", "plan", "ordered_sum", "SMS", "REGS", "BLOCK_MAX",
           "CLUSTER_MAX"]
