"""K3 flash-decode and K5 flash-prefill attention over the KV cache.

Replace the Pallas kernels ``quant_gemm_tpu/ops/attention.py::
flash_decode`` and ``::flash_prefill``: bf16, or int8 codes with one
float32 scale per (layer, slot, head, token) vector (the ``q8`` cache);
full causal or a sliding ``window``; a linear cache (slot = position) or,
with ``ring=R``, a ring of R slots holding token g at slot ``g % R``
(needs ``0 < window <= R``; only the first R slots are attended).

* :func:`flash_decode`: one query token per slot, ``q`` [B, KV, rep, hd];
  slot ``b`` attends cache slots ``< pos[b]`` when the current token's
  ``k_current``/``v_current`` (bf16, with either cache) ride along, folded
  in last, ``<= pos[b]`` otherwise; under a window only slots
  ``> pos[b] - window``.  The valid range is clamped to the cache, so a
  stale ``pos`` of an inactive slot stays in bounds.
* :func:`flash_prefill`: ``q`` [B, KV, T*rep, hd] in T-major rows (row
  ``t*rep + r`` is token ``t`` of group member ``r``); the row of token
  ``t`` sits at ``pos0[b] + t`` and attends slots up to it (and, under a
  window, after ``pos0[b] + t - window``); the cache already holds the
  chunk's own rows.

On the ring (``attention.py:87-95, 116-118`` and ``:394-401, 422-425``):
decode masks slot r by its age ``(p_new - r) mod R < cnt``, where
``p_new`` is the newest cached token (``pos - 1`` with the current token
as operands, ``pos`` without) and ``cnt = min(window - 1, pos)`` (``min(
window, pos + 1)``) the cached tokens the window holds; prefill masks by
the global position a slot holds, ``g = p_cache - (p_cache - r) mod R``
with ``p_cache = pos0 + T - 1``, and needs ``window + T <= R``.  The
kernels walk only the window's one or two slot ranges.

Both take the cache as ``[L, B, KV, S, hd]`` with ``layer=`` (no per-layer
copy) or as ``[B, KV, S, hd]``; the int8 cache's ``k_scale``/``v_scale``
have the cache's shape without ``hd``.  The kernels read one layer's view
through its base pointer and slot stride, so a one-slot view of a larger
cache (the server's prefill) is read in place; each slot's [KV, S, hd]
block must be contiguous.  Int8: the k scale multiplies the scores before
the mask, the softmax sum takes p unscaled and the p.V sum ``p * v_scale``
(``attention.py:109-138, 416-445``).

K3's bound on an H100: bytes (the valid K and V rows, with int8 their
scales, read once; q and the output).  ``csrc/flash_decode.cu`` stages
raw K/V tiles (bf16, or the int8 codes and their scales) with
``cp.async`` in a three-stage ring and runs QK^T and PV on the tensor
cores as K5 does (hi + lo bf16 q and p; int8 codes turned to bf16
exactly in registers), the online softmax in float32.  Each slot's
interval is cut into pieces along its logical order
(:func:`decode_pieces` picks their number from host-known sizes and the
caller's bound ``s_hi``, :func:`decode_piece_bounds` mirrors the
kernel's cut); with one piece the kernel writes the output in one
launch, with more the merge kernel K5 uses combines them in piece order
and folds the current token last.  No position is read on the host.

K5 (``csrc/flash_prefill.cu``): QK^T and PV on the tensor cores
(``mma.sync`` bf16, float32 accumulation), the online softmax in float32.
K and V are exact in bf16 (int8 codes convert exactly); the pre-scaled q
and the probabilities enter as hi + lo bf16 pairs, two MMAs each, so the
products match float32 to about 2^-16 relative.  Its bound at the
Mistral-7B ring chunk (T 128, hd 128, window 4096) is operations,
0.0087 ms of bf16 tensor-core work (bytes at short contexts).  So that
the grid fills the card, the slot interval each (slot, kv head, 64-row
tile) walks is cut into pieces (:func:`prefill_pieces` picks their
number from host-known sizes, :func:`prefill_piece_bounds` mirrors the
kernel's cut); each piece writes its (max, sum, unnormalised output)
and the merge kernel (``csrc/attention.cuh::attn_merge_kernel``, shared
with K3) combines them in piece order, so every call gives the same
bits.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (``*_plain``, dense masked softmax in float32, the query scaled
first as the JAX kernels scale it) for CPU tensors; ``<wrapper>.launches``
counts kernel launches.  :func:`flash_decode_ref` is the counterpart of
the JAX ``flash_decode_ref``.
"""

from __future__ import annotations

import math

import torch

from ..kernels import _build

NEG_INF = float(torch.finfo(torch.float32).min)

#: K5's query rows per block and cache rows per tile (``ROWS``, ``KT`` of
#: ``csrc/flash_prefill.cu``), and the H100's SMs
PREFILL_ROWS, PREFILL_TILE, SMS = 64, 64, 132
#: K3's query rows per block and cache rows per tile (``QR``, ``KT`` of
#: ``csrc/flash_decode.cu``), its blocks resident on one SM (registers
#: hold it to two), and the fewest slots worth a piece of their own: below
#: about 512 a piece's bytes take less time than the merge's second launch
DECODE_ROWS, DECODE_TILE, DECODE_PER_SM, DECODE_MIN_PIECE = 16, 64, 2, 512


def decode_span(window: int, slots: int, s_hi=None) -> int:
    """The longest interval a decode query can walk: the cache's (or the
    ring's) ``slots``, at most ``window`` under a window, and below
    ``s_hi`` when the caller promises every position is below it."""
    span = min(slots, window) if window else slots
    return span if s_hi is None else max(1, min(span, int(s_hi)))


def decode_pieces(b: int, kv: int, rep: int, window: int, slots: int,
                  s_hi=None) -> int:
    """How many pieces K3 cuts each (slot, kv head)'s interval into, from
    host-known sizes only (never ``pos``): at least two blocks per SM,
    then as many as still fill the last wave of ``DECODE_PER_SM`` blocks
    per SM (a part-filled second wave costs nearly a whole one), at most
    one per ``DECODE_MIN_PIECE`` slots of the longest interval
    (:func:`decode_span`), so a short context stays one launch, and no
    piece empty there."""
    blocks = b * kv * -(-rep // DECODE_ROWS)
    span = decode_span(window, slots, s_hi)
    tiles = -(-span // DECODE_TILE)
    ns = -(-2 * SMS // blocks)
    wave = DECODE_PER_SM * SMS
    ns = max(ns, -(-blocks * ns // wave) * wave // blocks)
    ns = max(1, min(ns, span // DECODE_MIN_PIECE))
    return -(-tiles // -(-tiles // ns))  # none empty at `span`


def decode_max_pieces(window: int, slots: int, s_hi=None) -> int:
    """The widest cut K3 takes: one tile a piece at the longest
    interval."""
    return -(-decode_span(window, slots, s_hi) // DECODE_TILE)


def decode_piece_bounds(length: int, ns: int) -> list:
    """The kernel's cut of an interval of ``length`` cache slots (oldest
    first) into ``ns`` pieces: ``[u0, u1)`` each, whole tiles of
    ``DECODE_TILE`` slots, ``ceil(tiles / ns)`` tiles a piece; pieces past
    the interval are empty."""
    tiles = -(-length // DECODE_TILE)
    per = -(-tiles // ns)
    return [(min(length, p * per * DECODE_TILE),
             min(length, (p + 1) * per * DECODE_TILE)) for p in range(ns)]


def decode_s_hi(max_ctx: int):
    """The static bound the Server passes with a decode step whose
    longest slot is at ``max_ctx`` cached tokens (capped by the window):
    the ``s_hi`` half of the JAX ``decode_ts_bucket``, 256 below 256, 512
    below 512, else None.  (Its ``ts`` half is the TPU's tile size.)"""
    if max_ctx < 256:
        return 256
    if max_ctx < 512:
        return 512
    return None


def prefill_pieces(b: int, kv: int, rows: int, rep: int, window: int,
                   slots: int) -> int:
    """How many pieces K5 cuts each block's slot interval into: enough
    for about two blocks per SM, at most one tile each at the longest
    interval a 64-row tile can walk (``slots`` cache slots, or the ring's;
    with a window, ``window`` + its tokens - 1), and no piece empty
    there."""
    blocks = b * kv * -(-rows // PREFILL_ROWS)
    tokens = min(rows // rep, (PREFILL_ROWS - 1) // rep + 2)
    span = min(slots, window + tokens - 1) if window else slots
    tiles = -(-span // PREFILL_TILE)
    ns = max(1, min(-(-2 * SMS // blocks), tiles))
    return -(-tiles // -(-tiles // ns))  # none empty at `span`


def prefill_piece_bounds(length: int, ns: int) -> list:
    """The kernel's cut of a slot interval of ``length`` slots into ``ns``
    pieces: ``[u0, u1)`` each, whole tiles of ``PREFILL_TILE`` slots,
    ``ceil(tiles / ns)`` tiles a piece; pieces past the interval are
    empty."""
    tiles = -(-length // PREFILL_TILE)
    per = -(-tiles // ns)
    return [(min(length, p * per * PREFILL_TILE),
             min(length, (p + 1) * per * PREFILL_TILE)) for p in range(ns)]


def _layer_view(k: torch.Tensor, layer, full_rank: int):
    """One layer of a stacked cache (or scales), or the unstacked one."""
    if k.dim() == full_rank + 1:
        if layer is None:
            raise ValueError("a stacked [L, B, ...] cache needs layer=")
        return k[layer]
    if layer is not None or k.dim() != full_rank:
        raise ValueError(f"layer= needs the stacked cache; got a "
                         f"{k.dim()}-d cache")
    return k


def _check_cache(k, v, k_scale, v_scale, ring, window, name):
    if window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")
    if ring and not 0 < window <= ring <= k.shape[-2]:
        raise ValueError(f"{name}: a ring of {ring} slots needs 0 < window "
                         f"<= ring <= the cache's {k.shape[-2]} slots; got "
                         f"window {window}")
    if v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError(f"{name}: k {tuple(k.shape)} {k.dtype} and v "
                         f"{tuple(v.shape)} {v.dtype} differ")
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: pass both k_scale and v_scale, or neither")
    if k_scale is None:
        if k.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the cache is bf16, or int8 with "
                             f"scales; got {k.dtype}")
        return
    if k.dtype != torch.int8:
        raise ValueError(f"{name}: scales come with the int8 cache, not "
                         f"{k.dtype}")
    for s in (k_scale, v_scale):
        if s.shape != k.shape[:-1] or s.dtype != torch.float32:
            raise ValueError(f"{name}: scales must be float32 "
                             f"{tuple(k.shape[:-1])}, got {tuple(s.shape)} "
                             f"{s.dtype}")


def _plain_cache(k, v, k_scale, v_scale, layer, ring):
    """One layer's K/V as float32 and its scales (or None); of a ring,
    only its first ``ring`` slots."""
    f32 = torch.float32
    s = ring or k.shape[-2]
    kl = _layer_view(k, layer, 4)[:, :, :s].to(f32)
    vl = _layer_view(v, layer, 4)[:, :, :s].to(f32)
    if k_scale is None:
        return kl, vl, None, None
    return (kl, vl, _layer_view(k_scale, layer, 3)[:, :, :s],
            _layer_view(v_scale, layer, 3)[:, :, :s])


def _on_cpu(name, tensors) -> bool:
    """True when every operand is on the CPU (the plain version runs);
    False when all are on one CUDA device (the kernel runs)."""
    devs = {t.device for t in tensors if t is not None}
    if devs == {torch.device("cpu")}:
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: all operands must be on one CUDA device "
                         "(or all on the CPU)")
    return False


def _kernel_view(t, layer, full_rank, name):
    """One layer's view for a kernel: pointer and slot stride (elements),
    each slot's block contiguous; K/V rows are read in 16-byte loads."""
    tl = _layer_view(t, layer, full_rank)
    inner = 1
    for dim in range(full_rank - 1, 0, -1):
        if tl.stride(dim) != inner:
            raise ValueError(f"{name} reads the cache in place: each slot's "
                             f"{tuple(tl.shape[1:])} block must be contiguous")
        inner *= tl.shape[dim]
    slot_bytes = tl.stride(0) * tl.element_size()
    if full_rank == 4 and (tl.data_ptr() % 16 or slot_bytes % 16):
        raise ValueError(f"{name}: the cache's slots must be 16-byte aligned")
    return _build.ptr(tl), tl.stride(0)


def _kernel_cache(k, v, k_scale, v_scale, layer, name):
    """The cache operands of a kernel: (k, v, k_scale, v_scale) pointers
    (null scales for bf16), the K/V slot stride and the scales' one."""
    (kp, kstride), (vp, vstride) = (_kernel_view(t, layer, 4, name)
                                    for t in (k, v))
    if vstride != kstride:
        raise ValueError(f"{name}: k and v strides differ")
    if k_scale is None:
        return kp, vp, _build.P(None), _build.P(None), kstride, 0
    (ksp, sstride), (vsp, vsstride) = (_kernel_view(t, layer, 3, name)
                                       for t in (k_scale, v_scale))
    if vsstride != sstride:
        raise ValueError(f"{name}: k_scale and v_scale strides differ")
    return kp, vp, ksp, vsp, kstride, sstride


def _check_decode(q, k, v, pos, k_current, v_current, k_scale, v_scale,
                  layer, window, ring):
    _check_cache(k, v, k_scale, v_scale, ring, window, "flash_decode")
    if (k_current is None) != (v_current is None):
        raise ValueError("pass both k_current and v_current, or neither")
    kl = _layer_view(k, layer, 4)
    b, kv, rep, hd = q.shape
    if kl.shape[:2] != (b, kv) or kl.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} does not match cache "
                         f"{tuple(k.shape)}")
    if pos.shape != (b,):
        raise ValueError(f"pos must be [B={b}], got {tuple(pos.shape)}")
    if k_current is not None and k_current.shape != (b, kv, 1, hd):
        raise ValueError(f"k_current must be [{b}, {kv}, 1, {hd}]")


def flash_decode_plain(q, k, v, pos, *, k_current=None, v_current=None,
                       k_scale=None, v_scale=None, layer=None, window=0,
                       ring=0, s_hi=None, pieces=None) -> torch.Tensor:
    """Plain PyTorch version: dense masked softmax in float32 over the
    valid cache slots plus the current token (``s_hi`` and ``pieces``
    only shape the kernel's grid)."""
    _check_decode(q, k, v, pos, k_current, v_current, k_scale, v_scale,
                  layer, window, ring)
    f32 = torch.float32
    kl, vl, ks, vs = _plain_cache(k, v, k_scale, v_scale, layer, ring)
    hd = q.shape[-1]
    s = kl.shape[2]
    qs = q.to(f32) * (1.0 / math.sqrt(hd))
    scores = torch.einsum("bgrd,bgsd->bgrs", qs, kl)
    if ks is not None:
        scores = scores * ks[:, :, None, :]
    has_cur = k_current is not None
    p = pos.to(torch.int64)
    span = torch.arange(s, device=q.device)[None, :]
    if ring:
        # age of each slot's token behind the newest cached one, and the
        # cached tokens the window holds
        seq_len = p + (0 if has_cur else 1)
        cnt = seq_len.clamp(max=window - (1 if has_cur else 0))
        mask = torch.remainder(seq_len[:, None] - 1 - span, ring) \
            < cnt[:, None]
    else:
        valid = (p + (0 if has_cur else 1)).clamp(0, s)
        mask = span < valid[:, None]
        if window:
            mask = mask & (span >= (p - window + 1).clamp(min=0)[:, None])
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    if not has_cur:
        probs = torch.softmax(scores, -1)
    else:
        cur = (qs * k_current.to(f32)).sum(-1, keepdim=True)
        probs = torch.softmax(torch.cat([scores, cur], dim=-1), dim=-1)
    pc = probs[..., :s]
    if vs is not None:
        pc = pc * vs[:, :, None, :]
    out = torch.einsum("bgrs,bgsd->bgrd", pc, vl)
    if has_cur:
        out = out + probs[..., s:] * v_current.to(f32)
    return out


def flash_decode(q, k, v, pos, *, k_current=None, v_current=None,
                 k_scale=None, v_scale=None, layer=None, window=0,
                 ring=0, s_hi=None, pieces=None) -> torch.Tensor:
    """Causal decode attention; ``q`` [B, KV, rep, hd] float32, the cache
    ``[L, B, KV, S, hd]`` with ``layer=`` (or ``[B, KV, S, hd]``), bf16 or
    int8 with ``k_scale``/``v_scale``; ``pos`` int [B]; returns float32
    [B, KV, rep, hd].

    ``s_hi``: the JAX argument's promise that every active slot's
    ``pos`` is below it (:func:`decode_s_hi`); it only narrows the piece
    count, and an inactive slot past it is still walked whole.
    ``pieces`` forces the piece count (1 .. :func:`decode_max_pieces`;
    tests).  ``flash_decode.last_pieces`` is the count of the last
    launch."""
    _check_decode(q, k, v, pos, k_current, v_current, k_scale, v_scale,
                  layer, window, ring)
    kw = dict(k_current=k_current, v_current=v_current, k_scale=k_scale,
              v_scale=v_scale, layer=layer, window=window, ring=ring)
    if s_hi is not None and s_hi < 1:
        raise ValueError(f"flash_decode: s_hi must be >= 1, got {s_hi}")
    if _on_cpu("flash_decode", [q, k, v, pos, k_current, v_current,
                                k_scale, v_scale]):
        return flash_decode_plain(q, k, v, pos, **kw)
    dev = q.device
    b, kv, rep, hd = q.shape
    s = k.shape[-2]
    kp, vp, ksp, vsp, kstride, sstride = _kernel_cache(
        k, v, k_scale, v_scale, layer, "flash_decode")
    null = _build.P(None)
    qf = q.to(torch.float32).contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    has_cur = k_current is not None
    kcur = k_current.to(torch.bfloat16).contiguous() if has_cur else None
    vcur = v_current.to(torch.bfloat16).contiguous() if has_cur else None
    out = torch.empty(b, kv, rep, hd, dtype=torch.float32, device=dev)
    slots = ring or s
    ns = decode_pieces(b, kv, rep, window, slots, s_hi)
    if pieces is not None:
        most = decode_max_pieces(window, slots, s_hi)
        if not 1 <= pieces <= most:
            raise ValueError(f"flash_decode: pieces must be in 1..{most}, "
                             f"got {pieces}")
        ns = int(pieces)
    po = pml = null
    if ns > 1:
        # [B, KV, ns, rep, hd] unnormalised outputs, then (max, sum)
        n = b * kv * ns * rep
        part = torch.empty(n * (hd + 2), dtype=torch.float32, device=dev)
        po, pml = _build.ptr(part), _build.ptr(part[n * hd:])
    P, I, L = _build.P, _build.I, _build.L
    fn = _build.function(
        "flash_decode", "qgt_flash_decode",
        [P] * 11 + [I] * 6 + [L, L] + [I] * 4 + [_build.F, P])
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(qf), kp, vp, ksp, vsp, _build.ptr(pos32),
                _build.ptr(kcur) if has_cur else null,
                _build.ptr(vcur) if has_cur else null, _build.ptr(out),
                po, pml, ns, b, kv, rep, hd, s, kstride, sstride,
                int(has_cur), int(k_scale is not None), int(window),
                int(ring), 1.0 / math.sqrt(hd), _build.stream(dev))
    _build.check("flash_decode", "qgt_flash_decode", rc)
    flash_decode.launches += 1
    flash_decode.last_pieces = ns
    return out


flash_decode.launches = 0
flash_decode.last_pieces = 0


def _check_prefill(q, k, v, pos0, rep, k_scale, v_scale, layer, window,
                   ring):
    _check_cache(k, v, k_scale, v_scale, ring, window, "flash_prefill")
    kl = _layer_view(k, layer, 4)
    b, kv, rows, hd = q.shape
    if rep < 1 or rows % rep:
        raise ValueError(f"flash_prefill: {rows} query rows are not T x "
                         f"rep={rep}")
    if ring and window + rows // rep > ring:
        raise ValueError(f"flash_prefill: a chunk of {rows // rep} tokens "
                         f"and a window of {window} overrun a ring of "
                         f"{ring} slots (window + T <= ring)")
    if kl.shape[:2] != (b, kv) or kl.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} does not match cache "
                         f"{tuple(k.shape)}")
    if pos0.shape != (b,):
        raise ValueError(f"pos0 must be [B={b}], got {tuple(pos0.shape)}")


def flash_prefill_plain(q, k, v, pos0, *, rep, k_scale=None, v_scale=None,
                        window=0, ring=0, layer=None) -> torch.Tensor:
    """Plain PyTorch version: dense masked softmax in float32 over the
    whole cache (a ring's first ``ring`` slots), every row masked by its
    own position."""
    _check_prefill(q, k, v, pos0, rep, k_scale, v_scale, layer, window,
                   ring)
    kl, vl, ks, vs = _plain_cache(k, v, k_scale, v_scale, layer, ring)
    rows, hd = q.shape[2], q.shape[3]
    s = kl.shape[2]
    qs = q.to(torch.float32) * (1.0 / math.sqrt(hd))
    scores = torch.einsum("bgqd,bgsd->bgqs", qs, kl)
    if ks is not None:
        scores = scores * ks[:, :, None, :]
    p0 = pos0.to(torch.int64)[:, None]
    qpos = (p0 + torch.arange(rows, device=q.device)[None, :] // rep)
    qpos = qpos[:, :, None]  # [B, rows, 1]
    span = torch.arange(s, device=q.device)[None, None, :]
    if ring:
        # the global position each slot holds, from the chunk's newest
        p_cache = p0[:, :, None] + rows // rep - 1
        g = p_cache - torch.remainder(p_cache - span, ring)
        mask = (g <= qpos) & (g >= 0) & (g > qpos - window)
    else:
        mask = span <= qpos  # [B, rows, S]
        if window:
            mask = mask & (span > qpos - window)
    scores = torch.where(mask[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if vs is not None:
        probs = probs * vs[:, :, None, :]
    return torch.einsum("bgqs,bgsd->bgqd", probs, vl)


def flash_prefill(q, k, v, pos0, *, rep, k_scale=None, v_scale=None,
                  window=0, ring=0, layer=None) -> torch.Tensor:
    """Causal prefill attention; ``q`` [B, KV, T*rep, hd] float32 in
    T-major rows, the cache ``[L, B, KV, S, hd]`` with ``layer=`` (or
    ``[B, KV, S, hd]``), bf16 or int8 with ``k_scale``/``v_scale``,
    holding the chunk's own rows; ``pos0`` int [B], each slot's first
    query position; returns float32 [B, KV, T*rep, hd]."""
    _check_prefill(q, k, v, pos0, rep, k_scale, v_scale, layer, window,
                   ring)
    kw = dict(rep=rep, k_scale=k_scale, v_scale=v_scale, window=window,
              ring=ring, layer=layer)
    if _on_cpu("flash_prefill", [q, k, v, pos0, k_scale, v_scale]):
        return flash_prefill_plain(q, k, v, pos0, **kw)
    dev = q.device
    b, kv, rows, hd = q.shape
    s = k.shape[-2]
    kp, vp, ksp, vsp, kstride, sstride = _kernel_cache(
        k, v, k_scale, v_scale, layer, "flash_prefill")
    qf = q.to(torch.float32).contiguous()
    pos32 = pos0.to(torch.int32).contiguous()
    out = torch.empty(b, kv, rows, hd, dtype=torch.float32, device=dev)
    ns = prefill_pieces(b, kv, rows, rep, window, ring or s)
    po = pml = _build.P(None)
    if ns > 1:
        # [B, KV, ns, rows, hd] unnormalised outputs, then (max, sum)
        n = b * kv * ns * rows
        part = torch.empty(n * (hd + 2), dtype=torch.float32, device=dev)
        po, pml = _build.ptr(part), _build.ptr(part[n * hd:])
    P, I, L = _build.P, _build.I, _build.L
    fn = _build.function(
        "flash_prefill", "qgt_flash_prefill",
        [P] * 9 + [I] * 7 + [L, L] + [I] * 3 + [_build.F, P])
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(qf), kp, vp, ksp, vsp, _build.ptr(pos32),
                _build.ptr(out), po, pml, ns, b, kv, rows, rep, hd, s,
                kstride, sstride,
                int(k_scale is not None), int(window), int(ring),
                1.0 / math.sqrt(hd), _build.stream(dev))
    _build.check("flash_prefill", "qgt_flash_prefill", rc)
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0


def flash_decode_ref(q, k, v, pos) -> torch.Tensor:
    """Reference (the same math as the dense model attention at T=1):
    ``k``/``v`` [B, KV, S, hd], slots ``<= pos`` attended."""
    return flash_decode_plain(q, k, v, pos)


__all__ = ["flash_decode", "flash_decode_plain", "flash_prefill",
           "flash_prefill_plain", "flash_decode_ref", "prefill_pieces",
           "prefill_piece_bounds", "decode_pieces", "decode_piece_bounds",
           "decode_max_pieces", "decode_span", "decode_s_hi", "NEG_INF"]
