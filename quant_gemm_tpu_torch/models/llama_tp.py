"""Tensor-parallel quantized Llama serving (Megatron sharding).

Counterpart of ``quant_gemm_tpu/models/llama_tp.py`` over
``torch.distributed``, one process per device: each rank holds its own
weight shards and its share of the KV cache, and runs the port's own
layer loop (``llama.forward`` on the rank's config with a reduce over
the ranks, :func:`tp_context`), so single-device and tensor-parallel
serving cannot drift apart.  Per layer: the column-parallel ``wqkv``
(the rank's heads and KV heads, fused as on one device; at decode through K2 ``norm_qkv`` where the single-device route
takes it), attention on the rank's heads (K3 at decode, K5 for prefill
chunks of 64 or more, the dense form below), the row-parallel ``wo`` and
an all-reduce, the column-parallel ``wgu`` (the rank's FFN features), the
row-parallel ``w_down`` and an all-reduce: two collectives a layer.  K8
(``attn_tail``) is off: its chain crosses the row-parallel sums.  The
embedding, the norms and ``lm_head`` are whole on every rank, and each
rank quantizes its activations itself (deterministic, so the ranks'
logits agree).

* :func:`shard_params_tp` quantizes and shards ``init_params``-style
  floats (numpy or CPU tensors): the rank's rows of ``wq``/``wk``/``wv``
  (fused) and ``w_gate``/``w_up`` (fused), its K columns of ``wo`` and
  ``w_down``, its part of a qwen2 QKV bias; per-32 formats and the q4_k
  / q5_k effective forms, as JAX;
* :func:`init_cache_tp` is the rank's KV cache (its KV heads; bf16 or
  the int8 ``q8`` cache);
* :func:`forward_tp` runs T tokens per slot; returns (logits [B, T,
  vocab], the same on every rank, and the rank's cache).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import registry
from ..parallel import sharding
from . import llama, train


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def shard_params_tp(params: dict, cfg: llama.LlamaConfig,
                    mesh: sharding.Mesh, qtype: str = "q4_0",
                    axis: str = "tp") -> dict:
    """This rank's quantized Megatron shard of float params (JAX
    ``shard_params_tp``), on ``mesh.device``.

    Column-parallel (head / feature rows): ``wqkv``, ``wgu``; row-parallel
    (K columns): ``wo`` (by head group), ``w_down`` (by FFN feature).  The
    embedding (bf16), the norms and ``lm_head`` (quantized whole) are
    replicated.  A per-16 K-quant raises, as in JAX (TP takes per-32
    forms); so does a q4_k / q5_k split whose K is no multiple of 256."""
    tp = mesh.shape[axis]
    if cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.d_ff % tp:
        raise ValueError(f"heads {cfg.n_heads}, KV heads {cfg.n_kv_heads} "
                         f"and d_ff {cfg.d_ff} must split {tp} ways")
    if qtype not in llama.QPARAM_QTYPES or qtype in ("q6_k", "q3_k",
                                                     "q2_k"):
        raise NotImplementedError(
            f"tensor parallelism takes the per-32 forms (q4_0, q4_1, q5_0, "
            f"q5_1, q8_0, q4_k, q5_k), not {qtype}")
    dev = mesh.device
    prep = llama._preparer(qtype, dev)

    def f32(x):
        return torch.as_tensor(_np(x), device=dev)

    out = {"embed": f32(params["embed"]).to(torch.bfloat16),
           "final_norm": f32(params["final_norm"]),
           "lm_head": prep(_np(params["lm_head"])), "layers": []}
    for lyr, roles in zip(params["layers"],
                          train.param_shardings(params)["layers"]):

        def mine(*keys, lyr=lyr, roles=roles):
            """The rank's chunks of ``keys``, concatenated (fused)."""
            return np.concatenate([sharding.megatron_chunk(
                torch.as_tensor(_np(lyr[k])), roles[k], mesh, axis).numpy()
                for k in keys])

        q = {k: f32(lyr[k]) for k in ("attn_norm", "mlp_norm")}
        if "bq" in lyr:  # the qwen2 QKV bias, head-chunked like wqkv
            q["bqkv"] = f32(mine("bq", "bk", "bv"))
        q["wqkv"] = prep(mine("wq", "wk", "wv"))
        q["wo"] = prep(mine("wo"))
        q["wgu"] = prep(mine("w_gate", "w_up"))
        q["w_down"] = prep(mine("w_down"))
        out["layers"].append(q)
    return out


def _local_cfg(cfg: llama.LlamaConfig, tp: int) -> llama.LlamaConfig:
    return cfg._replace(n_heads=cfg.n_heads // tp,
                        n_kv_heads=cfg.n_kv_heads // tp,
                        d_ff=cfg.d_ff // tp,
                        head_dim_override=cfg.head_dim)


def init_cache_tp(cfg: llama.LlamaConfig, batch: int, mesh: sharding.Mesh,
                  axis: str = "tp", qtype: str = "bf16") -> llama.KVCache:
    """The rank's KV cache: its ``n_kv_heads / tp`` heads of every layer
    (bf16, or int8 codes with per-vector scales for ``"q8"``)."""
    return llama.KVCache.init(_local_cfg(cfg, mesh.shape[axis]), batch,
                              qtype, device=mesh.device)


def tp_context(cfg: llama.LlamaConfig, mesh: sharding.Mesh,
               axis: str = "tp") -> tuple:
    """What ``llama.forward`` (and ``begin`` / ``layer``) take to run this
    rank: ``(cfg, tp_ctx)``, the config with the rank's head, KV head and
    FFN widths, and the in-place all-reduce over ``mesh[axis]`` of the
    row-parallel outputs."""
    return (_local_cfg(cfg, mesh.shape[axis]),
            lambda y: sharding.all_reduce(y, mesh, axis))


def forward_tp(qparams: dict, cfg: llama.LlamaConfig, tokens, cache,
               mesh: sharding.Mesh, *, act_mode: str = "q8_1",
               axis: str = "tp", ops: registry.Ops = registry.KERNELS,
               rope_cache=None):
    """The TP forward: ``llama.forward``'s own loop on this rank's shards
    (:func:`tp_context`: two all-reduces a layer, attention on the rank's
    heads).  Returns (logits [B, T, vocab], cache), the cache the rank's,
    updated in place."""
    local, reduce = tp_context(cfg, mesh, axis)
    tokens = torch.as_tensor(tokens, device=mesh.device)
    return llama.forward(qparams, local, tokens, cache, act_mode=act_mode,
                         rope_cache=rope_cache, ops=ops, tp_ctx=reduce)


__all__ = ["shard_params_tp", "init_cache_tp", "tp_context", "forward_tp"]
