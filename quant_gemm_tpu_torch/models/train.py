"""Quantization-aware training (straight-through estimator).

Counterpart of ``quant_gemm_tpu/models/train.py``: a next-token
cross-entropy step over the Llama architecture in which every linear runs
through fake quantization (quantize -> dequantize) with a straight-through
gradient, ``w + (fq(w) - w).detach()``, so the trained weights land on the
block grid they are served from (``llama.quantize_params`` of the trained
floats dequantizes to exactly the training forward's weights).

The path is plain PyTorch with autograd, as the JAX one runs no Pallas
kernel: the linears are float32 matmuls on the fake-quantized weight
(``train.py:45-47``), RMSNorm is the plain form, and attention is the
dense grouped einsum of ``llama._attention`` (the JAX
``_attention(differentiable=True)``, with its causal, window and ring
masks), never K5, which has no backward.  On a card the float32 matmuls
follow ``torch.backends.cuda.matmul.allow_tf32`` (False by default, and
then full float32 as in the reference).

Parameters are dicts of float32 tensors in ``llama.init_params``'s
structure; :func:`leaves` walks them in ``jax.tree.leaves`` order (dict
keys sorted), the order of the ``.npz`` train states.

* :func:`loss_fn`, :func:`value_and_grad`, :func:`train_step` (one SGD
  step);
* :func:`make_optimizer` (``"adamw" | "adam" | "sgd" | "lion"`` at optax's
  defaults, on ``torch.optim``; Lion is :class:`Lion`) and
  :func:`make_state_step` (optimizer state, remat, gradient accumulation;
  with a mesh, the Megatron dp x tp step of :func:`param_shardings`);
* :func:`save_train_state` / :func:`load_train_state` (one ``.npz``; a
  JAX-written file's parameters, and its adam / adamw / lion / sgd state,
  load too);
* :func:`make_sharded_step` (the sharded SGD step) and
  :func:`gather_params` (the whole parameters back from the shards).

Sharded training runs one process per device over ``torch.distributed``
(``parallel/sharding.py``'s mesh): each rank holds its ``tp`` chunk of
every column-parallel (out-feature rows: ``wq``, ``wk``, ``wv``,
``w_gate``, ``w_up``, ``embed`` and ``lm_head`` by vocabulary rows) and
row-parallel (``wo``, ``w_down`` by K columns) weight, the norms whole.
The tp linears use Megatron's pair of autograd functions
(``sharding.copy_to``: identity forward, all-reduce backward;
``sharding.reduce_from``: all-reduce forward, identity backward), the
vocabulary-parallel head gathers its logits (``sharding.gather_from``),
and gradients are averaged over ``dp``.  Each rank's step takes its own
``dp`` rows of the batch; its result is the single-process step's on the
whole batch, up to the order of the float sums.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..formats.quant import QUANTIZE, dequantize
from ..ops.activations import silu_mul
from ..ops.rms_norm import rms_norm
from ..ops.rope import apply_rope, rope_cache as make_rope_cache
from ..parallel import sharding
from ..utils import resolve_device
from .llama import LlamaConfig, _attention

def fake_quant_ste(w: torch.Tensor, qtype: str = "q4_0") -> torch.Tensor:
    """Quantize -> dequantize (``formats.quant.QUANTIZE[qtype]``) in the
    forward, the identity gradient in the backward."""
    with torch.no_grad():
        delta = dequantize(QUANTIZE[qtype](w.detach())) - w.detach()
    return w + delta


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------


def leaves(params: dict) -> list:
    """The leaves of an ``init_params``-structured dict in ``jax.tree.
    leaves`` order: embed, final_norm, each layer's leaves by sorted key
    (attn_norm, mlp_norm, w_down, w_gate, w_up, wk, wo, wq, wv), lm_head."""
    out = [params["embed"], params["final_norm"]]
    for lyr in params["layers"]:
        out.extend(lyr[k] for k in sorted(lyr))
    out.append(params["lm_head"])
    return out


def unflatten(template: dict, values) -> dict:
    """:func:`leaves` inverse: ``values`` in leaf order into the
    structure of ``template``."""
    it = iter(values)
    out = {"embed": next(it), "final_norm": next(it), "layers": []}
    for lyr in template["layers"]:
        out["layers"].append({k: next(it) for k in sorted(lyr)})
    out["lm_head"] = next(it)
    return out


def _float32(p) -> torch.Tensor:
    """A leaf (numpy or a tensor on any device) as a float32 tensor."""
    if isinstance(p, torch.Tensor):
        return p.detach().to(torch.float32)
    return torch.as_tensor(np.asarray(p, np.float32))


def _to_device(params: dict, dev: torch.device) -> list:
    return [_float32(p).to(dev, copy=True).requires_grad_()
            for p in leaves(params)]


# ---------------------------------------------------------------------------
# the forward (one device, or one rank of a tp group)
# ---------------------------------------------------------------------------


class _Ops(NamedTuple):
    """How a layer reaches its linears: on one device every hook is the
    identity; under tp they are Megatron's collectives."""

    copy: object  # before column-parallel linears
    reduce: object  # after row-parallel linears
    gather: object  # the vocabulary-parallel logits
    embed: object  # the vocabulary-parallel lookup


def _ident(x):
    return x


def _lookup(table, tokens):
    return table[tokens]


_LOCAL = _Ops(_ident, _ident, _ident, _lookup)


def _layer(lyr, x, cfg: LlamaConfig, rc, qtype: str, ops: _Ops = _LOCAL):
    """One transformer block with fake-quantized linears (JAX
    ``_layer``); the head and feature counts are those of ``lyr``'s
    weights, all of them on one device, a tp rank's share under tp."""
    b, t, _ = x.shape
    hd = cfg.head_dim

    def lin(w, h):
        return h @ fake_quant_ste(w, qtype).T

    positions = torch.arange(t, device=x.device)
    h = ops.copy(rms_norm(x, lyr["attn_norm"], cfg.eps).reshape(b * t, -1))
    q = lin(lyr["wq"], h).reshape(b, t, -1, hd)
    k = lin(lyr["wk"], h).reshape(b, t, -1, hd)
    v = lin(lyr["wv"], h).reshape(b, t, -1, hd)
    q = apply_rope(q, positions[None, :], rc)
    k = apply_rope(k, positions[None, :], rc)
    attn = _attention(cfg, q, k.transpose(1, 2), v.transpose(1, 2),
                      positions[None, :].expand(b, t))
    o = ops.reduce(lin(lyr["wo"], attn.reshape(b * t, -1)))
    x = x + o.reshape(b, t, cfg.dim)
    h = ops.copy(rms_norm(x, lyr["mlp_norm"], cfg.eps).reshape(b * t, -1))
    ff = silu_mul(lin(lyr["w_gate"], h), lin(lyr["w_up"], h))
    return x + ops.reduce(lin(lyr["w_down"], ff)).reshape(b, t, cfg.dim)


def _train_forward(params, cfg: LlamaConfig, tokens, qtype: str,
                   remat: bool = False, ops: _Ops = _LOCAL):
    """Full-sequence causal forward with fake-quantized linears: logits
    [B, T, vocab].  ``remat=True`` wraps each block in
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward pass, the fake quantization too (the same
    bits: the quantizers are deterministic)."""
    b, t = tokens.shape
    dev = params["embed"].device
    rc = make_rope_cache(cfg.max_seq, cfg.head_dim, cfg.rope_base,
                         freq_scale=cfg.rope_scale, device=dev)
    x = ops.embed(params["embed"], tokens).to(torch.float32)
    for lyr in params["layers"]:
        if remat:
            x = checkpoint(_layer, lyr, x, cfg, rc, qtype, ops,
                           use_reentrant=False)
        else:
            x = _layer(lyr, x, cfg, rc, qtype, ops)
    x = ops.copy(rms_norm(x, params["final_norm"], cfg.eps).reshape(b * t,
                                                                   -1))
    logits = x @ fake_quant_ste(params["lm_head"], qtype).T
    return ops.gather(logits).reshape(b, t, -1)


def loss_fn(params, cfg: LlamaConfig, tokens, qtype: str = "q4_0",
            remat: bool = False, ops: _Ops = _LOCAL):
    """Next-token cross-entropy (mean over the batch's predictions)."""
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    logits = _train_forward(params, cfg, tokens[:, :-1], qtype, remat, ops)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None])
    return torch.mean(nll)


def value_and_grad(params, cfg: LlamaConfig, tokens, qtype: str = "q4_0",
                   remat: bool = False, ops: _Ops = _LOCAL):
    """(loss, gradients in ``params``' structure), as
    ``jax.value_and_grad(loss_fn)``; ``params`` are not modified."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss = loss_fn(unflatten(params, flat), cfg, tokens, qtype, remat, ops)
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), unflatten(params, grads)


def train_step(params, cfg: LlamaConfig, tokens, lr: float = 1e-3,
               qtype: str = "q4_0"):
    """One SGD step: returns (new params, loss)."""
    loss, grads = value_and_grad(params, cfg, tokens, qtype)
    new = [(p - lr * g).detach()
           for p, g in zip(leaves(params), leaves(grads))]
    return unflatten(params, new), loss


# ---------------------------------------------------------------------------
# optimizers at optax's defaults, optimizer state, accumulation
# ---------------------------------------------------------------------------


class Lion(torch.optim.Optimizer):
    """``optax.lion``: ``u = sign((1 - b1) g + b1 mu)``, ``mu <- (1 - b2)
    g + b2 mu``, ``p <- p + (-lr) (u + weight_decay p)``, each step in
    optax's order."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.99),
                 weight_decay: float = 1e-3):
        super().__init__(params, dict(lr=lr, betas=tuple(betas),
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p)
                g, mu = p.grad, st["exp_avg"]
                u = torch.sign((1.0 - b1) * g + b1 * mu)
                mu.copy_((1.0 - b2) * g + b2 * mu)
                p.add_(-group["lr"] * (u + group["weight_decay"] * p))
                st["step"] += 1
        return loss


#: optax's keyword names -> ``torch.optim``'s, and each optimizer's
#: defaults (optax's, which differ from torch's: AdamW's decay 1e-4, not
#: 1e-2; SGD without momentum)
_OPTIMIZERS = {
    "adamw": (torch.optim.AdamW, dict(b1=0.9, b2=0.999, eps=1e-8,
                                      weight_decay=1e-4)),
    "adam": (torch.optim.Adam, dict(b1=0.9, b2=0.999, eps=1e-8)),
    "sgd": (torch.optim.SGD, dict(momentum=None, nesterov=False)),
    "lion": (Lion, dict(b1=0.9, b2=0.99, weight_decay=1e-3)),
}
#: each optimizer's per-parameter state in the JAX (optax) state's leaf
#: order after its step count: adam's mu then nu, lion's mu, sgd's trace
_JAX_STATE = {"adamw": ("exp_avg", "exp_avg_sq"),
              "adam": ("exp_avg", "exp_avg_sq"), "lion": ("exp_avg",),
              "sgd": ("momentum_buffer",)}


class Transform(NamedTuple):
    """An optimizer recipe (the optax ``GradientTransformation`` of
    :func:`make_optimizer`): :meth:`init` binds it to parameters."""

    name: str
    lr: float
    kw: dict

    def init(self, params: dict) -> torch.optim.Optimizer:
        """A ``torch.optim`` optimizer over ``params``' leaves (tensors),
        in :func:`leaves` order; it remembers this recipe as
        ``.transform``."""
        cls, _ = _OPTIMIZERS[self.name]
        kw = self.kw
        if self.name in ("adamw", "adam", "lion"):
            args = dict(betas=(kw["b1"], kw["b2"]))
            args.update({k: v for k, v in kw.items()
                         if k not in ("b1", "b2")})
        else:
            args = dict(momentum=kw["momentum"] or 0.0,
                        nesterov=kw["nesterov"])
        opt = cls(leaves(params), lr=self.lr, **args)
        opt.transform = self
        return opt


def make_optimizer(name: str = "adamw", lr: float = 1e-3,
                   **kw) -> Transform:
    """``"adamw" | "adam" | "sgd" | "lion"`` with optax's keywords (``b1``,
    ``b2``, ``eps``, ``weight_decay``, ``momentum``, ``nesterov``) and
    optax's defaults; the decay applies to every leaf, norms included
    (optax's ``mask=None``)."""
    if name not in _OPTIMIZERS:
        raise ValueError(f"optimizer must be one of {sorted(_OPTIMIZERS)}, "
                         f"not {name!r}")
    defaults = dict(_OPTIMIZERS[name][1])
    unknown = set(kw) - set(defaults)
    if unknown:
        raise TypeError(f"{name} takes {sorted(defaults)}, not "
                        f"{sorted(unknown)}")
    defaults.update(kw)
    return Transform(name, lr, defaults)


def make_state_step(params, cfg: LlamaConfig, mesh=None,
                    optimizer: str = "adamw", lr: float = 1e-3,
                    qtype: str = "q4_0", remat: bool = False,
                    accum_steps: int = 1, device="cuda"):
    """The QAT trainer: returns ``(params, opt_state, step_fn)``;
    ``step_fn(params, opt_state, tokens) -> (params, opt_state, loss)``
    updates both in place and returns them.

    ``params``: ``init_params``-structured floats (numpy or tensors),
    copied onto ``device`` (the returned params never alias the
    caller's).  ``accum_steps > 1`` splits the batch into microbatches:
    the loss and the gradients are the means of theirs (JAX
    ``train.py:163-175``).  With ``mesh`` (``sharding.make_mesh`` over
    ``dp`` and ``tp``), each rank keeps its shard of the parameters
    (:func:`param_shardings`) on the mesh's device and ``step_fn`` takes
    the rank's ``dp`` rows of the batch; the loss is the whole batch's."""
    if mesh is not None:
        dev = mesh.device
        params = shard_params(params, mesh)
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        ops = _tp_ops(mesh, params)
    else:
        dev = resolve_device(device)
        flat = _to_device(params, dev)
        ops = _LOCAL
    params = unflatten(params, flat)
    opt_state = make_optimizer(optimizer, lr).init(params)

    def grads_of(params, tokens):
        tokens = torch.as_tensor(tokens, device=dev).long()
        if accum_steps == 1:
            return value_and_grad(params, cfg, tokens, qtype, remat, ops)
        micro = tokens.reshape(accum_steps, -1, tokens.shape[-1])
        loss_sum, g_sum = 0.0, None
        for mb in micro:
            loss, g = value_and_grad(params, cfg, mb, qtype, remat, ops)
            loss_sum = loss_sum + loss
            g_sum = leaves(g) if g_sum is None else [
                a + b for a, b in zip(g_sum, leaves(g))]
        scale = 1.0 / accum_steps
        return loss_sum * scale, unflatten(params, [g * scale
                                                    for g in g_sum])

    def step(params, opt_state, tokens):
        loss, grads = grads_of(params, tokens)
        gl = leaves(grads)
        if mesh is not None and mesh.shape.get("dp", 1) > 1:
            dp = mesh.shape["dp"]
            gl = [sharding.all_reduce(g, mesh, "dp") / dp for g in gl]
            loss = sharding.all_reduce(loss, mesh, "dp") / dp
        for p, g in zip(leaves(params), gl):
            p.grad = g
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, loss

    return params, opt_state, step


def _opt_leaves(opt: torch.optim.Optimizer, params: dict):
    """The optimizer's per-parameter state in :func:`leaves` order, each
    parameter's keys sorted: ([(leaf index, key)], [tensor])."""
    keys, vals = [], []
    for i, p in enumerate(leaves(params)):
        for key in sorted(opt.state.get(p, {})):
            keys.append((i, key))
            vals.append(opt.state[p][key])
    return keys, vals


def save_train_state(path, params, opt_state, step: int = 0) -> None:
    """Parameters, optimizer state and step counter to one ``.npz``:
    ``leaf_i`` the parameters in :func:`leaves` (JAX) order, then the
    optimizer's state tensors, named by ``__opt__`` (JSON bytes: leaf
    index and state key of each)."""
    keys, vals = _opt_leaves(opt_state, params)
    arrays = [np.asarray(v.detach().cpu()) for v in leaves(params) + vals]
    np.savez(path, __step__=np.int64(step),
             __opt__=np.frombuffer(json.dumps(keys).encode(), np.uint8),
             **{f"leaf_{i}": a for i, a in enumerate(arrays)})


def load_train_state(path, params_template, opt_state_template):
    """Restore ``(params, opt_state, step)`` saved by
    :func:`save_train_state`, or by the JAX package's (its parameters,
    and the state of its adam, adamw, lion or sgd).

    ``params_template`` gives the structure, ``opt_state_template`` (from
    ``make_optimizer(...).init``) the optimizer and the device; the
    parameters are new tensors, the optimizer a new one over them."""
    data = np.load(path)
    tx = opt_state_template.transform
    dev = opt_state_template.param_groups[0]["params"][0].device
    n = len(leaves(params_template))
    params = unflatten(params_template, [
        torch.as_tensor(data[f"leaf_{i}"]).to(dev).requires_grad_()
        for i in range(n)])
    opt = tx.init(params)
    if "__opt__" in data:
        keys = json.loads(bytes(data["__opt__"]).decode())
        vals = [data[f"leaf_{n + j}"] for j in range(len(keys))]
    else:  # a JAX file: the optax state's count, then its moments
        keys, vals = _from_optax(tx.name, data, n)
    state = {}
    for (i, key), v in zip(keys, vals):
        state.setdefault(i, {})[key] = torch.as_tensor(v)
    opt.load_state_dict({"state": state,
                         "param_groups": opt.state_dict()["param_groups"]})
    return params, opt, int(data["__step__"])


def _from_optax(name: str, data, n: int):
    """The state leaves of a JAX-written file as (leaf index, key) pairs:
    the optax count (int) becomes torch's float ``step`` of every
    parameter (SGD keeps none), then each moment's leaves in order."""
    extra = len([k for k in data.files if k.startswith("leaf_")]) - n
    moments = _JAX_STATE[name]
    if extra == 0 and name == "sgd":
        return [], []
    if name == "sgd" and extra == n:  # optax.sgd(momentum=...): its trace
        return ([(i, moments[0]) for i in range(n)],
                [data[f"leaf_{n + i}"] for i in range(n)])
    if extra != 1 + len(moments) * n:
        raise ValueError(f"{extra} optimizer leaves do not match "
                         f"optax.{name}'s state")
    count = np.float32(data[f"leaf_{n}"])
    keys, vals = [], []
    for i in range(n):
        keys.append((i, "step"))
        vals.append(np.asarray(count))
        for j, key in enumerate(moments):
            keys.append((i, key))
            vals.append(data[f"leaf_{n + 1 + j * n + i}"])
    return keys, vals


# ---------------------------------------------------------------------------
# tensor and data parallelism
# ---------------------------------------------------------------------------


def param_shardings(params) -> dict:
    """Each leaf's Megatron role, in ``params``' structure (JAX
    ``param_shardings``): ``"col"`` (out-feature rows split over tp:
    ``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up``, ``embed``,
    ``lm_head``), ``"row"`` (K columns split: ``wo``, ``w_down``) or
    ``"rep"`` (replicated: the norms)."""

    def role(k):
        if k.endswith("norm"):
            return "rep"
        return "row" if k in ("wo", "w_down") else "col"

    return {"embed": "col", "final_norm": "rep", "lm_head": "col",
            "layers": [{k: role(k) for k in lyr} for lyr in params["layers"]]}


def shard_params(params, mesh, axis: str = "tp") -> dict:
    """This rank's shard of ``init_params``-structured floats (float32
    tensors on ``mesh.device``) by :func:`param_shardings`."""
    roles = leaves(param_shardings(params))
    out = [sharding.megatron_chunk(_float32(p), r, mesh, axis).to(
        mesh.device, copy=True) for p, r in zip(leaves(params), roles)]
    return unflatten(params, out)


def gather_params(params, mesh, axis: str = "tp") -> dict:
    """The whole parameters from every rank's shard (an all-gather of
    each sharded leaf over ``axis``)."""
    roles = leaves(param_shardings(params))
    out = []
    for p, r in zip(leaves(params), roles):
        p = p.detach()
        if r != "rep":
            p = sharding.all_gather(p, mesh, axis, dim=0 if r == "col"
                                    else 1)
        out.append(p)
    return unflatten(params, out)


def _tp_ops(mesh, params, axis: str = "tp") -> _Ops:
    """Megatron's hooks over ``mesh[axis]``; the vocabulary rows of this
    rank's ``embed`` shard start at ``idx * rows``."""
    rows = params["embed"].shape[0]
    v0 = mesh.index(axis) * rows

    def embed(table, tokens):
        local = tokens - v0
        inside = (local >= 0) & (local < rows)
        x = table[local.clamp(0, rows - 1)] * inside[..., None]
        return sharding.reduce_from(x, mesh, axis)

    return _Ops(lambda x: sharding.copy_to(x, mesh, axis),
                lambda x: sharding.reduce_from(x, mesh, axis),
                lambda x: sharding.gather_from(x, mesh, axis, dim=-1),
                embed)


def make_sharded_step(params, cfg: LlamaConfig, mesh, lr: float = 1e-3,
                      qtype: str = "q4_0"):
    """The SGD step (:func:`train_step`) over a dp x tp mesh: returns
    (this rank's parameter shard, ``step(params, tokens) -> (params,
    loss)``), ``tokens`` the rank's ``dp`` rows."""
    params = shard_params(params, mesh)
    ops = _tp_ops(mesh, params)
    dp = mesh.shape.get("dp", 1)

    def step(params, tokens):
        tokens = torch.as_tensor(tokens, device=mesh.device).long()
        loss, grads = value_and_grad(params, cfg, tokens, qtype, False, ops)
        gl = leaves(grads)
        if dp > 1:
            gl = [sharding.all_reduce(g, mesh, "dp") / dp for g in gl]
            loss = sharding.all_reduce(loss, mesh, "dp") / dp
        new = [(p - lr * g).detach() for p, g in zip(leaves(params), gl)]
        return unflatten(params, new), loss

    return params, step


__all__ = ["fake_quant_ste", "leaves", "unflatten", "loss_fn",
           "value_and_grad", "train_step", "Lion", "Transform",
           "make_optimizer", "make_state_step", "save_train_state",
           "load_train_state", "param_shardings", "shard_params",
           "gather_params", "make_sharded_step"]
