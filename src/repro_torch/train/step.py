"""The training step: remat + microbatch gradient accumulation +
optimizer.

Port of ``repro.train.step``. ``make_train_step`` returns
``train_step(model, opt_state, batch) -> (opt_state, metrics)``: the
gradients of ``lm.loss_fn`` (with ``remat`` each block under
``checkpoint``) over ``microbatches`` slices of the batch, accumulated
explicitly in ``grad_accum_dtype`` (``.grad`` would accumulate in the
parameter dtype), divided by their count and cast to f32, then the
optimizer's update, written into the model's parameters in place. The
metrics are the microbatches' means, as detached 0-d f32 tensors on the
model's device (nothing is read back to the host).

On a mesh (``init_state(..., mesh=)``) the parameters and the optimizer
state are DTensors placed by ``models/sharding.py``'s ``param_specs``
(``plan.fsdp`` shards the large weights over ``data`` too) and
``opt_state_specs``, and the batch by ``batch_specs``; the same step then
runs SPMD on every rank, DTensor's propagation standing for XLA's
partitioner (plain tensors the code makes are read as replicated). Each
gradient is brought to its parameter's placements (``grad_specs``' where
given): the gradient sync, a sum over the ranks that held the parameter
whole. Each microbatch splits the batch dimension only, the loop dim
whole (the reference's constraint: otherwise the data axis would spread
over both and each rank would see other microbatches). The int8 first
moment keeps its parameter's shape (a per-row scale), so every moment
leaf updates where its parameter lies; only the per-row absmax of a
row sharded over ``model`` takes a max over that axis. ``act_spec`` is
the residual stream's spec between blocks (``plan.seq_shard_acts``:
sequence-sharded carries).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import contextlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm, sharding
from repro_torch.train.optimizer import (
    AdafactorConfig, AdamWConfig, adafactor_init, adafactor_update,
    adamw_init, adamw_update, cosine_schedule,
)


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """Per-arch execution plan (``launch/plans.py`` owns the per-arch
    table)."""
    microbatches: int = 1
    remat: bool = True
    optimizer: str = "adamw"  # "adamw" | "adafactor"
    state_dtype: str = "float32"  # adamw moment dtype ("int8" = 8-bit adam)
    param_dtype: str = "float32"
    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup: int = 100
    total_steps: int = 10_000
    grad_clip: Optional[float] = 1.0
    fsdp: bool = False  # shard big weights over data too (ZeRO-3)
    seq_shard_acts: bool = False  # SP: shard the residual carry over `model`
    grad_accum_dtype: str = "float32"


def _opt(plan: TrainPlan):
    sched = cosine_schedule(plan.lr, plan.warmup, plan.total_steps)
    if plan.optimizer == "adafactor":
        cfg = AdafactorConfig(lr=sched, weight_decay=plan.weight_decay)
        return cfg, adafactor_init, adafactor_update
    cfg = AdamWConfig(lr=sched, weight_decay=plan.weight_decay,
                      grad_clip_norm=plan.grad_clip,
                      state_dtype=plan.state_dtype)
    return cfg, adamw_init, adamw_update


def init_state(cfg: ModelConfig, plan: TrainPlan, *, seed: int = 0,
               device=None, mesh=None) -> tuple:
    """(model, opt_state): ``lm.LM(cfg)`` drawn from ``seed`` on ``device``
    (the CUDA device unless the caller names another; ``"meta"`` for
    shapes without values), every floating parameter cast to
    ``plan.param_dtype`` where that is not f32, and the optimizer's state.
    With a ``mesh`` (a ``DeviceMesh`` with a ``model`` dim), the whole
    parameters, alike on every rank, become DTensors placed by
    ``param_specs(fsdp=plan.fsdp)`` and the state by ``opt_state_specs``."""
    model = lm.LM(cfg, seed=seed, device=device)
    if plan.param_dtype != "float32":
        dt = getattr(torch, plan.param_dtype)
        with torch.no_grad():
            for p in model.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(dt)
    if mesh is not None:
        return shard_state(model, plan, mesh)
    ocfg, oinit, _ = _opt(plan)
    return model, oinit(dict(model.named_parameters()), ocfg)


def shard_state(model: lm.LM, plan: TrainPlan, mesh) -> tuple:
    """(model, opt_state) on ``mesh``: the model's whole parameters
    (alike on every rank) placed in place by ``param_specs(fsdp=
    plan.fsdp)``, and a new optimizer state placed by
    ``opt_state_specs``."""
    pspec = sharding.param_specs(model.cfg, model, fsdp=plan.fsdp)
    sharding.place_model(model, mesh, pspec)
    ocfg, oinit, _ = _opt(plan)
    with implicit_replication():
        opt = oinit(dict(model.named_parameters()), ocfg)
    return model, place_state(opt, pspec, mesh)


def place_state(opt_state: dict, pspec: dict, mesh) -> dict:
    """An optimizer state (whole tensors or DTensors) placed by
    ``opt_state_specs``."""
    return sharding.place_tree(opt_state,
                               sharding.opt_state_specs(pspec, opt_state),
                               mesh)


def mesh_scope(params: dict):
    """``implicit_replication`` where the parameters are DTensors (the
    plain tensors the code makes are then whole on every rank), else
    nothing."""
    if any(_is_dtensor(t) for t in params.values()):
        return implicit_replication()
    return contextlib.nullcontext()


def implicit_replication():
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _synced(g, like, spec):
    """A DTensor gradient at its parameter's placements (``spec``'s where
    given): the partial sums over the ranks that held it whole are
    reduced."""
    if not _is_dtensor(g):
        return g
    pl = (sharding.placements(spec, like.device_mesh) if spec is not None
          else list(like.placements))
    return g if list(g.placements) == pl else g.redistribute(
        like.device_mesh, pl)


def _grads(model: lm.LM, names: list, tensors: list, batch: dict,
           plan: TrainPlan, act_spec=None, grad_specs=None) -> tuple:
    """-> (loss, metrics, one gradient a parameter; zeros where the loss
    does not reach it), the loss and metrics detached."""
    loss, metrics = lm.loss_fn(model, batch, remat=plan.remat,
                               act_spec=act_spec)
    gs = torch.autograd.grad(loss, tensors, allow_unused=True)
    gs = [_synced(torch.zeros_like(t) if g is None else g, t,
                  None if grad_specs is None else grad_specs[k])
          for k, t, g in zip(names, tensors, gs)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(names, gs)))


def _microbatch(v, n: int, i: int, whole=None, batch_axes=None):
    """Microbatch ``i`` of ``n`` of a batch leaf: rows ``i·b/n ..``; of a
    DTensor, taken from ``whole`` (the leaf with its batch dim gathered)
    and placed with its batch dim over ``batch_axes`` (the leaf's own
    placements without them): each microbatch is split over the batch's
    mesh dims, the loop dim whole."""
    mb = v.shape[0] // n
    if whole is None:
        return v[i * mb: (i + 1) * mb]
    part = whole[i * mb: (i + 1) * mb]
    if not batch_axes:
        return part.redistribute(v.device_mesh, v.placements)
    ax = tuple(batch_axes) if len(batch_axes) > 1 else batch_axes[0]
    return sharding.constrain(part, (ax, *([None] * (v.ndim - 1))))


def _gathered(v):
    """A DTensor batch leaf with its batch dim whole on every rank (the
    token ids: small beside the step)."""
    from torch.distributed.tensor import Replicate, Shard

    if not _is_dtensor(v):
        return None
    return v.redistribute(v.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == 0 else p
        for p in v.placements])


def accumulate_grads(model: lm.LM, batch: dict, plan: TrainPlan, *,
                     act_spec=None, batch_axes=None, grad_specs=None
                     ) -> tuple:
    """The step's gradients without the update: -> (loss, metrics, grads
    by parameter name). One microbatch gives the gradients in the
    parameters' dtype; ``n`` (which must divide the batch) accumulate in
    ``grad_accum_dtype``, then / n and f32, the loss and metrics their
    means. On a mesh each gradient is at its parameter's placements
    (``grad_specs``' where given), the accumulators too."""
    params = dict(model.named_parameters())
    names, tensors = list(params), list(params.values())
    n = plan.microbatches
    with mesh_scope(params):
        if n == 1:
            return _grads(model, names, tensors, batch, plan, act_spec,
                          grad_specs)
        return _accumulate(model, params, batch, plan, act_spec, batch_axes,
                           grad_specs)


def _accumulate(model, params: dict, batch: dict, plan: TrainPlan, act_spec,
                batch_axes, grad_specs) -> tuple:
    names, tensors = list(params), list(params.values())
    n = plan.microbatches
    b = next(iter(batch.values())).shape[0]
    assert b % n == 0, (b, n)
    acc_dt = getattr(torch, plan.grad_accum_dtype)
    grads = {k: _synced(torch.zeros_like(t, dtype=acc_dt), t,
                        None if grad_specs is None else grad_specs[k])
             for k, t in params.items()}
    whole = {k: _gathered(v) for k, v in batch.items()}
    losses, ms = [], []
    for i in range(n):
        part = {k: _microbatch(v, n, i, whole[k], batch_axes)
                for k, v in batch.items()}
        loss_i, m_i, g = _grads(model, names, tensors, part, plan, act_spec,
                                grad_specs)
        for k, gg in g.items():
            grads[k].add_(gg.to(acc_dt))
        del g
        losses.append(loss_i)
        ms.append(m_i)
    grads = {k: (g / n).float() for k, g in grads.items()}
    metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
    return torch.stack(losses).mean(), metrics, grads


def make_train_step(cfg: ModelConfig, plan: TrainPlan, act_spec=None,
                    batch_axes=None, grad_specs=None):
    """-> ``train_step(model, opt_state, batch) -> (opt_state, metrics)``;
    ``model`` (of ``cfg``) has its parameters updated in place. On a mesh:
    ``batch_axes`` the mesh dims the batch lies over (each microbatch is
    split over them), ``grad_specs`` ({name: spec}) the gradients' and
    accumulators' placements (the parameters' unless given), ``act_spec``
    the residual stream's spec between blocks."""
    ocfg, _, oupdate = _opt(plan)

    def train_step(model: lm.LM, opt_state: dict, batch: dict) -> tuple:
        loss, metrics, grads = accumulate_grads(
            model, batch, plan, act_spec=act_spec, batch_axes=batch_axes,
            grad_specs=grad_specs)
        params = dict(model.named_parameters())
        with mesh_scope(params):
            new_params, opt_state = oupdate(grads, opt_state, params, ocfg)
        del grads
        with torch.no_grad():
            for k, t in params.items():
                t.copy_(_synced(new_params[k], t, None))
        metrics = dict(metrics)
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step
