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

``fsdp`` and ``seq_shard_acts`` are fields of the plan that nothing reads
here, as in the reference outside a mesh (ROADMAP Queue 1 item 4.5).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
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
               device=None) -> tuple:
    """(model, opt_state): ``lm.LM(cfg)`` drawn from ``seed`` on ``device``
    (the CUDA device unless the caller names another), every floating
    parameter cast to ``plan.param_dtype`` where that is not f32, and the
    optimizer's state."""
    model = lm.LM(cfg, seed=seed, device=device)
    if plan.param_dtype != "float32":
        dt = getattr(torch, plan.param_dtype)
        with torch.no_grad():
            for p in model.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(dt)
    ocfg, oinit, _ = _opt(plan)
    return model, oinit(dict(model.named_parameters()), ocfg)


def _grads(model: lm.LM, names: list, tensors: list, batch: dict,
           plan: TrainPlan) -> tuple:
    """-> (loss, metrics, one gradient a parameter; zeros where the loss
    does not reach it), the loss and metrics detached."""
    loss, metrics = lm.loss_fn(model, batch, remat=plan.remat)
    gs = torch.autograd.grad(loss, tensors, allow_unused=True)
    gs = [torch.zeros_like(t) if g is None else g
          for t, g in zip(tensors, gs)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(names, gs)))


def accumulate_grads(model: lm.LM, batch: dict, plan: TrainPlan) -> tuple:
    """The step's gradients without the update: -> (loss, metrics, grads
    by parameter name). One microbatch gives the gradients in the
    parameters' dtype; ``n`` (which must divide the batch) accumulate in
    ``grad_accum_dtype``, then / n and f32, the loss and metrics their
    means."""
    params = dict(model.named_parameters())
    names, tensors = list(params), list(params.values())
    n = plan.microbatches
    if n == 1:
        return _grads(model, names, tensors, batch, plan)
    b = next(iter(batch.values())).shape[0]
    assert b % n == 0, (b, n)
    mb = b // n
    acc_dt = getattr(torch, plan.grad_accum_dtype)
    grads = {k: torch.zeros(t.shape, dtype=acc_dt, device=t.device)
             for k, t in params.items()}
    losses, ms = [], []
    for i in range(n):
        part = {k: v[i * mb: (i + 1) * mb] for k, v in batch.items()}
        loss_i, m_i, g = _grads(model, names, tensors, part, plan)
        for k, gg in g.items():
            grads[k].add_(gg.to(acc_dt))
        del g
        losses.append(loss_i)
        ms.append(m_i)
    grads = {k: (g / n).float() for k, g in grads.items()}
    metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
    return torch.stack(losses).mean(), metrics, grads


def make_train_step(cfg: ModelConfig, plan: TrainPlan):
    """-> ``train_step(model, opt_state, batch) -> (opt_state, metrics)``;
    ``model`` (of ``cfg``) has its parameters updated in place."""
    ocfg, _, oupdate = _opt(plan)

    def train_step(model: lm.LM, opt_state: dict, batch: dict) -> tuple:
        loss, metrics, grads = accumulate_grads(model, batch, plan)
        params = dict(model.named_parameters())
        new_params, opt_state = oupdate(grads, opt_state, params, ocfg)
        del grads
        with torch.no_grad():
            for k, t in params.items():
                t.copy_(new_params[k])
        metrics = dict(metrics)
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step
