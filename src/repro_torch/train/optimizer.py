"""Optimizers: BoomHQ's AdamW step, and the LM trainer's functional AdamW
(optionally with an int8 first moment), its schedules and Adafactor.

Port of ``repro.train.optimizer``. ``make_adamw`` and ``step`` serve
BoomHQ's trainers (the rewriter, the data encoder): ``torch.optim.AdamW``
(decoupled weight decay, bias-corrected moments, as ``adamw_update``
computes) after a global-norm clip of the gradients.

The LM trainer (``train/step.py``) uses the reference's functional
optimizers, in the reference's arithmetic rather than ``torch.optim``'s:
``adamw_update(grads, state, params, cfg) -> (new_params, new_state)``
and ``adafactor_update`` the same, on flat dicts of tensors keyed by the
parameter names (``lm.LM``'s: the reference's leaf names, a stacked leaf
``blocks/attn/wq`` as one tensor a layer, ``blocks.{i}.attn.wq``). The
state is ``{"step", "m", "v"}`` (Adafactor's ``{"step", "v"}``) keyed by
the same names, with ``step`` a 0-d int32 tensor on the parameters'
device. The clip is ``min(1, c / (global_norm + 1e-9))`` over every leaf
in f32 (``clip_grad_norm_`` adds 1e-6 instead); the learning rate is read
at the incremented step; the schedules compute in f32.

The int8 moment (``state_dtype="int8"``) quantizes the FIRST moment only,
absmax per last-dim row (a 0-d leaf on its own), rounding half to even as
``jnp.round`` does; the second moment is then bf16 (linear int8 zeroes
small v entries and 1/sqrt(v) explodes; bf16's exponent keeps them).

Adafactor's update is clipped by its RMS over the reference's whole leaf:
the layers of one stacked leaf (``blocks.{i}.<path>`` for every i) share
one RMS, as the stacked array does there. A stacked leaf is factored as
the reference factors the stacked shape, over the last two axes of each
layer's tensor; a 1-d leaf is never factored, where the reference would
factor a stack of ``min_dim_size_to_factor`` or more layers of it across
the layers (no config here has 64 layers).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = 1.0
    state_dtype: str = "float32"  # "float32" | "bfloat16" | "int8"


def make_adamw(params, cfg: AdamWConfig) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=cfg.lr, betas=(cfg.b1, cfg.b2),
                             eps=cfg.eps, weight_decay=cfg.weight_decay)


def step(opt: torch.optim.Optimizer, loss: torch.Tensor, cfg: AdamWConfig
         ) -> None:
    """One update: backward, global-norm clip, AdamW step."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    if cfg.grad_clip_norm is not None:
        params = [p for g in opt.param_groups for p in g["params"]]
        torch.nn.utils.clip_grad_norm_(params, cfg.grad_clip_norm)
    opt.step()


# ---------------------------------------------------------------------------
# int8 moments
# ---------------------------------------------------------------------------

def _quantize_i8(x: torch.Tensor) -> dict:
    """Per-row (last-dim) absmax int8: ``q`` of x's shape (int8), ``scale``
    (..., 1) f32; a 0-d x is its own row (a 0-d scale)."""
    x = x.float()
    if x.ndim == 0:
        scale = torch.clamp_min(x.abs(), 1e-12) / 127.0
    else:
        scale = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True),
                                1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def _dequantize_i8(qt: dict, shape, dtype=torch.float32) -> torch.Tensor:
    return (qt["q"].float() * qt["scale"]).reshape(shape).to(dtype)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _make_moment(x: torch.Tensor, state_dtype: str):
    if state_dtype == "int8":
        return _quantize_i8(torch.zeros_like(x, dtype=torch.float32))
    return torch.zeros(x.shape, dtype=_dtype(state_dtype), device=x.device)


def _read_moment(m, shape, state_dtype: str) -> torch.Tensor:
    if state_dtype == "int8":
        return _dequantize_i8(m, shape)
    return m.float()


def _write_moment(val: torch.Tensor, state_dtype: str):
    if state_dtype == "int8":
        return _quantize_i8(val)
    return val.to(_dtype(state_dtype))


def _v_dtype(state_dtype: str) -> str:
    return "bfloat16" if state_dtype == "int8" else state_dtype


def _step0(params: dict) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over the leaves of each leaf's sum of squares, in
    f32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tree.values()))


def _lr_at(lr, step: torch.Tensor):
    return lr(step) if callable(lr) else lr


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params: dict, cfg: AdamWConfig) -> dict:
    return {"step": _step0(params),
            "m": {k: _make_moment(p, cfg.state_dtype)
                  for k, p in params.items()},
            "v": {k: _make_moment(p, _v_dtype(cfg.state_dtype))
                  for k, p in params.items()}}


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params: dict, cfg: AdamWConfig
                 ) -> tuple:
    """Returns (new_params, new_state): the clip, then bias-corrected
    moments and decoupled weight decay, each leaf in f32 and cast back to
    its parameter's dtype."""
    step_ = state["step"] + 1
    clip = None
    if cfg.grad_clip_norm is not None:
        clip = torch.clamp(cfg.grad_clip_norm / (global_norm(grads) + 1e-9),
                           max=1.0)
    lr = _lr_at(cfg.lr, step_)
    t = step_.float()
    c1 = 1.0 - cfg.b1 ** t
    c2 = 1.0 - cfg.b2 ** t
    v_dtype = _v_dtype(cfg.state_dtype)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].float()
        if clip is not None:
            g32 = g32 * clip
        m32 = _read_moment(state["m"][k], p.shape, cfg.state_dtype)
        v32 = _read_moment(state["v"][k], p.shape, v_dtype)
        m32 = cfg.b1 * m32 + (1.0 - cfg.b1) * g32
        v32 = cfg.b2 * v32 + (1.0 - cfg.b2) * g32.square()
        delta = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        new_p[k] = (p.float() - lr * delta).to(p.dtype)
        new_m[k] = _write_moment(m32, cfg.state_dtype)
        new_v[k] = _write_moment(v32, v_dtype)
    return new_p, {"step": step_, "m": new_m, "v": new_v}


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine to
    ``floor · peak_lr`` at ``total``; step -> f32 0-d tensor."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step / max(1, warmup)
        t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)

    return sched


def constant_schedule(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment): the state of a matrix is O(rows +
# cols) instead of O(rows · cols)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-2
    decay: float = 0.8  # beta2_t = 1 - step^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    min_dim_size_to_factor: int = 64


def _factored(shape, cfg: AdafactorConfig) -> bool:
    return (len(shape) >= 2 and shape[-1] >= cfg.min_dim_size_to_factor
            and shape[-2] >= cfg.min_dim_size_to_factor)


def _leaf_groups(params: dict) -> dict:
    """The reference's leaf of each name: the name without its layer
    index (the first all-digit component). -> {leaf: [names]}."""
    groups: dict = {}
    for name in params:
        parts = name.split(".")
        i = next((j for j, q in enumerate(parts) if q.isdigit()), None)
        leaf = name if i is None else ".".join(parts[:i] + parts[i + 1:])
        groups.setdefault(leaf, []).append(name)
    return groups


def adafactor_init(params: dict, cfg: AdafactorConfig) -> dict:
    def mk(p):
        f32, dev = torch.float32, p.device
        if _factored(p.shape, cfg):
            return {"vr": torch.zeros(p.shape[:-1], dtype=f32, device=dev),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=f32,
                                      device=dev)}
        return {"v": torch.zeros(p.shape, dtype=f32, device=dev)}

    return {"step": _step0(params), "v": {k: mk(p) for k, p in params.items()}}


@torch.no_grad()
def adafactor_update(grads: dict, state: dict, params: dict,
                     cfg: AdafactorConfig) -> tuple:
    """Returns (new_params, new_state). Each reference leaf's update is
    divided by max(1, RMS / clip_threshold), the RMS over the whole leaf
    (every layer of a stacked one)."""
    step_ = state["step"] + 1
    t = step_.float()
    beta2 = 1.0 - t ** (-cfg.decay)
    lr = _lr_at(cfg.lr, step_)
    new_p, new_v = {}, {}
    for names in _leaf_groups(params).values():
        us = {}
        for k in names:
            g32 = grads[k].float()
            g2 = g32.square() + cfg.eps
            v = state["v"][k]
            if "vr" in v:
                vr = beta2 * v["vr"] + (1 - beta2) * g2.mean(dim=-1)
                vc = beta2 * v["vc"] + (1 - beta2) * g2.mean(dim=-2)
                r_factor = torch.rsqrt(vr / torch.clamp_min(
                    vr.mean(dim=-1, keepdim=True), cfg.eps))
                c_factor = torch.rsqrt(vc)
                us[k] = g32 * r_factor[..., None] * c_factor[..., None, :]
                new_v[k] = {"vr": vr, "vc": vc}
            else:
                vv = beta2 * v["v"] + (1 - beta2) * g2
                us[k] = g32 * torch.rsqrt(vv)
                new_v[k] = {"v": vv}
        n = sum(u.numel() for u in us.values())
        rms_u = torch.sqrt(sum(u.square().sum() for u in us.values()) / n
                           + 1e-12)
        div = torch.clamp_min(rms_u / cfg.clip_threshold, 1.0)
        for k, u in us.items():
            p32 = params[k].float()
            newp = p32 - lr * (u / div)
            if cfg.weight_decay:
                newp = newp - lr * cfg.weight_decay * p32
            new_p[k] = newp.to(params[k].dtype)
    return new_p, {"step": step_, "v": new_v}
