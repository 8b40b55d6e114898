"""Mixture-of-Experts layer: top-k router + capacity-bounded einsum dispatch.

Port of ``repro.models.moe``. GShard-style **grouped** dispatch: each batch
row (or, with ``cfg.moe_group_tokens``, each run of that many tokens of a
row) is a group with its own expert capacity C = ceil(S·k/E · cf), rounded
up to a multiple of 4 above 4, so the dispatch/combine tensors are
(B, S, E, C). Within a group, a token's first choice claims capacity
before any second choice, and each choice in sequence order; assignments
past capacity are dropped and fall through on the residual path. Aux
losses: Switch load-balance (top-1 occupancy × mean prob), a router z-loss
and the dropped share.

The router's logits and softmax are f32 (its weight stays f32 in every
parameter dtype); the dispatch, the experts and the combine run in x's
dtype. Ties in the router's top-k go to the smaller expert id, as
``lax.top_k`` breaks them.

Under an activation context (``sharding.act_axes``) the batch dim of
each intermediate is pinned to the data axes with ``constrain_batch``, as
in the reference; without one that does nothing. The expert-parallel
scatter form over ``torch.distributed`` is ``models/moe_sharded.py``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.common import nn as cnn
from repro_torch.configs.base import ModelConfig
from repro_torch.models.ffn import FFN, ffn_apply
from repro_torch.models.sharding import constrain_batch, settle


class MoE(nn.Module):
    """``router`` (d, E) f32, ``w_up``/``w_gate`` (E, d, f), ``w_down``
    (E, f, d) and, with ``cfg.n_shared_experts``, a ``shared`` ``FFN`` of
    width ``moe_d_ff · n_shared_experts``. The expert weights are cast to
    ``dtype`` as each is drawn, so a bf16 model never holds a whole f32
    expert stack beside its bf16 one."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        g = generator
        std = 1.0 / math.sqrt(d)
        self.router = nn.Parameter(cnn.trunc_normal((d, e), std, g))
        self.w_up = nn.Parameter(cnn.trunc_normal((e, d, f), std, g).to(dtype))
        self.w_gate = nn.Parameter(cnn.trunc_normal((e, d, f), std, g)
                                   .to(dtype))
        self.w_down = nn.Parameter(cnn.trunc_normal(
            (e, f, d), 1.0 / math.sqrt(f), g).to(dtype))
        if cfg.n_shared_experts:
            self.shared = FFN(d, f * cfg.n_shared_experts, cfg.ffn_act,
                              generator=g)


def router_topk(logits: torch.Tensor, k: int) -> tuple:
    """logits (..., E) -> (weights (..., k) renormalized, idx (..., k),
    probs (..., E) f32). Equal probabilities rank by the smaller id."""
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9)
    return top_p, top_i, probs


def group_capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(tokens_per_group * cfg.n_experts_per_tok
                      / cfg.n_experts * cfg.capacity_factor))
    return max(1, -(-c // 4) * 4) if c > 4 else max(1, c)


def expert_positions(top_i: torch.Tensor, e: int, cap: int) -> tuple:
    """top_i (..., T, k) -> (pos, keep), each (..., T, k): each assignment's
    slot in its expert's queue over the T axis, choice 0 of every token
    first, then choice 1, ...; ``keep`` where the slot is under ``cap``."""
    counts = torch.zeros((*top_i.shape[:-2], e), dtype=torch.int64,
                         device=top_i.device)
    pos_list = []
    for j in range(top_i.shape[-1]):
        onehot = nn.functional.one_hot(top_i[..., j], e)  # (..., T, E)
        pos_j = torch.cumsum(onehot, dim=-2) - 1 + counts.unsqueeze(-2)
        counts = counts + onehot.sum(dim=-2)
        pos_list.append((pos_j * onehot).sum(dim=-1))
    pos = torch.stack(pos_list, dim=-1)
    return pos, pos < cap


def routing_tensors(top_w, top_i, keep_dtype, e: int, cap: int) -> tuple:
    """Grouped dispatch/combine from top_w/top_i (B, S, k): dispatch and
    combine (B, S, E, C) in ``keep_dtype``, and the keep mask (B, S, k)."""
    pos, keep = expert_positions(top_i, e, cap)
    keep_f = keep.to(keep_dtype)
    e_onehot = nn.functional.one_hot(top_i, e).to(keep_dtype)  # (B,S,k,E)
    # a dropped assignment's slot is past C: its one-hot row is all zero
    c_onehot = nn.functional.one_hot(pos.clamp(max=cap), cap + 1)[
        ..., :cap].to(keep_dtype)  # (B,S,k,C)
    kw = top_w.to(keep_dtype) * keep_f
    combine = torch.einsum("bske,bskc->bsec", e_onehot * kw[..., None],
                           c_onehot)
    dispatch = torch.einsum("bske,bskc->bsec", e_onehot * keep_f[..., None],
                            c_onehot)
    return dispatch, combine, keep


def experts_ffn(p: dict, cfg: ModelConfig, expert_in: torch.Tensor
                ) -> torch.Tensor:
    """(..., E, C, D) -> (..., E, C, D) through each expert's gated FFN."""
    up = torch.einsum("...ecd,edf->...ecf", expert_in, p["w_up"])
    gate = cnn.act_fn(cfg.ffn_act)(
        torch.einsum("...ecd,edf->...ecf", expert_in, p["w_gate"]))
    return torch.einsum("...ecf,efd->...ecd", gate * up, p["w_down"])


def aux_losses(probs, top_i, keep) -> dict:
    """probs (..., E), top_i (..., k), keep (..., k): means over every
    token."""
    e = probs.shape[-1]
    probs = probs.reshape(-1, e)
    me = settle(probs.mean(dim=0))
    ce = settle(nn.functional.one_hot(top_i[..., 0].reshape(-1),
                                      e).float().mean(0))
    z = torch.logsumexp(torch.log(torch.clamp_min(probs, 1e-20)), dim=-1)
    return {"moe_lb_loss": e * torch.sum(me * ce),
            "moe_z_loss": settle(z.square().mean()),
            "moe_drop_frac": settle(1.0 - keep.float().mean())}


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple:
    """x (B, S, D) -> (y (B, S, D), aux dict). Grouped GShard dispatch; with
    ``moe_group_tokens`` g (dividing S, below it) each row splits into
    groups of g tokens."""
    b0, s0, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    g = cfg.moe_group_tokens
    xg = x.reshape(b0 * (s0 // g), g, d) if g and g < s0 and s0 % g == 0 \
        else x
    xg = constrain_batch(xg)
    s = xg.shape[1]
    logits = xg.float() @ p["router"].float()
    top_w, top_i, probs = router_topk(logits, k)
    cap = group_capacity(s, cfg)
    dispatch, combine, keep = routing_tensors(top_w, top_i, xg.dtype, e, cap)
    expert_in = constrain_batch(torch.einsum("bsec,bsd->becd", dispatch, xg))
    expert_out = constrain_batch(experts_ffn(p, cfg, expert_in))
    y = constrain_batch(torch.einsum("bsec,becd->bsd", combine, expert_out)
                        ).reshape(b0, s0, d)
    if cfg.n_shared_experts:
        y = y + ffn_apply(p["shared"], x, cfg.ffn_act)
    return y, aux_losses(probs, top_i, keep)
