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

On DTensors each rank routes its own batch rows and runs its own experts
(``_by_rank``), the reference's GSPMD layout: tokens over the data axes,
experts over ``model``. The expert-parallel scatter form over
``torch.distributed`` is ``models/moe_sharded.py``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.common import nn as cnn
from repro_torch.configs.base import ModelConfig
from repro_torch.models.ffn import FFN, ffn_apply
from repro_torch.models.sharding import settle


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


def _gshard(p: dict, cfg: ModelConfig, xg: torch.Tensor, first: int = 0,
            f_group=None) -> tuple:
    """Routing, dispatch, experts and combine over the groups ``xg`` (G, S,
    D), the experts ``first ..`` as many as ``p``'s weights hold (all by
    default). With ``f_group`` the weights hold this rank's share of the
    FFN dim: the dispatched rows of every rank of that process group run
    through them, and each rank gets back its own rows' sum over the
    group (``_stationary``). -> (y (G, S, D), probs, top_i, keep)."""
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    logits = xg.float() @ p["router"].float()
    top_w, top_i, probs = router_topk(logits, k)
    cap = group_capacity(xg.shape[1], cfg)
    dispatch, combine, keep = routing_tensors(top_w, top_i, xg.dtype, e, cap)
    el = p["w_up"].shape[0]
    if el != e:
        dispatch = dispatch[:, :, first: first + el]
        combine = combine[:, :, first: first + el]
    expert_in = torch.einsum("bsec,bsd->becd", dispatch, xg)
    if f_group is None:
        expert_out = experts_ffn(p, cfg, expert_in)
    else:
        expert_out = _stationary(p, cfg, expert_in, f_group)
    y = torch.einsum("bsec,becd->bsd", combine, expert_out)
    return y, probs, top_i, keep


def _stationary(p: dict, cfg: ModelConfig, expert_in: torch.Tensor,
                group) -> torch.Tensor:
    """``experts_ffn`` on weights that hold this rank's share of the FFN
    dim (the serving layout): the dispatched rows (G, E, C, D) of the
    group's ranks gathered, each rank's share of every row's FFN, and the
    partial outputs summed back onto the rows' own rank."""
    from repro_torch.common.mesh import gather_rows, scatter_rows

    return scatter_rows(experts_ffn(p, cfg, gather_rows(expert_in, group)),
                        group)


def _by_rank(p: dict, cfg: ModelConfig, x, gt: int):
    """``_gshard`` over groups of ``gt`` tokens of ``x`` on DTensors, through
    ``sharding.shard_map``: each rank routes its own batch rows (over the
    data axes as ``x`` holds them; a row's groups are the rank's) and runs
    its own experts (over ``model`` where they divide it, else every
    expert on every rank), and the ranks' partial outputs are summed over
    ``model``. -> (y (B, S, D), probs, top_i, keep), the last three by
    group. DTensor would otherwise flatten a sharded expert dim with
    another inside the dispatch, expert and combine einsums, which torch's
    view rule refuses before 2.13.

    Where the expert weights' FFN dim lies over one data axis (the
    serving layout, ``moe_shard_ffn_dim``), the weights or the tokens
    move, whichever is fewer bytes, as the reference's partitioner
    chooses: the tokens (``_stationary``) when the dispatched rows of that
    axis weigh less than the expert weights (a decode step), else the
    weights, gathered whole there (a long prefill; in the training layout
    always)."""
    from repro_torch.common.mesh import psum
    from repro_torch.models import sharding

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    m_dim = names.index(sharding.MODEL) if sharding.MODEL in names else None
    nm = mesh.size(m_dim) if m_dim is not None else 1
    split = nm > 1 and cfg.n_experts % nm == 0
    ex = sharding.MODEL if split else None
    ws = ("w_up", "w_gate", "w_down")
    row_spec = (sharding.rows_of(x), None, None)
    f_ax = sharding.spec_of(p["w_up"])[2]
    if isinstance(f_ax, str) and _tokens_move(cfg, x, gt, mesh, nm, f_ax,
                                             p["w_up"].element_size()):
        w_specs = ((ex, None, f_ax), (ex, None, f_ax), (ex, f_ax, None))
        f_group = mesh.get_group(names.index(f_ax))
    else:
        w_specs = ((ex, None, None),) * 3
        f_group = None

    def local(xl, router, *w):
        first = mesh.get_coordinate()[m_dim] * w[0].shape[0] if split else 0
        y, probs, top_i, keep = _gshard(
            {"router": router, **dict(zip(ws, w))}, cfg,
            xl.reshape(-1, gt, xl.shape[-1]), first, f_group)
        y = y.reshape(xl.shape)
        if split:
            y = psum(y, mesh.get_group(m_dim))
        return y, probs, top_i, keep

    return sharding.shard_map(
        local, mesh, (row_spec, (None, None), *w_specs),
        (row_spec,) * 4)(x, p["router"], *(p[w] for w in ws))


def _tokens_move(cfg: ModelConfig, x, gt: int, mesh, nm: int, f_ax: str,
                 w_bytes: int) -> bool:
    """Whether a rank's dispatched rows (groups of ``gt`` tokens), gathered
    over the data axis ``f_ax`` and their outputs scattered back, are
    fewer bytes than the three expert weights gathered whole over it."""
    from repro_torch.models import sharding

    b, s, d = x.shape
    n_rows = 1
    rows = sharding.rows_of(x)
    for a in (rows if isinstance(rows, tuple) else (rows,) if rows else ()):
        n_rows *= mesh.size(mesh.mesh_dim_names.index(a))
    el = cfg.n_experts // nm if cfg.n_experts % nm == 0 else cfg.n_experts
    n_f = mesh.size(mesh.mesh_dim_names.index(f_ax))
    tokens = 2 * (b // n_rows) * (s // gt) * n_f * el \
        * group_capacity(gt, cfg) * d
    return tokens * x.element_size() < 3 * el * d * cfg.moe_d_ff * w_bytes
def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple:
    """x (B, S, D) -> (y (B, S, D), aux dict). Grouped GShard dispatch; with
    ``moe_group_tokens`` g (dividing S, below it) each row splits into
    groups of g tokens. On DTensors it runs per rank (``_by_rank``)."""
    from torch.distributed.tensor import DTensor

    b0, s0, d = x.shape
    g = cfg.moe_group_tokens
    gt = g if g and g < s0 and s0 % g == 0 else s0  # tokens a group
    if isinstance(x, DTensor):
        y, probs, top_i, keep = _by_rank(p, cfg, x, gt)
    else:
        y, probs, top_i, keep = _gshard(p, cfg, x.reshape(-1, gt, d))
        y = y.reshape(b0, s0, d)
    if cfg.n_shared_experts:
        y = y + ffn_apply(p["shared"], x, cfg.ffn_act)
    return y, aux_losses(probs, top_i, keep)
