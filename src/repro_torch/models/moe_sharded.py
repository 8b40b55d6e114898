"""Scatter-based expert-parallel MoE over ``torch.distributed``.

Port of ``repro.models.moe_sharded.moe_apply_sharded``, whose ``shard_map``
becomes one process per rank of a ``DeviceMesh`` with a ``model``
dimension and one or more data dimensions (``batch_axes``; a ``(data,
model)`` mesh puts rank ``d · n_model + m`` at data index d and model index
m, the row-major order of the reference's device mesh):

  * tokens are split over the data dimensions and REPLICATED over
    ``model``: every model rank of data shard d holds rows ``d·B_l ..
    (d+1)·B_l`` of the batch (``shard_rows``) and computes the same
    routing;
  * model rank m owns experts ``m·E_loc .. (m+1)·E_loc`` (E_loc = E /
    n_model), their weights further split over the data shards as the
    reference's in-specs split them: ``w_up``/``w_gate`` (E_loc, D /
    n_data, F) and ``w_down`` (E_loc, F, D / n_data), both along D
    (``shard_params``); an ``all_gather`` over the data dimensions
    assembles them;
  * a scatter-add builds the (E_loc + 1, C + 1, D) expert inputs, whose
    last expert and last slot are drop bins; the expert FFN; each
    assignment's output is gathered back and weighted; one ``all_reduce``
    (sum) over ``model`` combines the ranks' partial outputs; the shared
    expert is added after it.

Capacity is ``max(4, group_capacity((B / n_data) · S))`` per expert: one
group per data shard, where ``moe.moe_apply`` makes one per batch row, so
the two drop different assignments once anything drops. The load-balance
and z losses are means over every token of the batch (the probabilities
and first choices are gathered over the data dimensions).
``moe_drop_frac`` keeps the reference's quirk: its ``shard_map`` returns
each device's own value under a replicated, unchecked out-spec, and
reading the result gives the first device's, data shard 0's; every rank
returns that one here.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.common import nn as cnn
from repro_torch.configs.base import ModelConfig
from repro_torch.models.ffn import ffn_apply
from repro_torch.models.sharding import settle
from repro_torch.models.moe import (expert_positions, group_capacity,
                                    router_topk)
from repro_torch.common.mesh import gather_shards, mesh_shard, psum


def shard_params(p: dict, cfg: ModelConfig, *, data_shard: int, n_data: int,
                 model_rank: int, n_model: int) -> dict:
    """The share of a whole MoE layer's parameters (``router``, ``w_up``,
    ``w_gate``, ``w_down``, ``shared``) that the rank at (data shard,
    model rank) holds: its experts' weights sliced along D by its data
    shard, the router and the shared expert whole."""
    e, d = cfg.n_experts, cfg.d_model
    if e % n_model or d % n_data:
        raise ValueError(f"{e} experts over {n_model} model ranks, d_model "
                         f"{d} over {n_data} data shards: not divisible")
    el, dl = e // n_model, d // n_data
    ex = slice(model_rank * el, (model_rank + 1) * el)
    dx = slice(data_shard * dl, (data_shard + 1) * dl)
    out = {"router": p["router"],
           "w_up": p["w_up"][ex, dx].contiguous(),
           "w_gate": p["w_gate"][ex, dx].contiguous(),
           "w_down": p["w_down"][ex, :, dx].contiguous()}
    if "shared" in p:
        out["shared"] = p["shared"]
    return out


def mesh_share(p: dict, cfg: ModelConfig, mesh, *, batch_axes=("data",),
               model_axis: str = "model") -> dict:
    """``shard_params`` for this rank's place in ``mesh``."""
    n_data, shard = mesh_shard(mesh, batch_axes)
    n_model, m = mesh_shard(mesh, (model_axis,))
    return shard_params(p, cfg, data_shard=shard, n_data=n_data,
                        model_rank=m, n_model=n_model)


class _GatherData(torch.autograd.Function):
    """``gather_shards`` over the data dimensions; its backward sums the
    gradient over them and keeps this shard's part (the transpose of the
    reference's tiled ``all_gather``)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim, ctx.size = mesh, axes, dim, x.shape[dim]
        ctx.shard = mesh_shard(mesh, axes)[1]
        return gather_shards(x, mesh, axes, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        for a in ctx.axes:
            if ctx.mesh.size(ctx.mesh.mesh_dim_names.index(a)) > 1:
                dist.all_reduce(g, group=ctx.mesh.get_group(a))
        return (g.narrow(ctx.dim, ctx.shard * ctx.size, ctx.size), None, None,
                None)


def _local_experts(p: dict, cfg: ModelConfig, x: torch.Tensor, mesh,
                   batch_axes, model_axis: str) -> tuple:
    """The per-rank body: routing of this data shard's tokens (alike on
    its model ranks), this model rank's experts, their outputs summed over
    ``model``. -> (y (B_l, S, D), probs (T, E) f32, top_i (T, k), keep
    (T, k)). Differentiable: the weights' gather over the data dimensions
    and the sum over ``model`` carry their transposes."""
    bl, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    n_model, model_rank = mesh_shard(mesh, (model_axis,))
    if e % n_model:
        raise ValueError(f"{e} experts do not split over {n_model} model "
                         f"ranks")
    e_loc = e // n_model
    t = bl * s
    cap = max(4, group_capacity(max(1, t), cfg))  # per expert, per shard
    xt = x.reshape(t, d)
    logits = xt.float() @ p["router"].float()
    top_w, top_i, probs = router_topk(logits, k)  # (T, k)

    # this rank's experts' whole weights (ZeRO-3 style)
    w_up = _GatherData.apply(p["w_up"], mesh, batch_axes, 1)
    w_gate = _GatherData.apply(p["w_gate"], mesh, batch_axes, 1)
    w_down = _GatherData.apply(p["w_down"], mesh, batch_axes, 2)

    pos, keep = expert_positions(top_i, e, cap)
    e0 = model_rank * e_loc
    mine = (top_i >= e0) & (top_i < e0 + e_loc) & keep
    e_local = torch.where(mine, top_i - e0, e_loc).reshape(-1)
    pos_c = torch.where(mine, pos, cap).reshape(-1)
    buf = torch.zeros((e_loc + 1, cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((e_local, pos_c), xt.repeat_interleave(k, dim=0),
                        accumulate=True)
    expert_in = buf[:e_loc, :cap]
    up = torch.einsum("ecd,edf->ecf", expert_in, w_up)
    gate = cnn.act_fn(cfg.ffn_act)(
        torch.einsum("ecd,edf->ecf", expert_in, w_gate))
    expert_out = nn.functional.pad(
        torch.einsum("ecf,efd->ecd", gate * up, w_down), (0, 0, 0, 1, 0, 1))
    out_rows = expert_out[e_local, pos_c].reshape(t, k, d)
    w_eff = (top_w * mine.float()).to(x.dtype)
    y = torch.einsum("tkd,tk->td", out_rows, w_eff)
    if n_model > 1:
        y = psum(y, mesh.get_group(model_axis))
    return y.reshape(bl, s, d), probs, top_i, keep


def _aux(probs, top0, drop) -> dict:
    """The load-balance and z losses over every token, and the drop
    share."""
    e = probs.shape[-1]
    # on a mesh each mean is settled before the product (torch before 2.13
    # cannot turn one partial mean into another's partial sum)
    me = settle(probs.mean(dim=0))
    ce = settle(nn.functional.one_hot(top0, e).float().mean(dim=0))
    z = torch.logsumexp(torch.log(torch.clamp_min(probs, 1e-20)), dim=-1)
    return {"moe_lb_loss": e * torch.sum(me * ce),
            "moe_z_loss": settle(z.square().mean()), "moe_drop_frac": drop}


def _shard0_drop(keep: torch.Tensor, mesh, batch_axes) -> torch.Tensor:
    """Data shard 0's dropped share, on every rank (the reference reads
    the first device's)."""
    return gather_shards((1.0 - keep.float().mean()).reshape(1), mesh,
                         batch_axes)[0]


def moe_apply_sharded(p: dict, cfg: ModelConfig, x: torch.Tensor, mesh=None,
                      *, batch_axes=("data",), model_axis: str = "model"
                      ) -> tuple:
    """``moe.moe_apply`` with expert parallelism, called on every rank of
    ``mesh`` alike. -> (y, aux dict), the aux equal on every rank.

    With plain tensors: ``p`` is this rank's share (``mesh_share``), x its
    data shard's rows (B / n_data, S, D), y the same rows. With DTensors
    (the whole layer's parameters and x (B, S, D) on ``mesh``, or on x's
    mesh when ``mesh`` is None), ``_moe_mesh`` runs the same body through
    ``local_map`` and y is a DTensor (B, S, D)."""
    from torch.distributed.tensor import DTensor

    axes = batch_axes if isinstance(batch_axes, tuple) else (batch_axes,)
    if isinstance(x, DTensor):
        return _moe_mesh(p, cfg, x, mesh or x.device_mesh, axes, model_axis)
    y, probs, top_i, keep = _local_experts(p, cfg, x, mesh, axes, model_axis)
    if "shared" in p:
        y = y + ffn_apply(p["shared"], x, cfg.ffn_act)
    probs = gather_shards(probs, mesh, axes)
    top0 = gather_shards(top_i[:, 0].contiguous(), mesh, axes)
    return y, _aux(probs, top0, _shard0_drop(keep, mesh, axes))


def _moe_mesh(p: dict, cfg: ModelConfig, x, mesh, axes: tuple,
              model_axis: str) -> tuple:
    """The DTensor route: ``sharding.shard_map`` of ``_local_experts`` with
    the reference's specs (x over the data axes and whole over ``model``;
    the router whole; the experts over ``model`` and d_model over the data
    axes), then the aux and the shared expert on the DTensors, as the
    reference computes them outside its ``shard_map``."""
    from repro_torch.models import sharding

    bspec = axes if len(axes) > 1 else axes[0]

    def local(xl, router, w_up, w_gate, w_down):
        y, probs, top_i, keep = _local_experts(
            {"router": router, "w_up": w_up, "w_gate": w_gate,
             "w_down": w_down}, cfg, xl, mesh, axes, model_axis)
        return y, probs, top_i, _shard0_drop(keep, mesh, axes)

    y, probs, top_i, drop = sharding.shard_map(
        local, mesh,
        in_specs=((bspec, None, None), (), (model_axis, bspec, None),
                  (model_axis, bspec, None), (model_axis, None, bspec)),
        out_specs=((bspec, None, None), (bspec, None), (bspec, None), ()),
    )(x, p["router"], p["w_up"], p["w_gate"], p["w_down"])
    if "shared" in p:
        y = y + ffn_apply(p["shared"], x, cfg.ffn_act)
    return y, _aux(probs, top_i[:, 0], drop)
