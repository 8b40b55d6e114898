"""Mamba2 (SSD — state-space duality) layer: chunked scan + one-step decode.

Port of ``repro.models.mamba2``. The forward pass is the SSD chunked
algorithm (Dao & Gu 2024, §6): the sequence splits into chunks of length
L; within a chunk the recurrence is evaluated as a masked, decay-weighted
attention-like product, and the chunk-final states are carried from one
chunk to the next (a Python loop over chunks where the reference scans), so
memory is O(B·H·L²) per chunk instead of O(B·H·S²). All of the scan's math
is f32.

The depthwise conv is split into an x-conv and a (B, C)-conv, as in the
reference (the same as one fused conv, channel by channel).

Decode carries (conv_x, conv_bc, state) and costs O(1) per token. The
port's decode writes its cache in place: each conv window shifts by one
row, the state is overwritten.

``Mamba`` holds the parameters under the reference's leaf names; the
functions run on plain dicts of tensors by those names. ``A_log``, ``D``
and ``dt_bias`` stay f32 under mixed precision (``lm._KEEP_F32``).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.common import nn as cnn
from repro_torch.configs.base import ModelConfig


class Mamba(nn.Module):
    """``in_z``/``in_x`` (d, d_inner), ``in_bc`` (d, 2·G·N), ``in_dt`` (d, H),
    the two depthwise convs (``conv_*_w`` (width, C), ``conv_*_b`` (C,)),
    ``A_log``, ``D``, ``dt_bias`` (H,), the gated norm ``norm.scale``
    (d_inner,) and ``out_proj`` (d_inner, d), drawn from ``generator`` with
    the reference's laws: dt log-uniform in [1e-3, 0.1] through the inverse
    softplus, ``A_log = log(linspace(1, 16, H))``, ``D = 1``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__()
        d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
        gn2 = 2 * cfg.ssm_n_groups * cfg.ssm_state
        g, dev = generator, generator.device
        dt = torch.exp(cnn.uniform(h, g)
                       * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        conv_std = 1.0 / math.sqrt(cfg.ssm_conv)
        self.in_z = nn.Parameter(cnn.lecun_normal((d, di), g))
        self.in_x = nn.Parameter(cnn.lecun_normal((d, di), g))
        self.in_bc = nn.Parameter(cnn.lecun_normal((d, gn2), g))
        self.in_dt = nn.Parameter(cnn.lecun_normal((d, h), g))
        self.conv_x_w = nn.Parameter(cnn.trunc_normal((cfg.ssm_conv, di),
                                                      conv_std, g))
        self.conv_x_b = nn.Parameter(torch.zeros(di, device=dev))
        self.conv_bc_w = nn.Parameter(cnn.trunc_normal((cfg.ssm_conv, gn2),
                                                       conv_std, g))
        self.conv_bc_b = nn.Parameter(torch.zeros(gn2, device=dev))
        self.A_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, h,
                                                           device=dev)))
        self.D = nn.Parameter(torch.ones(h, device=dev))
        self.dt_bias = nn.Parameter(dt + torch.log(-torch.expm1(-dt)))
        self.norm = cnn.RMSNorm(di, eps=cfg.norm_eps, device=dev)
        self.out_proj = nn.Parameter(cnn.lecun_normal((di, d), g, fan_in=di))


def _causal_conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                 width: int) -> torch.Tensor:
    """Depthwise causal conv along S, summed tap by tap in the reference's
    order. x (B,S,C), w (width,C)."""
    pad = F.pad(x, (0, 0, width - 1, 0))
    s = x.shape[1]
    out = sum(pad[:, i: i + s] * w[i] for i in range(width))
    return F.silu(out + b)


def _heads_from_groups(t: torch.Tensor, h: int, g: int,
                       heads: torch.Tensor | None = None) -> torch.Tensor:
    """(..., G, N) -> (..., H, N) by repeating each group across its h // g
    heads; with ``heads`` (head ids) only those heads, (..., len, N)."""
    if heads is not None:
        return t.index_select(-2, heads // (h // g))
    *lead, _, n = t.shape
    return t[..., None, :].expand(*lead, g, h // g, n).reshape(*lead, h, n)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor, *, chunk: int,
             state_in: torch.Tensor | None = None) -> tuple:
    """The SSD chunked recurrence.

    x (B,S,H,P); dt (B,S,H) post-softplus; A (H,) negative; B_, C_
    (B,S,H,N). The chunk is ``min(chunk, S)`` and must divide S (a
    ``ValueError`` otherwise; nothing is padded). Returns (y (B,S,H,P),
    final_state (B,H,N,P)), all f32.

    The intra-chunk decay exp(seg_l - seg_m) is masked before the exp
    (-inf above the diagonal, so exp gives 0 there). The reference
    exponentiates first and masks after: above the diagonal the exponent
    is a positive sum of |dt·A| that passes f32's range once it exceeds
    ≈ 88, and the backward then multiplies a zero cotangent by inf, a NaN
    in the gradient with respect to dt (ROADMAP Queue 3). The forward's
    values are the same either way.
    """
    b, s, h, p_dim = x.shape
    n = B_.shape[-1]
    L = min(chunk, s)
    if s % L:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"SSD chunk {L}")
    nc = s // L
    f32 = torch.float32
    xc = x.to(f32).reshape(b, nc, L, h, p_dim)
    dtc = dt.to(f32).reshape(b, nc, L, h)
    Bc = B_.to(f32).reshape(b, nc, L, h, n)
    Cc = C_.to(f32).reshape(b, nc, L, h, n)
    dA = dtc * A  # (B,nc,L,H) log-decay, <= 0
    state = (torch.zeros((b, h, n, p_dim), dtype=f32, device=x.device)
             if state_in is None else state_in.to(f32))
    idx = torch.arange(L, device=x.device)
    causal = idx[:, None] >= idx[None, :]  # (L, L) l >= m
    ys = []
    for c in range(nc):
        x_c, dt_c, b_c, c_c = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        seg = torch.cumsum(dA[:, c], dim=1)  # (B,L,H)
        lam = torch.exp(seg[:, -1])  # (B,H) whole-chunk decay
        # intra-chunk: M[l,m] = C[l]·B[m] · exp(seg l - seg m) · dt[m],
        # m <= l; the exponent is masked to -inf above the diagonal before
        # the exp, where it is positive and may overflow to inf
        cb = torch.einsum("blhn,bmhn->bhlm", c_c, b_c)
        seg_t = seg.transpose(1, 2)  # (B,H,L)
        decay = torch.exp(torch.where(
            causal, seg_t[:, :, :, None] - seg_t[:, :, None, :],
            -torch.inf))
        m_mat = cb * decay * dt_c.transpose(1, 2)[:, :, None, :]
        y_intra = torch.einsum("bhlm,bmhp->blhp", m_mat, x_c)
        # inter-chunk: contribution of the incoming state
        y_inter = torch.einsum("blhn,bhnp,blh->blhp", c_c, state,
                               torch.exp(seg))
        # chunk-final state
        w_st = torch.exp(seg[:, -1:, :] - seg) * dt_c  # (B,L,H)
        state = lam[:, :, None, None] * state \
            + torch.einsum("blh,blhn,blhp->bhnp", w_st, b_c, x_c)
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=1).reshape(b, s, h, p_dim), state


def _by_rank(fn, h: int, chans: tuple, chan_params: tuple, acts: tuple,
             params: tuple, state=None):
    """``fn(*chans, *chan_params, *acts, *params[, state], heads, group)``
    -> (y, state) over the ``h`` SSM heads, ``heads`` and ``group`` None
    for every head in this process. ``chans`` are the activations (batch
    first) over the x stream's channels (h·P, heads major), last;
    ``chan_params`` the parameters over those channels, last; ``acts`` the
    other activations (dt, the B/C stream; batch first); ``params`` the
    other parameters.

    On DTensors each rank runs ``fn`` on its own batch rows and heads
    through ``sharding.shard_map``: the rows over the data axes as
    ``chans[0]`` holds them, the heads over ``model`` where they divide it
    (``chans``' and ``y``'s channels and the state's heads there, and
    ``group`` the ``model`` group, over which a sum across channels is
    taken), else whole on every rank; ``acts`` and ``params`` stay whole
    over ``model``, each rank picking its heads by id. DTensor would
    otherwise flatten the batch dim with the sharded head dim inside the
    scan's and the state's einsums, which torch's view rule refuses before
    2.13, and torch 2.11 cannot redistribute a padded conv input."""
    from torch.distributed.tensor import DTensor

    st = () if state is None else (state,)
    if not isinstance(chans[0], DTensor):
        return fn(*chans, *chan_params, *acts, *params, *st, None, None)
    from repro_torch.models import sharding

    # the activations' gradients leave whole over ``model`` (``whole``),
    # their partial sums reduced: left partial, torch 2.13's DTensor
    # scatters them over the rows of the input products' backward, and
    # then refuses to view those rows back (``zamba2``'s step on (2, 4))
    acts = tuple(sharding.whole(a) for a in acts)

    mesh = chans[0].device_mesh
    names = mesh.mesh_dim_names
    bax = sharding.rows_of(chans[0])
    m_dim = names.index(sharding.MODEL) if sharding.MODEL in names else None
    nm = mesh.size(m_dim) if m_dim is not None else 1
    split = nm > 1 and h % nm == 0
    hax = sharding.MODEL if split else None
    x_spec = (bax, *([None] * (chans[0].ndim - 2)), hax)
    st_spec = (bax, hax, None, None)
    specs = (*([x_spec] * len(chans)),
             *((*([None] * (c.ndim - 1)), hax) for c in chan_params),
             *((bax, *([None] * (a.ndim - 1))) for a in acts),
             *((None,) * p.ndim for p in params),
             *((st_spec,) if st else ()))

    def local(*args):
        hl = h // nm if split else h
        h0 = mesh.get_coordinate()[m_dim] * hl if split else 0
        return fn(*args, h0 + torch.arange(hl, device=args[0].device),
                  mesh.get_group(m_dim) if split else None)

    return sharding.shard_map(local, mesh, specs, (x_spec, st_spec))(
        *chans, *chan_params, *acts, *params, *st)


def _pick(heads, *per_head):
    """Each of ``per_head`` (..., H) at ``heads`` (all where None)."""
    if heads is None:
        return per_head
    return tuple(t.index_select(-1, heads) for t in per_head)


def _gated_norm(y, z, scale, *, eps: float, dtype, group=None):
    """mamba2's RMSNormGated: ``y`` cast to ``dtype``, gated by silu(z),
    then RMS-normalized over its channels. With ``group`` the channels are
    this rank's share of the whole, and the mean square is summed over
    the group's ranks."""
    y = y.to(dtype) * F.silu(z)
    if group is None:
        return cnn.rmsnorm(y, scale, eps=eps)
    import torch.distributed as dist

    from repro_torch.common.mesh import psum

    yf = y.float()
    var = psum(yf.square().sum(dim=-1, keepdim=True), group) \
        / (yf.shape[-1] * dist.get_world_size(group))
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def mamba_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                return_state: bool = False):
    """Full-sequence Mamba2. x (B,S,D) -> y (B,S,D) [, {"conv_x", "conv_bc",
    "state"}]: the last width - 1 rows of each conv's input (x's dtype) and
    the final SSM state (f32). From the convs to the gated norm it runs
    per rank on DTensors (``_by_rank``)."""
    s = x.shape[1]
    h, p_dim, g, n = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_n_groups,
                      cfg.ssm_state)
    w = cfg.ssm_conv
    z = x @ p["in_z"]
    x_raw = x @ p["in_x"]
    bc_raw = x @ p["in_bc"]
    dt_raw = x @ p["in_dt"]

    def scan(x_raw, z, conv_x_w, conv_x_b, norm_scale, dt_raw, bc_raw,
             conv_bc_w, conv_bc_b, dt_bias, A_log, D, heads, group):
        bl, _, c = x_raw.shape
        x4 = _causal_conv(conv_x_w, conv_x_b, x_raw, w).reshape(
            bl, s, c // p_dim, p_dim)
        bc = _causal_conv(conv_bc_w, conv_bc_b, bc_raw, w)
        B_ = _heads_from_groups(bc[..., : g * n].reshape(bl, s, g, n), h, g,
                                heads)
        C_ = _heads_from_groups(bc[..., g * n:].reshape(bl, s, g, n), h, g,
                                heads)
        dt_raw, dt_bias, A_log, D = _pick(heads, dt_raw, dt_bias, A_log, D)
        dt = F.softplus(dt_raw.float() + dt_bias)
        A = -torch.exp(A_log)
        y, final_state = ssd_scan(x4, dt, A, B_, C_, chunk=cfg.ssm_chunk)
        y = y + D[None, None, :, None] * x4.float()
        return _gated_norm(y.reshape(bl, s, c), z, norm_scale,
                           eps=cfg.norm_eps, dtype=x.dtype,
                           group=group), final_state

    y, final_state = _by_rank(
        scan, h, (x_raw, z), (p["conv_x_w"], p["conv_x_b"],
                              p["norm"]["scale"]), (dt_raw, bc_raw),
        (p["conv_bc_w"], p["conv_bc_b"], p["dt_bias"], p["A_log"], p["D"]))
    out = y @ p["out_proj"]
    if not return_state:
        return out
    return out, {"conv_x": x_raw[:, s - (w - 1):],
                 "conv_bc": bc_raw[:, s - (w - 1):],
                 "state": final_state}


def mamba_make_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """conv windows (B, width - 1, C) in ``dtype``, the state (B,H,N,P)
    f32, all zeros."""
    gn2 = 2 * cfg.ssm_n_groups * cfg.ssm_state
    w = cfg.ssm_conv - 1
    return {
        "conv_x": torch.zeros((batch, w, cfg.d_inner), dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros((batch, w, gn2), dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                              cfg.ssm_head_dim), dtype=torch.float32,
                             device=device),
    }


def _window_conv(win: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bwc,wc->bc")`` summed in f32, in the operands' promoted
    dtype (JAX's ``einsum`` promotes a mixed pair, torch's refuses it)."""
    dt = torch.promote_types(win.dtype, w.dtype)
    return torch.einsum("bwc,wc->bc", win.float(), w.float()).to(dt)


def mamba_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: dict) -> tuple:
    """One-token step. x (B,1,D) -> (y (B,1,D), cache); the cache is
    written in place. From the state update to the gated norm it runs per
    rank on DTensors (``_by_rank``)."""
    h, p_dim, g, n = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_n_groups,
                      cfg.ssm_state)
    x0 = x[:, 0]
    z, x_new, bc_new, dt_raw = (x0 @ p["in_z"], x0 @ p["in_x"],
                                x0 @ p["in_bc"], x0 @ p["in_dt"])
    cx, cbc = cache["conv_x"], cache["conv_bc"]
    win_x = torch.cat([cx, x_new[:, None].to(cx.dtype)], dim=1)
    win_bc = torch.cat([cbc, bc_new[:, None].to(cbc.dtype)], dim=1)
    xs = F.silu(_window_conv(win_x, p["conv_x_w"]) + p["conv_x_b"])
    bc = F.silu(_window_conv(win_bc, p["conv_bc_w"]) + p["conv_bc_b"])

    def step(xs, z, norm_scale, dt_raw, bc, dt_bias, A_log, D, state, heads,
             group):
        bl, c = xs.shape
        x3 = xs.reshape(bl, c // p_dim, p_dim).float()
        B_h = _heads_from_groups(bc[..., : g * n].reshape(bl, g, n), h, g,
                                 heads).float()
        C_h = _heads_from_groups(bc[..., g * n:].reshape(bl, g, n), h, g,
                                 heads).float()
        dt_raw, dt_bias, A_log, D = _pick(heads, dt_raw, dt_bias, A_log, D)
        dt = F.softplus(dt_raw.float() + dt_bias)  # (B,H)
        A = -torch.exp(A_log)
        decay = torch.exp(dt * A[None, :])  # (B,H)
        state = state * decay[:, :, None, None] \
            + torch.einsum("bh,bhn,bhp->bhnp", dt, B_h, x3)
        y = torch.einsum("bhn,bhnp->bhp", C_h, state) \
            + D[None, :, None] * x3
        return _gated_norm(y.reshape(bl, c), z, norm_scale, eps=cfg.norm_eps,
                           dtype=x.dtype, group=group), state

    y, state = _by_rank(step, h, (xs, z), (p["norm"]["scale"],), (dt_raw, bc),
                        (p["dt_bias"], p["A_log"], p["D"]), cache["state"])
    out = (y @ p["out_proj"])[:, None]
    cx.copy_(win_x[:, 1:])
    cbc.copy_(win_bc[:, 1:])
    cache["state"].copy_(state)
    return out, cache
