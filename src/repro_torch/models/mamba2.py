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


def _heads_from_groups(t: torch.Tensor, h: int, g: int) -> torch.Tensor:
    """(B,S,G,N) -> (B,S,H,N) by repeating each group across its heads."""
    b, s, _, n = t.shape
    return t[:, :, :, None].expand(b, s, g, h // g, n).reshape(b, s, h, n)


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


def mamba_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                return_state: bool = False):
    """Full-sequence Mamba2. x (B,S,D) -> y (B,S,D) [, {"conv_x", "conv_bc",
    "state"}]: the last width - 1 rows of each conv's input (x's dtype) and
    the final SSM state (f32)."""
    b, s, _ = x.shape
    h, p_dim, g, n = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_n_groups,
                      cfg.ssm_state)
    di, w = cfg.d_inner, cfg.ssm_conv
    z = x @ p["in_z"]
    x_raw = x @ p["in_x"]
    bc_raw = x @ p["in_bc"]
    dt_raw = x @ p["in_dt"]
    xs = _causal_conv(p["conv_x_w"], p["conv_x_b"], x_raw, w).reshape(
        b, s, h, p_dim)
    bc = _causal_conv(p["conv_bc_w"], p["conv_bc_b"], bc_raw, w)
    B_ = _heads_from_groups(bc[..., : g * n].reshape(b, s, g, n), h, g)
    C_ = _heads_from_groups(bc[..., g * n:].reshape(b, s, g, n), h, g)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, final_state = ssd_scan(xs, dt, A, B_, C_, chunk=cfg.ssm_chunk)
    y = y + p["D"][None, None, :, None] * xs.float()
    y = y.reshape(b, s, di).to(x.dtype)
    # gated RMS norm (mamba2's RMSNormGated): gate, then normalize
    y = cnn.rmsnorm(y * F.silu(z), p["norm"]["scale"], eps=cfg.norm_eps)
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
    written in place."""
    b = x.shape[0]
    h, p_dim, g, n = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_n_groups,
                      cfg.ssm_state)
    di = cfg.d_inner
    x0 = x[:, 0]
    z, x_new, bc_new, dt_raw = (x0 @ p["in_z"], x0 @ p["in_x"],
                                x0 @ p["in_bc"], x0 @ p["in_dt"])
    cx, cbc = cache["conv_x"], cache["conv_bc"]
    win_x = torch.cat([cx, x_new[:, None].to(cx.dtype)], dim=1)
    win_bc = torch.cat([cbc, bc_new[:, None].to(cbc.dtype)], dim=1)
    xs = F.silu(_window_conv(win_x, p["conv_x_w"]) + p["conv_x_b"])
    bc = F.silu(_window_conv(win_bc, p["conv_bc_w"]) + p["conv_bc_b"])
    xs = xs.reshape(b, h, p_dim).float()
    rep = h // g
    B_h = bc[..., : g * n].reshape(b, g, 1, n).expand(b, g, rep, n).reshape(
        b, h, n).float()
    C_h = bc[..., g * n:].reshape(b, g, 1, n).expand(b, g, rep, n).reshape(
        b, h, n).float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A[None, :])  # (B,H)
    state = cache["state"] * decay[:, :, None, None] \
        + torch.einsum("bh,bhn,bhp->bhnp", dt, B_h, xs)
    y = torch.einsum("bhn,bhnp->bhp", C_h, state) + p["D"][None, :, None] * xs
    y = y.reshape(b, di).to(x.dtype)
    y = cnn.rmsnorm(y * F.silu(z), p["norm"]["scale"], eps=cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None]
    cx.copy_(win_x[:, 1:])
    cbc.copy_(win_bc[:, 1:])
    cache["state"].copy_(state)
    return out, cache
