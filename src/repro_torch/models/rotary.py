"""Rotary and sinusoidal position embeddings.

Port of ``repro.models.rotary``. ``apply_rope`` supports partial rotary
(stablelm rotates only the first 25% of head_dim) in the half-split
("neox") layout used by every assigned arch; the rotation is computed in
f32 and cast back to the input's dtype.
"""
from __future__ import annotations

import math

import torch


def rotary_dims(head_dim: int, rotary_pct: float) -> int:
    """``int(head_dim · pct)`` rounded down to even."""
    rot = int(head_dim * rotary_pct)
    return rot - (rot % 2)


def rope_freqs(head_dim: int, rotary_pct: float, theta: float,
               device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated sub-dimension. (rot/2,) f32."""
    rot = rotary_dims(head_dim, rotary_pct)
    return 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                         device=device) / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               rotary_pct: float = 1.0, theta: float = 10000.0
               ) -> torch.Tensor:
    """x: (..., S, H, head_dim) or (..., S, head_dim); positions: (..., S)."""
    head_dim = x.shape[-1]
    rot = rotary_dims(head_dim, rotary_pct)
    if rot == 0:
        return x
    freqs = rope_freqs(head_dim, rotary_pct, theta, device=x.device)
    ang = positions.float()[..., None] * freqs  # (..., S, rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() == positions.dim() + 2:  # insert head axis
        cos, sin = cos[..., None, :], sin[..., None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.cat([r1, r2], dim=-1).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < head_dim else out


def sinusoidal(positions: torch.Tensor, dim: int,
               max_scale: float = 10000.0) -> torch.Tensor:
    """Classic sin/cos absolute position table. positions (..., S) ->
    (..., S, dim) f32."""
    half = dim // 2
    freq = torch.exp(-math.log(max_scale)
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
