"""Feed-forward variants: gated (SwiGLU/GeGLU) and plain MLP.

Port of ``repro.models.ffn``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.common import nn as cnn

GATED = ("silu", "gelu")


class FFN(nn.Module):
    """``w_up``, ``w_down`` and, for a gated activation, ``w_gate``; each
    stored (in, out) as in the JAX parameter dict."""

    def __init__(self, d_model: int, d_ff: int, act: str, *,
                 generator: torch.Generator):
        super().__init__()
        self.w_up = nn.Parameter(cnn.lecun_normal((d_model, d_ff), generator))
        self.w_down = nn.Parameter(cnn.lecun_normal((d_ff, d_model), generator,
                                                    fan_in=d_ff))
        if act in GATED:
            self.w_gate = nn.Parameter(cnn.lecun_normal((d_model, d_ff),
                                                        generator))


def ffn_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """``act(x @ w_gate) * (x @ w_up)`` (gated) or ``act(x @ w_up)``
    (``gelu_mlp``: tanh GELU), then ``@ w_down``. ``p`` holds the tensors
    by the JAX names."""
    up = x @ p["w_up"]
    if "w_gate" in p:
        up = cnn.act_fn(act)(x @ p["w_gate"]) * up
    else:
        up = cnn.act_fn("gelu" if act == "gelu_mlp" else act)(up)
    return up @ p["w_down"]
