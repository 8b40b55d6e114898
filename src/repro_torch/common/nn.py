"""The encoder/rewriter and language-model building blocks as
``nn.Module``s.

Port of ``repro.common.nn``: a linear layer whose weight keeps the JAX
layout ``(in, out)`` (so carried-across parameters load without a
transpose), a plain ReLU MLP, an embedding table, RMSNorm and LayerNorm
(both computing in f32 and casting back), the activations by name, and
the truncated-normal and LeCun initializers drawn from an explicit
``torch.Generator`` on that generator's device.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


class MetaDraws:
    """Stands for a ``torch.Generator`` when a model is built on the meta
    device: its tensors have shapes and dtypes and no values, so nothing is
    drawn (``torch.Generator`` has no meta device, and ``trunc_normal_``
    reads its draws back to the host, which fake tensors refuse)."""

    device = torch.device("meta")


def generator_on(device: torch.device, seed: int):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``, or
    ``MetaDraws`` on the meta device."""
    if device.type == "meta":
        return MetaDraws()
    return torch.Generator(device).manual_seed(seed)


def trunc_normal(shape, std: float, generator: torch.Generator
                 ) -> torch.Tensor:
    """std · N(0, 1) truncated to [-2, 2] (the JAX initializer's law),
    drawn from ``generator`` on its device (nothing is drawn on the meta
    device)."""
    t = torch.empty(shape, device=generator.device)
    if t.is_meta:
        return t
    nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                          generator=generator)
    return t.mul_(std)


def uniform(shape, generator: torch.Generator) -> torch.Tensor:
    """U[0, 1) from ``generator`` on its device (nothing drawn on meta)."""
    if generator.device.type == "meta":
        return torch.empty(shape, device="meta")
    return torch.rand(shape, generator=generator, device=generator.device)


def lecun_normal(shape, generator: torch.Generator,
                 fan_in: int | None = None) -> torch.Tensor:
    """``trunc_normal`` with std 1/sqrt(fan_in), fan_in ``shape[0]`` unless
    given."""
    fan_in = fan_in if fan_in is not None else shape[0]
    return trunc_normal(shape, 1.0 / math.sqrt(max(1, fan_in)), generator)


class Linear(nn.Module):
    """y = x @ w (+ b), w stored (in, out) like ``repro.common.nn.linear``."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = False,
                 generator: torch.Generator, std: float | None = None):
        super().__init__()
        std = std if std is not None else 1.0 / math.sqrt(max(1, in_dim))
        self.w = nn.Parameter(trunc_normal((in_dim, out_dim), std, generator))
        self.b = (nn.Parameter(torch.zeros(out_dim, device=generator.device))
                  if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        return y if self.b is None else y + self.b


class MLP(nn.Module):
    """Plain ReLU MLP; layer i is ``self.layers[i]`` (``l{i}`` in the JAX
    parameter dict)."""

    def __init__(self, dims: Sequence[int], *, generator: torch.Generator,
                 bias: bool = True):
        super().__init__()
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], bias=bias, generator=generator)
            for i in range(len(dims) - 1))

    def forward(self, x: torch.Tensor, *,
                final_activation: bool = False) -> torch.Tensor:
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1 or final_activation:
                x = torch.relu(x)
        return x


class Embedding(nn.Module):
    """A (vocab, dim) table, rows looked up by id (``embed/table`` in the
    JAX parameter dict)."""

    def __init__(self, vocab: int, dim: int, *, std: float,
                 generator: torch.Generator):
        super().__init__()
        self.table = nn.Parameter(trunc_normal((vocab, dim), std, generator))


# ---------------------------------------------------------------------------
# norms: computed in f32, cast back to the input's dtype
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float,
            zero_centered: bool = False) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    scale = scale.float()
    if zero_centered:  # gemma-style (1 + scale)
        scale = 1.0 + scale
    return (x * scale).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
              eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


class RMSNorm(nn.Module):
    """RMS norm over the last axis; ``zero_centered`` (gemma) starts the
    scale at 0 and multiplies by ``1 + scale``."""

    def __init__(self, dim: int, *, eps: float = 1e-6,
                 zero_centered: bool = False, device=None):
        super().__init__()
        self.eps, self.zero_centered = eps, zero_centered
        init = torch.zeros if zero_centered else torch.ones
        self.scale = nn.Parameter(init(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale, eps=self.eps,
                       zero_centered=self.zero_centered)


class LayerNorm(nn.Module):
    """LayerNorm with a scale and a bias over the last axis."""

    def __init__(self, dim: int, *, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.scale, self.bias, eps=self.eps)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

_ACTS = {
    "relu": torch.relu,
    # JAX's ``gelu`` defaults to the tanh approximation
    "gelu": lambda x: nn.functional.gelu(x, approximate="tanh"),
    "gelu_exact": lambda x: nn.functional.gelu(x, approximate="none"),
    "silu": nn.functional.silu,
}


def act_fn(name: str):
    return _ACTS[name]
