"""LM assembly for the dense family: blocks, parameter init, the forward,
prefill and decode.

Port of ``repro.models.lm``'s dense half:

  dense — [norm → attn → +res, norm → ffn → +res] × L

``LM`` holds the parameters (``nn.Module``s named as the JAX parameter
dict: ``embed.table``, ``blocks.{i}.attn.wq``, ``final_norm.scale``, ...,
the reference's stacked block leaves as an ``nn.ModuleList``), drawn from
a seeded ``torch.Generator`` on the model's device. The computation runs
on plain dicts of tensors by those names, as the reference's functions do.

Mixed precision: block parameters are used in ``cfg.dtype``
(``cast_blocks``). ``hidden``, ``prefill`` and ``decode_step`` cast them at
use unless given ``blocks=``, a copy made once (the serving steps and
``bench.augment.lm_embed`` make one per call); casting is deterministic, so
both give the same values. The embedding table, ``patch_proj``, the final
norm and the head stay in ``cfg.param_dtype``.

Modality stubs: vlm prepends projected patch embeddings, audio feeds
precomputed frame embeddings straight to the stack.

The ``moe``, ``ssm`` and ``hybrid`` families, MTP and MLA raise
``NotImplementedError`` (ROADMAP Queue 1). The training loss is not ported
yet, so ``hidden``, ``prefill`` and ``decode_step`` run without autograd.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.common import nn as cnn
from repro_torch.common.device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.ffn import FFN, ffn_apply
from repro_torch.models.rotary import sinusoidal

QUEUED = {
    "ssm": "the ssm family (mamba2) is not ported yet: ROADMAP Queue 1 "
           "item 4.2",
    "hybrid": "the hybrid family (zamba2) is not ported yet: ROADMAP Queue 1 "
              "item 4.2",
    "moe": "the moe family is not ported yet: ROADMAP Queue 1 item 4.3",
    "mtp": "multi-token prediction (mtp_depth > 0) is not ported yet: "
           "ROADMAP Queue 1 item 4.3",
}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    if cfg.family != "dense":
        raise NotImplementedError(QUEUED.get(cfg.family, cfg.family))
    if cfg.mtp_depth:
        raise NotImplementedError(QUEUED["mtp"])
    if cfg.use_mla:
        raise NotImplementedError(attn.MLA_QUEUED)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(cfg: ModelConfig, device) -> nn.Module:
    if cfg.norm == "layernorm":
        return cnn.LayerNorm(cfg.d_model, eps=cfg.norm_eps, device=device)
    return cnn.RMSNorm(cfg.d_model, eps=cfg.norm_eps,
                       zero_centered=cfg.zero_centered_norm, device=device)


def norm_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return cnn.layernorm(x, p["scale"], p["bias"], eps=cfg.norm_eps)
    return cnn.rmsnorm(x, p["scale"], eps=cfg.norm_eps,
                       zero_centered=cfg.zero_centered_norm)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_tree(module: nn.Module, dtype: torch.dtype | None = None) -> dict:
    """The module's parameters as a nested dict by name, each cast to
    ``dtype`` (a float tensor already in ``dtype`` is returned as is)."""
    out: dict = {}
    for name, t in module.named_parameters():
        node = out
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t if dtype is None else t.to(dtype)
    return out


class Block(nn.Module):
    """norm1 → attn → +res, norm2 → ffn → +res."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__()
        self.norm1 = norm_init(cfg, generator.device)
        self.attn = attn.GQA(cfg, generator=generator)
        self.norm2 = norm_init(cfg, generator.device)
        self.ffn = FFN(cfg.d_model, cfg.d_ff, cfg.ffn_act, generator=generator)


class LM(nn.Module):
    """A dense LM's parameters on ``device`` (the CUDA device unless the
    caller names another), drawn from ``torch.Generator(device)`` seeded
    with ``seed``."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        g = torch.Generator(dev).manual_seed(seed)
        d = cfg.d_model
        if not cfg.inputs_are_embeds:
            self.embed = cnn.Embedding(cfg.vocab_padded, d,
                                       std=1.0 / math.sqrt(d), generator=g)
        if cfg.modality == "vlm":
            self.patch_proj = cnn.Linear(d, d, bias=True, generator=g)
        self.blocks = nn.ModuleList(Block(cfg, generator=g)
                                    for _ in range(cfg.n_layers))
        self.final_norm = norm_init(cfg, dev)
        if not cfg.tie_embeddings:
            self.lm_head = cnn.Linear(d, cfg.vocab_padded, generator=g)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device


def init(cfg: ModelConfig, *, seed: int = 0, device=None) -> LM:
    return LM(cfg, seed=seed, device=device)


@torch.no_grad()
def cast_blocks(model: LM) -> list:
    """Each block's parameters in the compute dtype (``_cast_block``)."""
    dt = compute_dtype(model.cfg)
    return [param_tree(b, dt) for b in model.blocks]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _block_prefill(p: dict, cfg: ModelConfig, x, positions, cache):
    y, cache = attn.gqa_prefill(p["attn"], cfg, norm_apply(cfg, p["norm1"], x),
                                positions, cache)
    x = x + y
    h = norm_apply(cfg, p["norm2"], x)
    return x + ffn_apply(p["ffn"], h, cfg.ffn_act), cache


def _block_decode(p: dict, cfg: ModelConfig, x, pos: int, cache: dict):
    y, cache = attn.gqa_decode(p["attn"], cfg, norm_apply(cfg, p["norm1"], x),
                               pos, cache)
    x = x + y
    h = norm_apply(cfg, p["norm2"], x)
    return x + ffn_apply(p["ffn"], h, cfg.ffn_act), cache


# ---------------------------------------------------------------------------
# inputs / outputs
# ---------------------------------------------------------------------------

def _embed_scale(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x · sqrt(d_model), the factor rounded to x's dtype first."""
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                            device=x.device)


def embed_inputs(model: LM, batch: dict) -> tuple:
    """-> (x (B,S,D) in cfg.dtype, positions (B,S) int32). ``batch``:
    ``tokens`` (B,S) int, ``patch_embeds`` (vlm, prepended) or ``embeds``
    (audio)."""
    cfg = model.cfg
    dt = compute_dtype(cfg)
    parts = []
    if cfg.modality == "vlm":
        # bf16 patches against the f32 projection compute in f32 (the
        # reference's type promotion), then come back to dt
        pp = model.patch_proj
        ct = torch.promote_types(dt, pp.w.dtype)
        patches = batch["patch_embeds"].to(dt).to(ct)
        parts.append((patches @ pp.w.to(ct) + pp.b.to(ct)).to(dt))
    if cfg.inputs_are_embeds:
        parts.append(batch["embeds"].to(dt))
    elif "tokens" in batch:
        parts.append(model.embed.table[batch["tokens"]].to(dt))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    if cfg.embed_scale:
        x = _embed_scale(cfg, x)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    if cfg.pos_embed == "sinusoidal":
        x = x + sinusoidal(positions, cfg.d_model).to(dt)
    return x, positions


def unembed(model: LM, h: torch.Tensor) -> torch.Tensor:
    """hidden (..., D) -> logits (..., vocab_padded), f32; pad columns
    -1e30."""
    cfg = model.cfg
    h = h.float()
    if cfg.tie_embeddings:
        logits = h @ model.embed.table.float().T
    else:
        logits = h @ model.lm_head.w.float()
    if cfg.vocab_padded != cfg.vocab:
        logits[..., cfg.vocab:] = -1e30
    return logits


# ---------------------------------------------------------------------------
# forward / prefill / decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def hidden(model: LM, batch: dict, *, blocks: list | None = None
           ) -> torch.Tensor:
    """Full forward to the final-norm hidden states (B, S, D), cfg.dtype."""
    cfg = model.cfg
    x, positions = embed_inputs(model, batch)
    for p in blocks if blocks is not None else cast_blocks(model):
        x, _ = _block_prefill(p, cfg, x, positions, None)
    return model.final_norm(x)


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=None,
               device=None) -> dict:
    """``{"attn": {"k", "v"}}``, each (L, B, max_len, KV, hd) zeros."""
    dt = dtype or compute_dtype(cfg)
    dev = resolve_device(device)
    c = attn.gqa_make_cache(cfg, batch, max_len, dt, dev)
    return {"attn": {k: v.expand(cfg.n_layers, *v.shape).clone()
                     for k, v in c.items()}}


def _layer_cache(cache: dict, i: int) -> dict:
    return {k: v[i] for k, v in cache["attn"].items()}


@torch.no_grad()
def prefill(model: LM, batch: dict, max_len: int, *,
            blocks: list | None = None) -> tuple:
    """Run the prompt, fill a new cache. Returns (last-position logits
    (B, V) f32, cache)."""
    cfg = model.cfg
    x, positions = embed_inputs(model, batch)
    cache = make_cache(cfg, x.shape[0], max_len, device=x.device)
    for i, p in enumerate(blocks if blocks is not None
                          else cast_blocks(model)):
        x, _ = _block_prefill(p, cfg, x, positions, _layer_cache(cache, i))
    return unembed(model, model.final_norm(x)[:, -1]), cache


@torch.no_grad()
def decode_step(model: LM, inputs: dict, pos: int, cache: dict, *,
                blocks: list | None = None) -> tuple:
    """One token for every sequence in the batch.

    inputs: {"token": (B,)} or {"embed": (B, D)} (audio). pos: the cache
    slot to write (a host int, the same for the whole batch). The cache is
    written in place. Returns (logits (B, V) f32, cache).
    """
    cfg = model.cfg
    dt = compute_dtype(cfg)
    if cfg.inputs_are_embeds:
        x = inputs["embed"][:, None].to(dt)
    else:
        x = model.embed.table[inputs["token"]][:, None].to(dt)
    if cfg.embed_scale:
        x = _embed_scale(cfg, x)
    if cfg.pos_embed == "sinusoidal":
        ppos = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                          device=x.device)
        x = x + sinusoidal(ppos, cfg.d_model).to(dt)
    for i, p in enumerate(blocks if blocks is not None
                          else cast_blocks(model)):
        x, _ = _block_decode(p, cfg, x, pos, _layer_cache(cache, i))
    return unembed(model, model.final_norm(x)[:, 0]), cache
