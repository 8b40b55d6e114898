"""LM assembly: blocks, parameter init, the forward, prefill and decode.

Port of ``repro.models.lm`` for three of its four families:

  dense   — [norm → attn → +res, norm → ffn → +res] × L
  ssm     — [norm → mamba2 → +res] × L
  hybrid  — mamba2 × L with a SHARED attn+ffn block applied after every
            ``hybrid_attn_every``-th layer (zamba2)

``LM`` holds the parameters (``nn.Module``s named as the JAX parameter
dict: ``embed.table``, ``blocks.{i}.attn.wq``, ``blocks.{i}.mamba.in_z``,
``shared_attn.ffn.w_up``, ``final_norm.scale``, ...; the reference's
stacked block leaves as an ``nn.ModuleList``, its one shared block as one
``Block``), drawn from a seeded ``torch.Generator`` on the model's device.
The computation runs on plain dicts of tensors by those names, as the
reference's functions do.

Mixed precision: block parameters are used in ``cfg.dtype``
(``cast_blocks``), except the reference's numerics-sensitive leaves
(``_KEEP_F32``: the SSM's ``A_log``, ``D``, ``dt_bias``), which stay f32.
``hidden``, ``prefill`` and ``decode_step`` cast them at use unless given
``blocks=``, a copy made once (the serving steps and
``bench.augment.lm_embed`` make one per call); casting is deterministic, so
both give the same values. The embedding table, ``patch_proj``, the final
norm and the head stay in ``cfg.param_dtype``. The prefill casts the mamba
blocks too, where the reference's ssm and hybrid prefills do not, and so
fail in bf16 (ROADMAP Queue 3).

Modality stubs: vlm prepends projected patch embeddings, audio feeds
precomputed frame embeddings straight to the stack.

The ``moe`` family, MTP and MLA raise ``NotImplementedError`` (ROADMAP
Queue 1). The training loss is not ported yet, so ``hidden``, ``prefill``
and ``decode_step`` run without autograd.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.common import nn as cnn
from repro_torch.common.device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.ffn import FFN, ffn_apply
from repro_torch.models.rotary import sinusoidal

FAMILIES = ("dense", "ssm", "hybrid")
QUEUED = {
    "moe": "the moe family is not ported yet: ROADMAP Queue 1 item 4.3",
    "mtp": "multi-token prediction (mtp_depth > 0) is not ported yet: "
           "ROADMAP Queue 1 item 4.3",
}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not cover yet,
    ``ValueError`` for a hybrid whose layers do not split into groups."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(QUEUED.get(cfg.family, cfg.family))
    if cfg.mtp_depth:
        raise NotImplementedError(QUEUED["mtp"])
    if cfg.use_mla:
        raise NotImplementedError(attn.MLA_QUEUED)
    k = cfg.hybrid_attn_every
    if cfg.family == "hybrid" and (k <= 0 or cfg.n_layers % k):
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split "
                         f"into groups of hybrid_attn_every={k}")


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

_KEEP_F32 = ("router", "A_log", "D", "dt_bias")  # numerics-sensitive leaves


def param_tree(module: nn.Module, dtype: torch.dtype | None = None) -> dict:
    """The module's parameters as a nested dict by name, each cast to
    ``dtype`` but the leaves named in ``_KEEP_F32`` (a float tensor already
    in ``dtype`` is returned as is)."""
    out: dict = {}
    for name, t in module.named_parameters():
        node = out
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t if dtype is None or leaf in _KEEP_F32 else t.to(dtype)
    return out


class Block(nn.Module):
    """norm1 → attn → +res, norm2 → ffn → +res."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__()
        self.norm1 = norm_init(cfg, generator.device)
        self.attn = attn.GQA(cfg, generator=generator)
        self.norm2 = norm_init(cfg, generator.device)
        self.ffn = FFN(cfg.d_model, cfg.d_ff, cfg.ffn_act, generator=generator)


class MambaBlock(nn.Module):
    """norm1 → mamba2 → +res."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__()
        self.norm1 = norm_init(cfg, generator.device)
        self.mamba = mamba2.Mamba(cfg, generator=generator)


class LM(nn.Module):
    """An LM's parameters on ``device`` (the CUDA device unless the caller
    names another), drawn from ``torch.Generator(device)`` seeded with
    ``seed``."""

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
        block = Block if cfg.family == "dense" else MambaBlock
        self.blocks = nn.ModuleList(block(cfg, generator=g)
                                    for _ in range(cfg.n_layers))
        if cfg.family == "hybrid":
            self.shared_attn = Block(cfg, generator=g)
        self.final_norm = norm_init(cfg, dev)
        if not cfg.tie_embeddings:
            self.lm_head = cnn.Linear(d, cfg.vocab_padded, generator=g)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device


def init(cfg: ModelConfig, *, seed: int = 0, device=None) -> LM:
    return LM(cfg, seed=seed, device=device)


@torch.no_grad()
def cast_blocks(model: LM) -> dict:
    """The block parameters in the compute dtype (``_cast_block``):
    ``{"blocks": [one dict a layer]}``, and for the hybrid family
    ``"shared_attn"``, the shared block's one copy."""
    dt = compute_dtype(model.cfg)
    out = {"blocks": [param_tree(b, dt) for b in model.blocks]}
    if model.cfg.family == "hybrid":
        out["shared_attn"] = param_tree(model.shared_attn, dt)
    return out


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


def _mamba_block_prefill(p: dict, cfg: ModelConfig, x, cache: dict | None):
    """The full sequence; with a ``cache`` (``None`` for the forward
    without one), its conv windows and state are written in place, in the
    cache's dtypes."""
    h = norm_apply(cfg, p["norm1"], x)
    if cache is None:
        return x + mamba2.mamba_apply(p["mamba"], cfg, h)
    y, state = mamba2.mamba_apply(p["mamba"], cfg, h, return_state=True)
    for k, v in state.items():
        cache[k].copy_(v)
    return x + y


def _mamba_block_decode(p: dict, cfg: ModelConfig, x, cache: dict):
    h = norm_apply(cfg, p["norm1"], x)
    y, _ = mamba2.mamba_decode(p["mamba"], cfg, h, cache)
    return x + y


def _run_stack(cfg: ModelConfig, cast: dict, x, cache: dict | None,
               attn_fn, mamba_fn):
    """The layers in order: ``attn_fn(p, x, layer_cache)`` for an attention
    block, ``mamba_fn(p, x, layer_cache)`` for a mamba block, each -> x. The
    hybrid's shared block follows every ``hybrid_attn_every``-th mamba
    layer with group g's attention cache."""
    def at(kind, i):
        return None if cache is None else {k: v[i]
                                           for k, v in cache[kind].items()}

    k = cfg.hybrid_attn_every
    for i, p in enumerate(cast["blocks"]):
        if cfg.family == "dense":
            x = attn_fn(p, x, at("attn", i))
            continue
        x = mamba_fn(p, x, at("mamba", i))
        if cfg.family == "hybrid" and (i + 1) % k == 0:
            x = attn_fn(cast["shared_attn"], x, at("attn", i // k))
    return x


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
def hidden(model: LM, batch: dict, *, blocks: dict | None = None
           ) -> torch.Tensor:
    """Full forward to the final-norm hidden states (B, S, D), cfg.dtype."""
    cfg = model.cfg
    x, positions = embed_inputs(model, batch)
    x = _run_stack(
        cfg, blocks if blocks is not None else cast_blocks(model), x, None,
        lambda p, y, c: _block_prefill(p, cfg, y, positions, c)[0],
        lambda p, y, c: _mamba_block_prefill(p, cfg, y, c))
    return model.final_norm(x)


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=None,
               device=None) -> dict:
    """Zeros, each layer's entries stacked on a leading axis: ``{"attn":
    {"k", "v"}}`` (L, B, max_len, KV, hd) for the dense family; ``{"mamba":
    {"conv_x", "conv_bc", "state"}}`` (L, B, ...) for ssm, and the hybrid's
    ``"attn"`` over its n_layers // hybrid_attn_every groups. The conv
    windows and k/v are in ``dtype`` (cfg.dtype), the SSM state f32."""
    dt = dtype or compute_dtype(cfg)
    dev = resolve_device(device)

    def stack(c: dict, n: int) -> dict:
        return {k: v.expand(n, *v.shape).clone() for k, v in c.items()}

    if cfg.family == "dense":
        return {"attn": stack(attn.gqa_make_cache(cfg, batch, max_len, dt,
                                                  dev), cfg.n_layers)}
    out = {"mamba": stack(mamba2.mamba_make_cache(cfg, batch, dt, dev),
                          cfg.n_layers)}
    if cfg.family == "hybrid":
        out["attn"] = stack(attn.gqa_make_cache(cfg, batch, max_len, dt, dev),
                            cfg.n_layers // cfg.hybrid_attn_every)
    return out


@torch.no_grad()
def prefill(model: LM, batch: dict, max_len: int, *,
            blocks: dict | None = None) -> tuple:
    """Run the prompt, fill a new cache. Returns (last-position logits
    (B, V) f32, cache)."""
    cfg = model.cfg
    x, positions = embed_inputs(model, batch)
    cache = make_cache(cfg, x.shape[0], max_len, device=x.device)
    x = _run_stack(
        cfg, blocks if blocks is not None else cast_blocks(model), x, cache,
        lambda p, y, c: _block_prefill(p, cfg, y, positions, c)[0],
        lambda p, y, c: _mamba_block_prefill(p, cfg, y, c))
    return unembed(model, model.final_norm(x)[:, -1]), cache


@torch.no_grad()
def decode_step(model: LM, inputs: dict, pos: int, cache: dict, *,
                blocks: dict | None = None) -> tuple:
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
    x = _run_stack(
        cfg, blocks if blocks is not None else cast_blocks(model), x, cache,
        lambda p, y, c: _block_decode(p, cfg, y, pos, c)[0],
        lambda p, y, c: _mamba_block_decode(p, cfg, y, c))
    return unembed(model, model.final_norm(x)[:, 0]), cache
