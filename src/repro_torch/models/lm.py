"""LM assembly: blocks, parameter init, the forward, the training loss,
prefill and decode.

Port of ``repro.models.lm`` for its four families:

  dense   — [norm → attn → +res, norm → ffn → +res] × L
  moe     — a dense prefix (``first_k_dense`` blocks of FFN width
            ``dense_d_ff``) + MoE blocks (the FFN replaced by ``moe``)
  ssm     — [norm → mamba2 → +res] × L
  hybrid  — mamba2 × L with a SHARED attn+ffn block applied after every
            ``hybrid_attn_every``-th layer (zamba2)

Attention is GQA, or MLA where ``cfg.use_mla`` (deepseek-v3). ``LM`` holds
the parameters (``nn.Module``s named as the JAX parameter dict:
``embed.table``, ``blocks.{i}.attn.wq``, ``moe_blocks.{i}.moe.w_up``,
``dense_blocks.{i}.attn.wkv_b``, ``blocks.{i}.mamba.in_z``,
``shared_attn.ffn.w_up``, ``mtp.proj.w``, ``final_norm.scale``, ...; the
reference's stacked block leaves as ``nn.ModuleList``s, its one shared
block as one ``Block``), drawn from a seeded ``torch.Generator`` on the
model's device and cast to ``cfg.param_dtype`` as ``lm.init`` does: every
leaf but the numerics-sensitive ones (``_KEEP_F32``: the router, the SSM's
``A_log``, ``D``, ``dt_bias``), which stay f32. With ``mtp_depth`` the
model holds the multi-token-prediction parameters (``mtp``: ``norm_h``,
``norm_e``, ``proj``, a dense ``block``, ``norm_f``), which ``loss_fn``
trains through ``_mtp_loss``. The computation runs on plain dicts of
tensors by those names, as the reference's functions do.

Mixed precision: each block's parameters are used in ``cfg.dtype``, the
``_KEEP_F32`` leaves in f32. ``hidden``, ``prefill`` and ``decode_step``
cast each block at its use, as the reference's ``_cast_block`` does inside
its scan, so no whole-model copy is held; a block already in the compute
dtype is used as it is, without a copy. ``hidden(..., blocks=)`` takes a
copy made once instead (``cast_blocks``; ``bench.augment.lm_embed``
makes one per call, over many batches); casting is deterministic, so both
give the same values. The embedding table, ``patch_proj``, the final norm
and the head stay in ``cfg.param_dtype``. The prefill casts the mamba
blocks too, where the reference's ssm and hybrid prefills do not, and so
fail in bf16 (ROADMAP Queue 3).

The moe family's FFN is ``moe.moe_apply`` (the grouped GShard dispatch),
or, where ``cfg.moe_impl == "sharded"`` and an activation context
(``sharding.act_axes``) holds a mesh, the expert-parallel
``moe_sharded.moe_apply_sharded`` on the DTensors of that mesh, as the
reference picks them (``_moe_dispatch``). ``hidden(..., with_aux=True)``
also returns the MoE aux losses summed over the MoE blocks.

On a mesh the parameters and the batch are DTensors placed by
``models/sharding.py``'s specs and every function here runs on them
unchanged, DTensor's propagation placing each result; the plain tensors
the code makes (positions, masks) must then be read as replicated
(``torch.distributed.tensor.experimental.implicit_replication``, which the
mesh steps enter). ``forward``/``loss_fn`` take ``act_spec``, the spec the
residual stream is redistributed to before and after each block (the
reference's ``_scan_blocks(act_spec=)``: sequence-sharded carries).

Modality stubs: vlm prepends projected patch embeddings, audio feeds
precomputed frame embeddings straight to the stack.

Training: ``forward`` is the forward with autograd; with ``remat`` each
block (the hybrid: each group of ``hybrid_attn_every`` mamba layers and
its shared block, as ``_hybrid_forward`` does) runs under
``torch.utils.checkpoint``, its cast to the compute dtype inside, so the
backward recomputes the block's activations and its cast copy instead of
holding them, as the reference's ``jax.checkpoint`` around
``_cast_block`` does. ``loss_fn`` is the reference's: next-token CE in
sequence chunks (``chunked_ce``, each chunk under checkpoint so that one
chunk's (B, c, V) f32 logits live at a time, never the (T, V) matrix),
the z-loss (1e-4 · mean logZ²), the MoE aux (``router_aux_coef`` ·
``moe_lb_loss`` + 1e-4 · ``moe_z_loss``) and, with ``mtp_depth``, MTP's CE
at ``MTP_COEF``. ``hidden``, ``prefill`` and ``decode_step`` serve and run
without autograd.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.common import nn as cnn
from repro_torch.common.device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe_sharded, sharding
from repro_torch.models.ffn import FFN, ffn_apply
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.rotary import sinusoidal

FAMILIES = ("dense", "moe", "ssm", "hybrid")
MTP_COEF = 0.1
AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family the package does not know or a
    hybrid whose layers do not split into groups."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
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


@torch.no_grad()
def _in_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """``module`` with every parameter but the ``_KEEP_F32`` leaves cast to
    ``dtype`` in place (the f32 draw is freed leaf by leaf)."""
    for name, t in module.named_parameters():
        if name.split(".")[-1] not in _KEEP_F32 and t.dtype != dtype:
            t.data = t.data.to(dtype)
    return module


class Block(nn.Module):
    """norm1 → attn (GQA or MLA) → +res, norm2 → ffn (width ``d_ff``) or
    ``moe`` → +res."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 d_ff: int = 0, moe: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = norm_init(cfg, generator.device)
        self.attn = attn.attn_init(cfg, generator=generator)
        self.norm2 = norm_init(cfg, generator.device)
        if moe:
            self.moe = MoE(cfg, generator=generator, dtype=dtype)
        else:
            self.ffn = FFN(cfg.d_model, d_ff, cfg.ffn_act,
                           generator=generator)


class MambaBlock(nn.Module):
    """norm1 → mamba2 → +res."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__()
        self.norm1 = norm_init(cfg, generator.device)
        self.mamba = mamba2.Mamba(cfg, generator=generator)


class MTP(nn.Module):
    """Multi-token prediction (depth 1): ``norm_h``, ``norm_e``, ``proj``
    (2·d → d), a dense ``block`` of FFN width ``dense_d_ff or d_ff``,
    ``norm_f``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__()
        d, dev = cfg.d_model, generator.device
        self.norm_h = norm_init(cfg, dev)
        self.norm_e = norm_init(cfg, dev)
        self.proj = cnn.Linear(2 * d, d, generator=generator)
        self.block = Block(cfg, generator=generator,
                           d_ff=cfg.dense_d_ff or cfg.d_ff)
        self.norm_f = norm_init(cfg, dev)


class LM(nn.Module):
    """An LM's parameters on ``device`` (the CUDA device unless the caller
    names another), drawn from ``torch.Generator(device)`` seeded with
    ``seed``, each module cast to ``cfg.param_dtype`` once drawn."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        g = cnn.generator_on(dev, seed)
        pdt = param_dtype(cfg)

        def new(module: nn.Module) -> nn.Module:
            return _in_dtype(module, pdt)

        d = cfg.d_model
        if not cfg.inputs_are_embeds:
            self.embed = new(cnn.Embedding(cfg.vocab_padded, d,
                                           std=1.0 / math.sqrt(d),
                                           generator=g))
        if cfg.modality == "vlm":
            self.patch_proj = new(cnn.Linear(d, d, bias=True, generator=g))
        if cfg.family == "dense":
            self.blocks = nn.ModuleList(
                new(Block(cfg, generator=g, d_ff=cfg.d_ff))
                for _ in range(cfg.n_layers))
        elif cfg.family == "moe":
            if cfg.first_k_dense:
                self.dense_blocks = nn.ModuleList(
                    new(Block(cfg, generator=g, d_ff=cfg.dense_d_ff))
                    for _ in range(cfg.first_k_dense))
            self.moe_blocks = nn.ModuleList(
                new(Block(cfg, generator=g, moe=True, dtype=pdt))
                for _ in range(cfg.n_layers - cfg.first_k_dense))
        else:
            self.blocks = nn.ModuleList(new(MambaBlock(cfg, generator=g))
                                        for _ in range(cfg.n_layers))
        if cfg.family == "hybrid":
            self.shared_attn = new(Block(cfg, generator=g, d_ff=cfg.d_ff))
        self.final_norm = new(norm_init(cfg, dev))
        if not cfg.tie_embeddings:
            self.lm_head = new(cnn.Linear(d, cfg.vocab_padded, generator=g))
        if cfg.mtp_depth:
            self.mtp = new(MTP(cfg, generator=g))

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device


def init(cfg: ModelConfig, *, seed: int = 0, device=None) -> LM:
    return LM(cfg, seed=seed, device=device)


def _stacks(model: LM) -> tuple:
    """The names of the model's stacked block lists, in layer order."""
    if model.cfg.family != "moe":
        return ("blocks",)
    return (("dense_blocks",) if model.cfg.first_k_dense else ()) + (
        "moe_blocks",)


@torch.no_grad()
def cast_blocks(model: LM) -> dict:
    """The block parameters in the compute dtype (``_cast_block``), one
    dict a layer under each stack's name (``"blocks"``, or the moe
    family's ``"dense_blocks"`` and ``"moe_blocks"``), and for the hybrid
    family ``"shared_attn"``, the shared block's one copy. A leaf already
    in the compute dtype is the parameter itself."""
    dt = compute_dtype(model.cfg)
    out = {name: [param_tree(b, dt) for b in getattr(model, name)]
           for name in _stacks(model)}
    if model.cfg.family == "hybrid":
        out["shared_attn"] = param_tree(model.shared_attn, dt)
    return out


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _moe_dispatch(p: dict, cfg: ModelConfig, h) -> tuple:
    """The MoE FFN: the expert-parallel ``moe_apply_sharded`` with the
    context's axes where ``cfg.moe_impl == "sharded"`` and the activation
    context holds a mesh (``h`` must then be a DTensor on it), else
    ``moe_apply``."""
    ctx = sharding.act_ctx()
    if cfg.moe_impl == "sharded" and ctx is not None \
            and ctx.get("mesh") is not None:
        from torch.distributed.tensor import DTensor

        if not isinstance(h, DTensor):
            raise TypeError("the sharded MoE under a mesh context needs "
                            "DTensor activations on that mesh")
        return moe_sharded.moe_apply_sharded(
            p, cfg, h, ctx["mesh"], batch_axes=ctx["batch"],
            model_axis=ctx["model"])
    return moe_apply(p, cfg, h)


def _ffn(p: dict, cfg: ModelConfig, h) -> tuple:
    """The block's FFN or MoE on the normed residual -> (y, aux)."""
    if "moe" in p:
        return _moe_dispatch(p["moe"], cfg, h)
    return ffn_apply(p["ffn"], h, cfg.ffn_act), {}


def _block_prefill(p: dict, cfg: ModelConfig, x, positions, cache) -> tuple:
    """-> (x, aux); with a ``cache`` (``None`` for the forward without
    one), the attention's cache is written in place. Over a mesh the
    row-parallel products (``wo``, ``w_down``) leave partial sums on
    ``model``; ``sharding.settle`` reduces them before each residual add
    (the Megatron all-reduce), so the residual stream and the next norm
    stay whole there and no column-parallel weight is gathered."""
    y, _ = attn.attn_prefill(p["attn"], cfg, norm_apply(cfg, p["norm1"], x),
                             positions, cache)
    x = x + sharding.settle(y)
    y, aux = _ffn(p, cfg, norm_apply(cfg, p["norm2"], x))
    return x + sharding.settle(y), aux


def _block_decode(p: dict, cfg: ModelConfig, x, pos: int, cache: dict
                  ) -> tuple:
    y, _ = attn.attn_decode(p["attn"], cfg, norm_apply(cfg, p["norm1"], x),
                            pos, cache)
    x = x + sharding.settle(y)
    y, aux = _ffn(p, cfg, norm_apply(cfg, p["norm2"], x))
    return x + sharding.settle(y), aux


def _mamba_block_prefill(p: dict, cfg: ModelConfig, x, cache: dict | None):
    """The full sequence; with a ``cache`` (``None`` for the forward
    without one), its conv windows and state are written in place, in the
    cache's dtypes."""
    h = norm_apply(cfg, p["norm1"], x)
    if cache is None:
        return x + sharding.settle(mamba2.mamba_apply(p["mamba"], cfg, h))
    y, state = mamba2.mamba_apply(p["mamba"], cfg, h, return_state=True)
    for k, v in state.items():
        cache[k].copy_(v)
    return x + sharding.settle(y)


def _mamba_block_decode(p: dict, cfg: ModelConfig, x, cache: dict):
    h = norm_apply(cfg, p["norm1"], x)
    y, _ = mamba2.mamba_decode(p["mamba"], cfg, h, cache)
    return x + sharding.settle(y)


_CACHE_OF = {"blocks": "attn", "dense_blocks": "dense", "moe_blocks": "moe"}


def _run_stack(model: LM, blocks: dict | None, x, cache: dict | None,
               attn_fn, mamba_fn, *, remat: bool = False,
               act_spec: tuple | None = None) -> tuple:
    """The layers in order: ``attn_fn(p, x, layer_cache) -> (x, aux)`` for
    an attention block, ``mamba_fn(p, x, layer_cache) -> x`` for a mamba
    block, ``p`` each block's parameters in the compute dtype (cast at use
    unless ``blocks`` holds a copy). The hybrid's shared block follows
    every ``hybrid_attn_every``-th mamba layer with group g's attention
    cache. With ``remat`` each block (the hybrid: each group) runs under
    ``checkpoint``, its cast inside. ``act_spec`` redistributes a DTensor
    x to that spec before and after each unit. -> (x, the aux summed over
    the MoE blocks)."""
    cfg = model.cfg
    dt = compute_dtype(cfg)

    def params(name, i):
        if blocks is not None:
            return blocks[name] if i is None else blocks[name][i]
        mod = getattr(model, name)
        return param_tree(mod if i is None else mod[i], dt)

    def at(kind, i):
        return None if cache is None else {k: v[i]
                                           for k, v in cache[kind].items()}

    def attn_unit(name, i):
        return lambda y: attn_fn(params(name, i), y, at(_CACHE_OF[name], i))

    def mamba_unit(i):
        return lambda y: (mamba_fn(params("blocks", i), y, at("mamba", i)),
                          {})

    def group_unit(g, k):
        def run(y):
            for i in range(g * k, (g + 1) * k):
                y = mamba_fn(params("blocks", i), y, at("mamba", i))
            y, _ = attn_fn(params("shared_attn", None), y, at("attn", g))
            return y, {}
        return run

    if cfg.family in ("dense", "moe"):
        units = [attn_unit(name, i) for name in _stacks(model)
                 for i in range(len(getattr(model, name)))]
    elif cfg.family == "ssm":
        units = [mamba_unit(i) for i in range(cfg.n_layers)]
    else:
        k = cfg.hybrid_attn_every
        units = [group_unit(g, k) for g in range(cfg.n_layers // k)]
    if act_spec is not None:
        units = [_constrained(u, act_spec) for u in units]
    aux: dict = {}
    for unit in units:
        x, a = (checkpoint(unit, x, use_reentrant=False) if remat
                else unit(x))
        for key, v in a.items():
            aux[key] = aux[key] + v if key in aux else v
    if act_spec is not None:  # the head reads the whole sequence
        x = sharding.constrain(x, (act_spec[0],
                                   *([None] * (len(act_spec) - 1))))
    return x, aux


def _constrained(unit, spec: tuple):
    """``unit`` with its input and output carry at ``spec``; where that
    shards the sequence (the reference's SP carry, saved at that size by
    remat), the unit runs on the carry gathered back to its batch spec
    (Megatron-SP: the gather on entry, the scatter at the exit)."""
    inner = (spec[0], *([None] * (len(spec) - 1)))

    def run(y):
        y = sharding.constrain(y, spec)
        y, a = unit(sharding.constrain(y, inner))
        return sharding.constrain(y, spec), a
    return run


# ---------------------------------------------------------------------------
# inputs / outputs
# ---------------------------------------------------------------------------

def _embed_scale(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x · sqrt(d_model), the factor rounded to x's dtype first."""
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                            device=x.device)


def _lookup(model: LM, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of the embedding table (``sharding.lookup``: over a
    mesh, the vocab-parallel lookup)."""
    return sharding.lookup(model.embed.table, ids)


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
        parts.append(_lookup(model, batch["tokens"]).to(dt))
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

def _forward(model: LM, batch: dict, blocks: dict | None, remat: bool,
             act_spec: tuple | None = None) -> tuple:
    cfg = model.cfg
    x, positions = embed_inputs(model, batch)
    x, aux = _run_stack(
        model, blocks, x, None,
        lambda p, y, c: _block_prefill(p, cfg, y, positions, c),
        lambda p, y, c: _mamba_block_prefill(p, cfg, y, c), remat=remat,
        act_spec=act_spec)
    return model.final_norm(x), aux


def forward(model: LM, batch: dict, *, remat: bool = False,
            act_spec: tuple | None = None) -> tuple:
    """The forward with autograd (the reference's ``hidden(params, cfg,
    batch, remat=)``): -> (the final-norm hidden states (B, S, D) in
    cfg.dtype, the MoE aux losses (``AUX_KEYS``) summed over the MoE
    blocks, empty for the other families). ``remat`` checkpoints each
    block (the hybrid: each group); ``act_spec`` see ``_run_stack``."""
    return _forward(model, batch, None, remat, act_spec)


@torch.no_grad()
def hidden(model: LM, batch: dict, *, blocks: dict | None = None,
           with_aux: bool = False):
    """``forward`` without autograd, to the final-norm hidden states
    (B, S, D), cfg.dtype; with ``with_aux``, (h, aux)."""
    h, aux = _forward(model, batch, blocks, False)
    return (h, aux) if with_aux else h


# ---------------------------------------------------------------------------
# loss (chunked cross-entropy)
# ---------------------------------------------------------------------------

def _pick_chunk(s: int, target: int = 2048) -> int:
    for c in (target, 1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        if c <= s and s % c == 0:
            return c
    return s


def _ce_chunk(model: LM, hh: torch.Tensor, ll: torch.Tensor) -> tuple:
    """One chunk's (summed nll, valid count, summed logZ² over the valid
    positions)."""
    logits = unembed(model, hh)  # (B, c, V) f32
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, ll.clamp_min(0).long()[..., None])
    valid = (ll >= 0).float()
    # the difference before the gathered axis goes: over a mesh, a gather
    # from vocab-sharded logits is a masked partial sum that has to settle
    # at the gather's own rank
    nll = (logz[..., None] - gold)[..., 0] * valid
    return nll.sum(), valid.sum(), (logz.square() * valid).sum()


def chunked_ce(model: LM, h: torch.Tensor, labels: torch.Tensor, *,
               chunk: int = 0) -> tuple:
    """Mean next-token CE and mean logZ² over the positions whose label is
    not negative, without materializing (T, V): each chunk of ``chunk``
    positions (``_pick_chunk``'s, the largest power of two up to 2048
    dividing S, unless given) runs under ``checkpoint``, so its logits are
    recomputed in the backward. -> (ce, z_sq)."""
    b, s, _ = h.shape
    chunk = chunk or _pick_chunk(s)
    parts = [checkpoint(_ce_chunk, model, h[:, c: c + chunk],
                        labels[:, c: c + chunk], use_reentrant=False)
             for c in range(0, s, chunk)]
    nll, cnt, zsq = (torch.stack(t) for t in zip(*parts))
    total_cnt = torch.clamp_min(cnt.sum(), 1.0)
    return nll.sum() / total_cnt, zsq.sum() / total_cnt


def loss_fn(model: LM, batch: dict, *, remat: bool = False,
            z_loss_coef: float = 1e-4, act_spec: tuple | None = None
            ) -> tuple:
    """Scalar training loss + metrics (``ce``, ``z_sq``, the ``AUX_KEYS``
    for the moe family, ``mtp_ce`` with MTP, ``loss``). ``batch`` carries
    ``labels`` (B, S_lab), the last S_lab positions' targets (a vlm's
    patch prefix has none); a negative label is ignored."""
    cfg = model.cfg
    h, aux = forward(model, batch, remat=remat, act_spec=act_spec)
    labels = batch["labels"]
    h_lab = h[:, h.shape[1] - labels.shape[1]:]
    # over a mesh each term is settled before the sum (torch before 2.13
    # cannot add a partial mean to a partial sum)
    ce, zsq = (sharding.settle(t) for t in chunked_ce(model, h_lab, labels))
    loss = ce + z_loss_coef * zsq
    metrics = {"ce": ce, "z_sq": zsq}
    if aux:
        aux = {k: sharding.settle(v) for k, v in aux.items()}
        loss = loss + cfg.router_aux_coef * aux["moe_lb_loss"] \
            + 1e-4 * aux["moe_z_loss"]
        metrics.update(aux)
    if cfg.mtp_depth and "tokens" in batch:
        mtp_ce = sharding.settle(_mtp_loss(model, h, batch))
        loss = loss + MTP_COEF * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics


def _promoted(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """x and w in their promoted dtype (JAX's promotion of a mixed
    product, which torch's matmul refuses)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def _mtp_loss(model: LM, h: torch.Tensor, batch: dict) -> torch.Tensor:
    """DeepSeek-V3 multi-token prediction (depth 1): predict token t+2 from
    [h_t ; embed(token_{t+1})] through one extra block, shared unembedding.
    The projection is in the promoted dtype of its input and its f32
    weight, and the block runs in that dtype on its compute-dtype cast,
    as the reference's type promotion has it."""
    cfg, m = model.cfg, model.mtp
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    h_in = m.norm_h(h[:, : s - 1])
    e_in = m.norm_e(_lookup(model, tokens[:, 1:]).to(h.dtype))
    x, w = _promoted(torch.cat([h_in, e_in], dim=-1), m.proj.w)
    x = x @ w
    p = param_tree(m.block, compute_dtype(cfg))
    if x.dtype != compute_dtype(cfg):
        p = _tree_to(p, x.dtype)
    positions = torch.arange(s - 1, dtype=torch.int32,
                             device=x.device).expand(b, s - 1)
    x, _ = _block_prefill(p, cfg, x, positions, None)
    x = m.norm_f(x)
    # the target of position t is labels[t+1] (= token t+2), t in 0..s-2
    ce, _ = chunked_ce(model, x, labels[:, 1:])
    return ce


def _tree_to(tree: dict, dtype: torch.dtype) -> dict:
    return {k: _tree_to(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=None,
               device=None) -> dict:
    """Zeros, each layer's entries stacked on a leading axis: ``{"attn":
    {"k", "v"}}`` (L, B, max_len, KV, hd) for the dense family; for moe
    ``"dense"`` over the ``first_k_dense`` layers and ``"moe"`` over the
    rest, each GQA's ``{"k", "v"}`` or MLA's ``{"c_kv", "k_rope"}`` (L, B,
    max_len, kv_lora / rope); ``{"mamba": {"conv_x", "conv_bc", "state"}}``
    (L, B, ...) for ssm, and the hybrid's ``"attn"`` over its n_layers //
    hybrid_attn_every groups. The conv windows and the attention caches
    are in ``dtype`` (cfg.dtype), the SSM state f32."""
    dt = dtype or compute_dtype(cfg)
    dev = resolve_device(device)

    def stack(c: dict, n: int) -> dict:
        return {k: v.expand(n, *v.shape).clone() for k, v in c.items()}

    def attn_cache(n: int) -> dict:
        return stack(attn.attn_make_cache(cfg, batch, max_len, dt, dev), n)

    if cfg.family == "dense":
        return {"attn": attn_cache(cfg.n_layers)}
    if cfg.family == "moe":
        out = {"dense": attn_cache(cfg.first_k_dense)} if cfg.first_k_dense \
            else {}
        out["moe"] = attn_cache(cfg.n_layers - cfg.first_k_dense)
        return out
    out = {"mamba": stack(mamba2.mamba_make_cache(cfg, batch, dt, dev),
                          cfg.n_layers)}
    if cfg.family == "hybrid":
        out["attn"] = attn_cache(cfg.n_layers // cfg.hybrid_attn_every)
    return out


@torch.no_grad()
def prefill(model: LM, batch: dict, max_len: int, *,
            cache: dict | None = None) -> tuple:
    """Run the prompt, fill a new cache (or ``cache``, zeros of
    ``make_cache``'s structure, in place: on a mesh, one placed by
    ``sharding.cache_specs``). Returns (last-position logits (B, V) f32,
    cache)."""
    cfg = model.cfg
    x, positions = embed_inputs(model, batch)
    if cache is None:
        cache = make_cache(cfg, x.shape[0], max_len, device=x.device)
    x, _ = _run_stack(
        model, None, x, cache,
        lambda p, y, c: _block_prefill(p, cfg, y, positions, c),
        lambda p, y, c: _mamba_block_prefill(p, cfg, y, c))
    return unembed(model, model.final_norm(x)[:, -1]), cache


@torch.no_grad()
def decode_step(model: LM, inputs: dict, pos: int, cache: dict) -> tuple:
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
        x = _lookup(model, inputs["token"])[:, None].to(dt)
    if cfg.embed_scale:
        x = _embed_scale(cfg, x)
    if cfg.pos_embed == "sinusoidal":
        ppos = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                          device=x.device)
        x = x + sinusoidal(ppos, cfg.d_model).to(dt)
    x, _ = _run_stack(
        model, None, x, cache,
        lambda p, y, c: _block_decode(p, cfg, y, pos, c),
        lambda p, y, c: _mamba_block_decode(p, cfg, y, c))
    return unembed(model, model.final_norm(x)[:, 0]), cache
