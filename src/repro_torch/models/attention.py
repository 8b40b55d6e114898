"""Attention variants: GQA (with qk-norm, partial rotary, softcap) and MLA.

Port of ``repro.models.attention``. Full-sequence attention
(prefill, the no-cache forward) is **q-chunked**: the score matrix never
exceeds (B, H, q_chunk, S). ``cfg.flash_attention`` selects the
online-softmax form instead, whose (m, l, acc) carry never holds more than
(B, H, q_chunk, kv_chunk) scores. Both are written out as the reference
writes them: scores in f32, scaled by 1/sqrt(head_dim), an optional tanh
softcap, masked with ``NEG_INF``, softmax in f32, probabilities cast to v's
dtype before the PV product. Query head ``h`` reads kv head
``h // (n_heads // n_kv_heads)``.

Decode attends one new token against a (B, S_max, ...) cache, written in
place at ``pos`` for the whole batch.

MLA (deepseek-v3) runs the full sequence in the expanded form (k and v
built per head from the compressed stream, k's rope part shared by every
head) and decodes in the **absorbed** form: the cache holds only the
compressed ``c_kv`` (kv_lora_rank) and ``k_rope`` (rope dims) a position,
W_uk is folded into the query and W_uv into the output, so decode attends
in the kv_lora_rank space. ``attn_*`` dispatch on ``cfg.use_mla``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.common import nn as cnn
from repro_torch.configs.base import ModelConfig
from repro_torch.models.rotary import apply_rope
from repro_torch.models.sharding import constrain_batch, whole

NEG_INF = -1e30


def _cb(x, dim: int = 0):
    """``constrain_batch``: the batch dim onto the data axes under an
    activation context, where the reference pins it."""
    return constrain_batch(x, dim)


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(scores / cap)
    return scores


def _scores(q: torch.Tensor, k: torch.Tensor, spec: str) -> torch.Tensor:
    """``einsum(spec, q, k)`` with f32 products and sums (the reference's
    ``preferred_element_type=f32``): bf16 inputs are exact in f32."""
    return torch.einsum(spec, q.float(), k.float())


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    """``wq`` (d, H·hd), ``wk``/``wv`` (d, KV·hd), ``wo`` (H·hd, d) and, with
    ``cfg.qk_norm``, per-head RMS norms ``q_norm``/``k_norm`` over hd."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__()
        if cfg.use_mla:
            raise ValueError(f"{cfg.name} uses MLA attention: build it with "
                             f"MLA (attn_init dispatches on cfg.use_mla)")
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        g = generator
        self.wq = nn.Parameter(cnn.lecun_normal((d, h * hd), g))
        self.wk = nn.Parameter(cnn.lecun_normal((d, kv * hd), g))
        self.wv = nn.Parameter(cnn.lecun_normal((d, kv * hd), g))
        self.wo = nn.Parameter(cnn.lecun_normal((h * hd, d), g, fan_in=h * hd))
        if cfg.qk_norm:
            self.q_norm = cnn.RMSNorm(hd, eps=cfg.norm_eps, device=g.device)
            self.k_norm = cnn.RMSNorm(hd, eps=cfg.norm_eps, device=g.device)


def _gqa_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor) -> tuple:
    """x (B,S,D) -> q (B,S,H,hd), k/v (B,S,KV,hd), qk-norm then rope."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(x @ p["wq"], h, hd)
    k = _split_heads(x @ p["wk"], kv, hd)
    v = _split_heads(x @ p["wv"], kv, hd)
    if cfg.qk_norm:
        q = cnn.rmsnorm(q, p["q_norm"]["scale"], eps=cfg.norm_eps)
        k = cnn.rmsnorm(k, p["k_norm"]["scale"], eps=cfg.norm_eps)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, rotary_pct=cfg.rotary_pct,
                       theta=cfg.rope_theta)
        k = apply_rope(k, positions, rotary_pct=cfg.rotary_pct,
                       theta=cfg.rope_theta)
    return _cb(q), _cb(k), _cb(v)


def _split_heads(t, n: int, hd: int):
    """(B, S, n·hd) -> (B, S, n, hd). On a mesh whose axis over the last
    dim does not divide ``n``, the product is gathered whole first (a head
    cannot be split between ranks)."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(t, DTensor) and any(
            isinstance(p, Shard) and p.dim == t.ndim - 1
            and n % t.device_mesh.size(i)
            for i, p in enumerate(t.placements)):
        t = whole(t)
    return t.reshape(*t.shape[:-1], n, hd)


def _merge_heads(t):
    """(B, S, n, hd) -> (B, S, n·hd), the inverse of ``_split_heads``. On a
    mesh whose ``model`` axis does not divide ``n`` the heads were whole,
    and the merged product's cotangent is held whole too: the row-parallel
    ``wo`` after it gives the cotangent back sharded over the merged dim,
    and the reshape's backward cannot split a shard that falls inside a
    head."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.sharding import MODEL

    flat = t.reshape(*t.shape[:-2], -1)
    if isinstance(t, DTensor):
        mesh = t.device_mesh
        names = mesh.mesh_dim_names
        if MODEL in names and t.shape[-2] % mesh.size(names.index(MODEL)):
            flat = whole(flat)
    return flat


def _n_chunks(n: int, chunk: int) -> int:
    nc = max(1, n // chunk)
    if n % nc:
        raise ValueError(f"length {n} does not split into {nc} chunks of "
                         f"about {chunk}")
    return nc


def chunked_causal_attention(q, k, v, *, q_chunk: int, scale: float,
                             softcap: float = 0.0, q_offset: int = 0):
    """Grouped causal attention, one query block at a time.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd). H % KV == 0. q position i
    attends to k positions <= q_offset + i. Returns (B, Sq, H, hd_v).
    """
    b, sq, h, hd = q.shape
    _, sk, kvh, hdv = v.shape
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd)
    k_pos = torch.arange(sk, device=q.device)
    cq = sq // _n_chunks(sq, q_chunk)
    outs = []
    for q0 in range(0, sq, cq):
        qc = _cb(qg[:, q0: q0 + cq])  # (B, cq, KV, G, hd)
        scores = _scores(qc, k, "bqkgh,bskh->bkgqs") * scale
        scores = _softcap(scores, softcap)
        q_pos = q_offset + q0 + torch.arange(cq, device=q.device)
        causal = k_pos[None, :] <= q_pos[:, None]  # (cq, sk)
        scores = torch.where(causal, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(_cb(torch.einsum("bkgqs,bskh->bqkgh", probs, v)))
    return torch.cat(outs, dim=1).reshape(b, sq, h, hdv)


def flash_causal_attention(q, k, v, *, q_chunk: int, kv_chunk: int,
                           scale: float, softcap: float = 0.0,
                           q_offset: int = 0):
    """Online-softmax (flash) causal attention: a running (m, l, acc) carry
    in f32 per query block over kv blocks, divided by max(l, 1e-20) and
    cast to v's dtype. Shapes as ``chunked_causal_attention``."""
    b, sq, h, hd = q.shape
    _, sk, kvh, hdv = v.shape
    g = h // kvh
    cq = sq // _n_chunks(sq, q_chunk)
    ck = sk // _n_chunks(sk, kv_chunk)
    qg = q.reshape(b, sq, kvh, g, hd)
    outs = []
    for q0 in range(0, sq, cq):
        qc = _cb(qg[:, q0: q0 + cq])  # (B, cq, KV, G, hd)
        q_pos = q_offset + q0 + torch.arange(cq, device=q.device)
        m = torch.full((b, kvh, g, cq), NEG_INF, device=q.device)
        l = torch.zeros((b, kvh, g, cq), device=q.device)
        acc = torch.zeros((b, kvh, g, cq, hdv), device=q.device)
        for k0 in range(0, sk, ck):
            kb = _cb(k[:, k0: k0 + ck])  # (B, ck, KV, hd)
            vb = _cb(v[:, k0: k0 + ck])
            s = _scores(qc, kb, "bqkgh,bskh->bkgqs") * scale
            s = _softcap(s, softcap)
            k_pos = k0 + torch.arange(ck, device=q.device)
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            pr = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pr.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", pr.to(vb.dtype), vb)
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-20)[..., None])
    out = _cb(torch.cat(outs, dim=3))  # (B, KV, G, Sq, hdv)
    return _cb(out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hdv).to(v.dtype))


def full_attention(cfg: ModelConfig, q, k, v, *, scale: float,
                   softcap: float = 0.0, q_offset: int = 0):
    def run(q_, k_, v_):
        if cfg.flash_attention:
            return flash_causal_attention(
                q_, k_, v_, q_chunk=cfg.attn_chunk_q,
                kv_chunk=cfg.attn_chunk_kv, scale=scale, softcap=softcap,
                q_offset=q_offset)
        return chunked_causal_attention(q_, k_, v_, q_chunk=cfg.attn_chunk_q,
                                        scale=scale, softcap=softcap,
                                        q_offset=q_offset)

    return _by_rank(run, q, k, v)


def _by_rank(fn, q, k, v):
    """``fn(q, k, v)`` (attention over whole heads). On DTensors, each rank
    runs it on its own batch rows and heads through ``sharding.shard_map``
    (the rows over the data axes as q holds them, the heads over
    ``model`` where they divide it, k/v's kv heads too where theirs do,
    else whole, each rank picking those its query heads read). DTensor
    would otherwise flatten the batch dim with the sharded head dim inside
    the einsums, which torch's view rule refuses before 2.13."""
    from torch.distributed.tensor import DTensor

    if not isinstance(q, DTensor):
        return fn(q, k, v)
    from repro_torch.models import sharding

    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    bax = sharding.rows_of(q)
    h, kvh = q.shape[2], k.shape[2]
    nm = mesh.size(names.index(sharding.MODEL)) \
        if sharding.MODEL in names else 0
    heads = bool(nm) and h % nm == 0
    kv_heads = heads and kvh % nm == 0
    q_spec = (bax, None, sharding.MODEL if heads else None, None)
    kv_spec = (bax, None, sharding.MODEL if kv_heads else None, None)

    def local(ql, kl, vl):
        if heads and not kv_heads:
            m = mesh.get_coordinate()[names.index(sharding.MODEL)]
            hl = ql.shape[2]
            idx = (m * hl + torch.arange(hl, device=ql.device)) // (h // kvh)
            kl, vl = kl[:, :, idx], vl[:, :, idx]
        return (fn(ql, kl, vl),)

    (out,) = sharding.shard_map(local, mesh, (q_spec, kv_spec, kv_spec),
                                (q_spec,))(q, k, v)
    return out


def gqa_make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, max_len, kv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, kv, hd), dtype=dtype,
                             device=device)}


def gqa_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, cache: dict | None) -> tuple:
    """Full-sequence causal self-attention, x (B,S,D); with a ``cache``
    (``None`` for the forward without one), k/v are written into its
    first S slots in place. Returns (y, cache)."""
    q, k, v = _gqa_qkv(p, cfg, x, positions)
    out = full_attention(cfg, q, k, v, scale=1.0 / math.sqrt(cfg.head_dim),
                         softcap=cfg.attn_logit_softcap)
    b, s = x.shape[:2]
    if cache is not None:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
    return _merge_heads(out) @ p["wo"], cache


def gqa_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, pos: int,
               cache: dict) -> tuple:
    """One-token decode. x (B,1,D); ``pos`` the slot written for the whole
    batch (a host int). The cache is updated in place. Returns (y, cache)."""
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _gqa_qkv(p, cfg, x, positions)

    def scores(ql, ckl, _):
        qg = ql.reshape(ql.shape[0], kvh, h // kvh, hd)  # squeeze S=1
        return _softcap(_scores(qg, ckl, "bkgh,bskh->bkgs") / math.sqrt(hd),
                        cfg.attn_logit_softcap)

    def context(probs, _, cvl):
        return torch.einsum("bkgs,bskh->bkgh", probs, cvl)

    out = _attend_cache(q, (k, v), (cache["k"], cache["v"]), pos, scores,
                        context, 4)
    return out.reshape(b, 1, h * hd) @ p["wo"], cache


def _attend_cache(q, news: tuple, caches: tuple, pos: int, scores_fn,
                  context_fn, out_ndim: int):
    """One decode step's attention against caches written in place: each
    cache (B, S_max, ...) takes its new entry (B, 1, ...) at slot ``pos``,
    ``scores_fn(q, *caches)`` gives the f32 scores (..., S_max), masked
    past ``pos``, softmaxed, cast to the caches' dtype, and
    ``context_fn(probs, *caches)`` the context (of rank ``out_ndim``; its
    scores' last dim gone, their others kept).

    On DTensors the caches lie with their sequence over ``model`` (context
    parallelism, ``sharding.cache_specs``): through ``sharding.shard_map``
    each rank writes the slot if it holds it and attends to its own
    positions, and the softmax is taken across ranks (the max over
    ``model``, then the sums of the exponentials and of the unnormalized
    contexts), q, the new entries and the context whole there."""
    from torch.distributed.tensor import DTensor

    if not isinstance(caches[0], DTensor):
        for c, n in zip(caches, news):
            c[:, pos] = n[:, 0]
        s = scores_fn(q, *caches)
        valid = torch.arange(s.shape[-1], device=s.device) <= pos
        probs = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
        return context_fn(probs.to(caches[0].dtype), *caches)
    import torch.distributed as dist

    from repro_torch.common.mesh import psum
    from repro_torch.models import sharding

    mesh = caches[0].device_mesh
    names = mesh.mesh_dim_names
    bax = sharding.rows_of(caches[0])
    m_dim = names.index(sharding.MODEL)
    group = mesh.get_group(m_dim)

    def whole(t):
        return (bax, *([None] * (t.ndim - 1)))

    def local(ql, *parts):
        nl, cl = parts[:len(news)], parts[len(news):]
        s_l = cl[0].shape[1]
        start = mesh.get_coordinate()[m_dim] * s_l
        if start <= pos < start + s_l:
            for c, n in zip(cl, nl):
                c[:, pos - start] = n[:, 0]
        s = scores_fn(ql, *cl)
        valid = start + torch.arange(s_l, device=s.device) <= pos
        s = torch.where(valid, s, NEG_INF)
        mx = s.amax(dim=-1, keepdim=True)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(s - mx)
        total = psum(e.sum(dim=-1, keepdim=True), group)
        ctx = psum(context_fn(e.to(cl[0].dtype), *cl).float(), group)
        return ((ctx / total).to(cl[0].dtype),)

    specs = (whole(q), *(whole(n) for n in news),
             *((bax, sharding.MODEL, *([None] * (c.ndim - 2)))
               for c in caches))
    (out,) = sharding.shard_map(local, mesh, specs,
                                ((bax, *([None] * (out_ndim - 1))),))(
        q, *news, *caches)
    return out


# ---------------------------------------------------------------------------
# MLA (deepseek-v3)
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """``wq_a`` (d, q_lora), ``q_norm``, ``wq_b`` (q_lora, H·(nope+rope)),
    ``wkv_a`` (d, kv_lora + rope), ``kv_norm``, ``wkv_b`` (kv_lora,
    H·(nope+v)), ``wo`` (H·v, d)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        vd = cfg.v_head_dim
        g = generator
        self.wq_a = nn.Parameter(cnn.lecun_normal((d, qr), g))
        self.q_norm = cnn.RMSNorm(qr, eps=cfg.norm_eps, device=g.device)
        self.wq_b = nn.Parameter(cnn.lecun_normal((qr, h * (nope + rope_d)),
                                                  g, fan_in=qr))
        self.wkv_a = nn.Parameter(cnn.lecun_normal((d, kvr + rope_d), g))
        self.kv_norm = cnn.RMSNorm(kvr, eps=cfg.norm_eps, device=g.device)
        self.wkv_b = nn.Parameter(cnn.lecun_normal((kvr, h * (nope + vd)), g,
                                                   fan_in=kvr))
        self.wo = nn.Parameter(cnn.lecun_normal((h * vd, d), g,
                                                fan_in=h * vd))


def _mla_q(p: dict, cfg: ModelConfig, x, positions) -> tuple:
    """-> q_nope (B,S,H,nope), q_rope (B,S,H,rope) with rope applied."""
    b, s, _ = x.shape
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = cnn.rmsnorm(whole(x @ p["wq_a"]), p["q_norm"]["scale"],
                     eps=cfg.norm_eps)
    q = (cq @ p["wq_b"]).reshape(b, s, cfg.n_heads, nope + rope_d)
    return _cb(q[..., :nope]), _cb(apply_rope(q[..., nope:], positions,
                                              theta=cfg.rope_theta))


def _mla_kv_compressed(p: dict, cfg: ModelConfig, x, positions) -> tuple:
    """-> c_kv (B,S,kv_lora) normalized, k_rope (B,S,rope) with rope
    applied (one for every head)."""
    kvr = cfg.kv_lora_rank
    kv = whole(x @ p["wkv_a"])
    c_kv = cnn.rmsnorm(kv[..., :kvr], p["kv_norm"]["scale"], eps=cfg.norm_eps)
    return c_kv, apply_rope(kv[..., kvr:], positions, theta=cfg.rope_theta)


def _mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _mla_expanded(p: dict, cfg: ModelConfig, x, positions, c_kv, k_rope):
    """The expanded (non-absorbed) full-sequence attention. -> (B,S,D)."""
    b, s, _ = x.shape
    h, nope, vd = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    kvb = (c_kv @ p["wkv_b"]).reshape(b, s, h, nope + vd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([kvb[..., :nope],
                   k_rope[:, :, None].expand(b, s, h, k_rope.shape[-1])],
                  dim=-1)
    out = full_attention(cfg, q, k, kvb[..., nope:], scale=_mla_scale(cfg))
    return _merge_heads(out) @ p["wo"]


def mla_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence MLA (the forward, prefill), expanded form. x (B,S,D)."""
    c_kv, k_rope = _mla_kv_compressed(p, cfg, x, positions)
    return _mla_expanded(p, cfg, x, positions, c_kv, k_rope)


def mla_make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    """The compressed stream only: ``c_kv`` (B, S_max, kv_lora) and
    ``k_rope`` (B, S_max, rope)."""
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def mla_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, cache: dict | None) -> tuple:
    """``mla_apply``; with a ``cache``, the compressed stream is written
    into its first S slots in place. Returns (y, cache)."""
    c_kv, k_rope = _mla_kv_compressed(p, cfg, x, positions)
    y = _mla_expanded(p, cfg, x, positions, c_kv, k_rope)
    if cache is not None:
        s = x.shape[1]
        cache["c_kv"][:, :s] = c_kv
        cache["k_rope"][:, :s] = k_rope
    return y, cache


def mla_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, pos: int,
               cache: dict) -> tuple:
    """Absorbed one-token MLA decode against the compressed cache, written
    in place at ``pos``: q_c = q_nope · W_uk, the scores against c_kv and
    k_rope with f32 products and sums, the context in the kv_lora space,
    then W_uv and ``wo``. x (B,1,D). Returns (y, cache)."""
    b = x.shape[0]
    h, nope, vd = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)  # (B,1,H,.)
    c_kv, k_rope = _mla_kv_compressed(p, cfg, x, positions)
    wkv_b = p["wkv_b"].reshape(kvr, h, nope + vd)
    w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
    q_c = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)  # (B,H,kv_lora)

    def scores(qq, ckl, crl):
        return (_scores(qq[..., :kvr], ckl, "bhr,bsr->bhs")
                + _scores(qq[..., kvr:], crl, "bhr,bsr->bhs")) \
            * _mla_scale(cfg)

    def context(probs, ckl, _):
        return torch.einsum("bhs,bsr->bhr", probs, ckl)

    # the absorbed query and the rope query, side by side (B, H, r + rope)
    qq = torch.cat([q_c, q_rope[:, 0]], dim=-1)
    ctx_c = _attend_cache(qq, (c_kv, k_rope),
                          (cache["c_kv"], cache["k_rope"]), pos, scores,
                          context, 3)
    out = torch.einsum("bhr,rhv->bhv", ctx_c, w_uv).reshape(b, 1, h * vd)
    return out @ p["wo"], cache


# ---------------------------------------------------------------------------
# family dispatch
# ---------------------------------------------------------------------------

def attn_init(cfg: ModelConfig, *, generator: torch.Generator) -> nn.Module:
    return (MLA(cfg, generator=generator) if cfg.use_mla
            else GQA(cfg, generator=generator))


def attn_apply(p: dict, cfg: ModelConfig, x, positions) -> torch.Tensor:
    return attn_prefill(p, cfg, x, positions, None)[0]


def attn_make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device) -> dict:
    return (mla_make_cache if cfg.use_mla else gqa_make_cache)(
        cfg, batch, max_len, dtype, device)


def attn_prefill(p: dict, cfg: ModelConfig, x, positions, cache) -> tuple:
    return (mla_prefill if cfg.use_mla else gqa_prefill)(
        p, cfg, x, positions, cache)


def attn_decode(p: dict, cfg: ModelConfig, x, pos: int, cache) -> tuple:
    return (mla_decode if cfg.use_mla else gqa_decode)(p, cfg, x, pos, cache)
