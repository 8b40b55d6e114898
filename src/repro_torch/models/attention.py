"""Attention: GQA (with qk-norm, partial rotary, softcap).

Port of ``repro.models.attention``'s GQA half. Full-sequence attention
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

MLA (deepseek-v3) is not ported yet: its configs raise
``NotImplementedError`` (ROADMAP Queue 1).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.common import nn as cnn
from repro_torch.configs.base import ModelConfig
from repro_torch.models.rotary import apply_rope

NEG_INF = -1e30
MLA_QUEUED = ("MLA attention (deepseek-v3) is not ported yet: ROADMAP "
              "Queue 1 item 4.3, MoE with MLA")


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
            raise NotImplementedError(MLA_QUEUED)
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
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, kv, hd)
    v = (x @ p["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = cnn.rmsnorm(q, p["q_norm"]["scale"], eps=cfg.norm_eps)
        k = cnn.rmsnorm(k, p["k_norm"]["scale"], eps=cfg.norm_eps)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, rotary_pct=cfg.rotary_pct,
                       theta=cfg.rope_theta)
        k = apply_rope(k, positions, rotary_pct=cfg.rotary_pct,
                       theta=cfg.rope_theta)
    return q, k, v


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
        qc = qg[:, q0: q0 + cq]  # (B, cq, KV, G, hd)
        scores = _scores(qc, k, "bqkgh,bskh->bkgqs") * scale
        scores = _softcap(scores, softcap)
        q_pos = q_offset + q0 + torch.arange(cq, device=q.device)
        causal = k_pos[None, :] <= q_pos[:, None]  # (cq, sk)
        scores = torch.where(causal, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgqs,bskh->bqkgh", probs, v))
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
        qc = qg[:, q0: q0 + cq]  # (B, cq, KV, G, hd)
        q_pos = q_offset + q0 + torch.arange(cq, device=q.device)
        m = torch.full((b, kvh, g, cq), NEG_INF, device=q.device)
        l = torch.zeros((b, kvh, g, cq), device=q.device)
        acc = torch.zeros((b, kvh, g, cq, hdv), device=q.device)
        for k0 in range(0, sk, ck):
            kb, vb = k[:, k0: k0 + ck], v[:, k0: k0 + ck]  # (B, ck, KV, hd)
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
    out = torch.cat(outs, dim=3)  # (B, KV, G, Sq, hdv)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hdv).to(v.dtype)


def full_attention(cfg: ModelConfig, q, k, v, *, scale: float,
                   softcap: float = 0.0, q_offset: int = 0):
    if cfg.flash_attention:
        return flash_causal_attention(
            q, k, v, q_chunk=cfg.attn_chunk_q, kv_chunk=cfg.attn_chunk_kv,
            scale=scale, softcap=softcap, q_offset=q_offset)
    return chunked_causal_attention(q, k, v, q_chunk=cfg.attn_chunk_q,
                                    scale=scale, softcap=softcap,
                                    q_offset=q_offset)


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
    return out.reshape(b, s, -1) @ p["wo"], cache


def gqa_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, pos: int,
               cache: dict) -> tuple:
    """One-token decode. x (B,1,D); ``pos`` the slot written for the whole
    batch (a host int). The cache is updated in place. Returns (y, cache)."""
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _gqa_qkv(p, cfg, x, positions)
    ck, cv = cache["k"], cache["v"]
    ck[:, pos] = k[:, 0]
    cv[:, pos] = v[:, 0]
    qg = q.reshape(b, kvh, h // kvh, hd)  # squeeze S=1
    scores = _scores(qg, ck, "bkgh,bskh->bkgs") / math.sqrt(hd)
    scores = _softcap(scores, cfg.attn_logit_softcap)
    valid = torch.arange(ck.shape[1], device=x.device) <= pos
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", probs, cv).reshape(b, 1, h * hd)
    return out @ p["wo"], cache
