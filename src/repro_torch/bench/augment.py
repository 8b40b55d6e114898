"""Benchmark construction (paper §4): correlated scalar/vector augmentation.

Port of ``repro.bench.augment``.

Vector -> scalar (for ann-benchmark-style datasets):
  * cluster IDs        — k-means cluster of each vector (categorical), on
                         the port's own k-means (``ivf._kmeans`` from a
                         seeded ``torch.Generator``), so the labels are the
                         port's, not the JAX package's;
  * hyperplane codes   — side-of-random-hyperplane bit strings (categorical);
  * reference distance — Σ distances to random reference points
                         (continuous).

Scalar -> vector (the paper embeds text columns with language models),
two embedders whose vectors are CORRELATED with the scalars as §4
requires:
  * ``hash_embed`` — a deterministic random-feature embedding of scalar
                     rows;
  * ``lm_embed``   — tokens hashed from each row run through one of the
                     assigned-architecture LMs (``repro_torch.models.lm``),
                     mean-pooled and projected.
The numpy constructions (``lm_embed``'s tokens and projection included)
match the JAX package's bit for bit; ``lm_embed``'s LM is the port's own
init from the seed unless a carried model is passed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.device import resolve_device

# rows a chunk of ``refpoint_distance_sum``: its (rows, n_refs, d) f32
# temporary stays at a few MB whatever the table's size
REFPOINT_CHUNK = 8192


# ---------------------------------------------------------------------------
# vector -> scalar
# ---------------------------------------------------------------------------

def cluster_labels(vectors: np.ndarray, n_clusters: int = 16, seed: int = 0,
                   iters: int = 8, *, device=None) -> np.ndarray:
    """k-means cluster id of each row (f32 codes), the k-means run on
    ``device`` (the CUDA device by default)."""
    from repro_torch.vectordb.ivf import _kmeans

    v = torch.as_tensor(np.asarray(vectors, np.float32),
                        device=resolve_device(device))
    _, assign = _kmeans(v, torch.Generator().manual_seed(seed), n_clusters,
                        iters)
    return assign.cpu().numpy().astype(np.float32)


def hyperplane_codes(vectors: np.ndarray, n_planes: int = 4,
                     seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(vectors.shape[1], n_planes)).astype(np.float32)
    bits = (vectors @ planes > 0).astype(np.int64)
    code = np.zeros(vectors.shape[0], np.int64)
    for j in range(n_planes):
        code = code * 2 + bits[:, j]
    return code.astype(np.float32)


def refpoint_distance_sum(vectors: np.ndarray, n_refs: int = 4,
                          seed: int = 0) -> np.ndarray:
    """Σ_r ‖v − ref_r‖ per row, in chunks of ``REFPOINT_CHUNK`` rows: each
    row's distances are reduced exactly as over the whole array at once,
    so the result is bit-identical to the unchunked formula."""
    rng = np.random.default_rng(seed + 7)
    lo, hi = vectors.min(axis=0), vectors.max(axis=0)
    refs = rng.uniform(lo, hi, size=(n_refs, vectors.shape[1])).astype(
        np.float32)
    out = np.empty(vectors.shape[0], np.float32)
    for s in range(0, vectors.shape[0], REFPOINT_CHUNK):
        v = vectors[s: s + REFPOINT_CHUNK]
        d = np.sqrt(((v[:, None, :] - refs[None]) ** 2).sum(-1))
        out[s: s + REFPOINT_CHUNK] = d.sum(axis=1)
    return out


def augment_with_scalars(vectors: np.ndarray, *, n_clusters: int = 16,
                         n_planes: int = 4, n_refs: int = 4, seed: int = 0,
                         device=None):
    """-> (scalars (n, 3) f32, column specs) via the three §4
    constructions; the k-means of ``cluster_labels`` runs on ``device``."""
    from repro_torch.vectordb.table import ScalarCol

    cols = [
        ScalarCol("cluster_id", "cat", n_clusters),
        ScalarCol("hplane_code", "cat", 2 ** n_planes),
        ScalarCol("ref_dist_sum", "num"),
    ]
    scalars = np.stack([
        cluster_labels(vectors, n_clusters, seed, device=device),
        hyperplane_codes(vectors, n_planes, seed),
        refpoint_distance_sum(vectors, n_refs, seed),
    ], axis=1)
    return scalars, cols


# ---------------------------------------------------------------------------
# scalar -> vector
# ---------------------------------------------------------------------------

def hash_embed(scalars: np.ndarray, dim: int, *, seed: int = 0,
               noise: float = 0.25) -> np.ndarray:
    """A fixed random 2-layer tanh feature map of the standardized scalar
    row + Gaussian noise, L2-normalized. Nearby scalar rows map to nearby
    vectors."""
    rng = np.random.default_rng(seed)
    m = scalars.shape[1]
    mu, sd = scalars.mean(axis=0), scalars.std(axis=0) + 1e-6
    z = (scalars - mu) / sd
    w1 = rng.normal(size=(m, 4 * m + 8)).astype(np.float32)
    w2 = rng.normal(size=(4 * m + 8, dim)).astype(np.float32) / np.sqrt(4 * m + 8)
    h = np.tanh(z @ w1)
    v = np.tanh(h @ w2) + noise * rng.normal(size=(len(scalars), dim))
    v = v.astype(np.float32)
    return v / (np.linalg.norm(v, axis=1, keepdims=True) + 1e-9)


def lm_tokens(scalars: np.ndarray, seq: int, vocab: int,
              rows: int) -> np.ndarray:
    """The ids the reference's LM reads for each scalar row -> (n, seq)
    int64: its row -> token hash (int64 numpy, wrapping on overflow), then
    its cast to int32 and JAX's gather rule (a negative id counts from the
    end of the ``rows``-row table, then every id is clamped into it). The
    hash reduces column j modulo ``vocab`` at step j only and grows it
    again at every later step, so all columns but the last reach that rule;
    the port keeps the reference's ids (ROADMAP Queue 3)."""
    mu, sd = scalars.mean(axis=0), scalars.std(axis=0) + 1e-6
    z = ((scalars - mu) / sd * 37.0).astype(np.int64)
    toks = np.zeros((len(scalars), seq), np.int64)
    for j in range(seq):
        toks = toks * 31 + np.roll(z, j, axis=1).sum(axis=1, keepdims=True) + j
        toks[:, j] = np.abs(toks[:, j]) % vocab
    ids = toks.astype(np.int32).astype(np.int64)
    return np.clip(np.where(ids < 0, ids + rows, ids), 0, rows - 1)


@torch.no_grad()
def lm_embed(scalars: np.ndarray, dim: int, *, arch: str = "stablelm-1.6b",
             smoke: bool = True, seed: int = 0, seq: int = 16,
             batch: int = 256, model=None, device=None) -> np.ndarray:
    """Embed rows with one of the assigned-architecture LMs: rows are
    hashed to token sequences, run through ``lm.hidden``, mean-pooled and
    projected by a ``np.random.default_rng(seed)`` matrix, L2-normalized.
    ``model`` (an ``lm.LM``) replaces the one ``arch``/``smoke``/``seed``
    would initialize; the LM runs where it lies (``device``, the CUDA
    device by default, when it is initialized here). Any ported family
    embeds; for an ssm or hybrid arch a ``seq`` longer than its
    ``ssm_chunk`` must be a multiple of it. -> (n, dim) f32."""
    from repro_torch import configs
    from repro_torch.models import lm

    if model is None:
        model = lm.init(configs.get_config(arch, smoke=smoke), seed=seed,
                        device=resolve_device(device))
    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(lm_tokens(scalars, seq, cfg.vocab,
                                      cfg.vocab_padded), device=dev)
    proj = rng.normal(size=(cfg.d_model, dim)).astype(np.float32) / np.sqrt(
        cfg.d_model)
    # float64 after the division by a numpy scalar; JAX rounds it to f32
    proj = torch.as_tensor(proj, dtype=torch.float32, device=dev)
    blocks = lm.cast_blocks(model)
    outs = []
    for i in range(0, len(scalars), batch):
        h = lm.hidden(model, {"tokens": toks[i:i + batch]}, blocks=blocks)
        outs.append(h.mean(dim=1).float() @ proj)
    v = torch.cat(outs).cpu().numpy().astype(np.float32)
    return v / (np.linalg.norm(v, axis=1, keepdims=True) + 1e-9)
