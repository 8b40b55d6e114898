"""Neighborhood-Selectivity-Enhanced Query Representation (paper §3.3).

Port of ``repro.core.query_encoder``. Feature groups: statistics (weights,
k, recall target), local (an unfiltered pre-probe per vector column and the
fraction of probed neighbors satisfying Q_S, plus the probe's mean score),
global (histogram σ_est), the data encoder's ε_recon, and the compact
predicate encoding S_enc. ``encode_batch`` assembles
X_in = [ε_recon ; rates ; probe scores ; σ, log1p(1/σ) ; weights ;
log k, E_rec ; S_enc] for a whole query batch in one pass — the port's
counterpart of the JAX package's fused, vmapped feature jit. ``encode``
gives one query's ``QueryFeatures`` through the same pieces at B=1, and
the single-feature probes (``global_selectivity``, ``local_probe``,
``recon_errors``) are exposed for ablations, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.data_encoder import DataEncoder
from repro_torch.core.query import MHQ
from repro_torch.vectordb import histogram, ivf
from repro_torch.vectordb.predicates import active_any, soft_encode, stack
from repro_torch.vectordb.table import Table

S_ENC_BINS = 8  # compact predicate encoding for X_in


def _x_in(recon, rates, scores, sel, weights, logk, rec, s_enc
          ) -> torch.Tensor:
    """X_in rows from (B, ·) feature groups; ``sel``, ``logk``, ``rec``
    (B,)."""
    return torch.cat([
        recon, rates, scores,
        sel[:, None], torch.log1p(1.0 / torch.clamp(sel, min=1e-6))[:, None],
        weights, logk[:, None], rec[:, None], s_enc,
    ], dim=-1).to(torch.float32)


@dataclasses.dataclass
class QueryFeatures:
    """One query's feature groups; tensors on the encoder's device."""

    recon_errors: torch.Tensor  # (N,)
    local_rates: torch.Tensor  # (N,) pre-probe satisfaction rate per column
    probe_scores: torch.Tensor  # (N,) mean top-score of the unfiltered probe
    selectivity: float  # σ_est
    weights: torch.Tensor  # (N,)
    k: int
    recall_target: float
    s_enc: torch.Tensor  # flattened predicate encoding

    def x_in(self) -> torch.Tensor:
        """(feature_dim,) X_in, assembled as ``encode_batch`` assembles a
        row."""
        dev = self.weights.device

        def one(v):
            return torch.tensor([v], dtype=torch.float32, device=dev)

        return _x_in(self.recon_errors[None], self.local_rates[None],
                     self.probe_scores[None], one(self.selectivity),
                     self.weights[None], one(float(np.log(self.k))),
                     one(self.recall_target), self.s_enc[None])[0]


def feature_dim(n_vec: int, n_scalar: int) -> int:
    return 3 * n_vec + 2 + n_vec + 2 + n_scalar * (S_ENC_BINS + 1)


class QueryEncoder:
    """Holds the per-column IVF indexes (for pre-probing), the histograms
    (for GSE) and the data encoder (for ε_recon)."""

    def __init__(self, table: Table, indexes: list,
                 hists: histogram.Histograms,
                 data_encoder: Optional[DataEncoder], *, probe_k: int = 32,
                 probe_nprobe: int = 1):
        self.table = table
        self.indexes = indexes
        self.hists = hists
        self.data_encoder = data_encoder
        self.probe_k = probe_k
        self.probe_nprobe = probe_nprobe
        # compact bin edges for S_enc (computed in numpy, as on the JAX side)
        scal = table.scalars.cpu().numpy()
        lo, hi = scal.min(axis=0), scal.max(axis=0)
        span = np.maximum(hi - lo, 1e-9)
        self._edges = torch.as_tensor(
            (lo[:, None] + span[:, None]
             * np.linspace(0.0, 1.0 + 1e-6, S_ENC_BINS + 1)[None, :]
             ).astype(np.float32), device=table.device)

    # -- single-feature probes (exposed for ablations) ----------------------

    def global_selectivity(self, q: MHQ) -> float:
        return float(histogram.estimate_selectivity(self.hists, q.predicates))

    @torch.no_grad()
    def local_probe(self, q: MHQ) -> tuple:
        """-> (rates (N,), mean probe scores (N,)): the unfiltered pre-probe
        of each column and its predicate's satisfaction rate there."""
        pred_b = stack([q.predicates])
        rates, scores = [], []
        for i, qv in enumerate(q.query_vectors):
            r, s = ivf.preprobe(
                self.indexes[i], self.table.vectors[i], self.table.scalars,
                pred_b, qv[None], nprobe=self.probe_nprobe,
                probe_k=self.probe_k)
            rates.append(r[0])
            scores.append(s[0])
        return torch.stack(rates), torch.stack(scores)

    def recon_errors(self, q: MHQ) -> torch.Tensor:
        if self.data_encoder is None:
            return torch.zeros((q.n_vec,), device=self.table.device)
        return self.data_encoder.recon_errors(list(q.query_vectors),
                                              q.predicates)

    # -- full feature assembly ----------------------------------------------

    @torch.no_grad()
    def encode(self, q: MHQ, *, use_de: bool = True, use_stats: bool = True,
               use_gse: bool = True, use_lnp: bool = True) -> QueryFeatures:
        """One query's features; the flags zero the paper's ablation
        feature groups (§5.5) as ``encode_batch``'s do."""
        n = q.n_vec
        dev = self.table.device
        recon = self.recon_errors(q) if use_de \
            else torch.zeros((n,), device=dev)
        if use_lnp:
            rates, scores = self.local_probe(q)
        else:
            rates = torch.full((n,), 0.5, device=dev)
            scores = torch.zeros((n,), device=dev)
        sel = self.global_selectivity(q) if use_gse else 0.5
        pred_b = stack([q.predicates])
        enc = soft_encode(pred_b, self._edges)
        s_enc = torch.cat([enc, active_any(pred_b).to(torch.float32)[..., None]],
                          dim=-1).reshape(-1)
        if use_stats:
            weights = torch.as_tensor(np.asarray(q.weights, np.float32),
                                      device=dev)
            k, rec = q.k, q.recall_target
        else:
            weights = torch.full((n,), 1.0 / n, device=dev)
            k, rec = 10, 0.9
        return QueryFeatures(
            recon_errors=recon, local_rates=rates, probe_scores=scores,
            selectivity=sel, weights=weights, k=k, recall_target=rec,
            s_enc=s_enc)

    @torch.no_grad()
    def encode_batch(self, cold, qv_b: tuple, pred_b,
                     weights_b: torch.Tensor,
                     logk_b: torch.Tensor, rec_b: torch.Tensor, *,
                     row_scores: Optional[tuple] = None, use_de: bool = True,
                     use_stats: bool = True, use_gse: bool = True,
                     use_lnp: bool = True) -> torch.Tensor:
        """(B, feature_dim) X_in for a stacked query batch.

        ``row_scores`` — per-column (B, n) similarities from one GEMM for
        the batch — makes the pre-probe gather f32 scores instead of
        vector tiles. The flags zero the paper's ablation feature groups.
        ``cold`` — the epoch (a ``tiered.ColdState``: table, indexes,
        histograms) the pre-probe and the estimate read, which may be a
        later one than the encoder was built on; the S_enc edges and the
        data encoder stay this encoder's."""
        t, indexes, hists = cold.table, cold.indexes, cold.hists
        b = qv_b[0].shape[0]
        n_vec = len(qv_b)
        dev = t.device
        if use_de and self.data_encoder is not None:
            recon = self.data_encoder.recon_errors_batch(qv_b, pred_b)
        else:
            recon = torch.zeros((b, n_vec), device=dev)
        if use_lnp:
            rates, scores = [], []
            for i in range(n_vec):
                if row_scores is not None:
                    r, s = ivf.preprobe_scored(
                        indexes[i], row_scores[i], t.scalars, pred_b,
                        qv_b[i], nprobe=self.probe_nprobe,
                        probe_k=self.probe_k)
                else:
                    r, s = ivf.preprobe(
                        indexes[i], t.vectors[i], t.scalars, pred_b,
                        qv_b[i], nprobe=self.probe_nprobe,
                        probe_k=self.probe_k)
                rates.append(r)
                scores.append(s)
            rates = torch.stack(rates, dim=-1)
            scores = torch.stack(scores, dim=-1)
        else:
            rates = torch.full((b, n_vec), 0.5, device=dev)
            scores = torch.zeros((b, n_vec), device=dev)
        if use_gse:
            sel = histogram.estimate_selectivity(hists, pred_b)
        else:
            sel = torch.full((b,), 0.5, device=dev)
        enc = soft_encode(pred_b, self._edges)  # (B, M, S_ENC_BINS)
        s_enc = torch.cat([enc, active_any(pred_b).to(torch.float32)[..., None]],
                          dim=-1).reshape(b, -1)
        if not use_stats:
            weights_b = torch.full((b, n_vec), 1.0 / n_vec, device=dev)
            logk_b = torch.full((b,), float(np.log(10.0)), device=dev)
            rec_b = torch.full((b,), 0.9, device=dev)
        return _x_in(recon, rates, scores, sel, weights_b, logk_b, rec_b,
                     s_enc)
