"""Neighborhood-Selectivity-Enhanced Query Representation (paper §3.3).

Port of ``repro.core.query_encoder``. Feature groups: statistics (weights,
k, recall target), local (an unfiltered pre-probe per vector column and the
fraction of probed neighbors satisfying Q_S, plus the probe's mean score),
global (histogram σ_est), the data encoder's ε_recon, and the compact
predicate encoding S_enc. ``encode_batch`` assembles
X_in = [ε_recon ; rates ; probe scores ; σ, log1p(1/σ) ; weights ;
log k, E_rec ; S_enc] for a whole query batch in one pass — the port's
counterpart of the JAX package's fused, vmapped feature jit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.data_encoder import DataEncoder
from repro_torch.vectordb import histogram, ivf
from repro_torch.vectordb.predicates import active_any, soft_encode
from repro_torch.vectordb.table import Table

S_ENC_BINS = 8  # compact predicate encoding for X_in


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
        return torch.cat([
            recon, rates, scores,
            sel[:, None], torch.log1p(1.0 / torch.clamp(sel, min=1e-6))[:, None],
            weights_b, logk_b[:, None], rec_b[:, None], s_enc,
        ], dim=-1).to(torch.float32)
