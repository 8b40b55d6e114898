"""Correlation-Aware Vector–Scalar Data Encoder (paper §3.2).

Port of ``repro.core.data_encoder``. Per vector column i: M frozen MLPs
predicting each scalar's bin from the vector (stacked over j), and one
trainable MLP; ``E_i = [‖_j f_frozen[i,j](v_i) ; f_trainable[i](v_i) ; E_s]``
feeds a shared autoencoder trained on reconstruction MSE. At query time the
reconstruction error of the (query vector, predicate encoding) pairing is
the anomaly score ε_recon_i the rewriter reads.

Initialization draws from a ``torch.Generator`` seeded with ``cfg.seed``;
the sampled training subset and the minibatch indices come from numpy
``default_rng`` exactly as in the JAX package. ``update`` fine-tunes the
trainable nets and the autoencoder on inserted rows only (paper §3.2
'Incremental Model Updates'); the frozen predictors stay fixed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.common.nn import MLP, trunc_normal
from repro_torch.train import optimizer
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.vectordb.predicates import (
    PredicateLike, soft_encode, stack, value_encode,
)
from repro_torch.vectordb.table import Table


@dataclasses.dataclass(frozen=True)
class DataEncoderConfig:
    n_bins: int = 16  # one-hot bins per scalar (encoder-side)
    frozen_hidden: int = 32
    trainable_dim: int = 16
    ae_hidden: int = 64
    ae_latent: int = 24
    lr: float = 2e-3
    frozen_steps: int = 200
    ae_steps: int = 400
    update_steps: int = 80  # incremental fine-tune budget
    batch: int = 512
    sample: int = 8192  # sampled subset for initial training (paper §3.5)
    seed: int = 0


def _quantile_edges(scalars: np.ndarray, n_bins: int) -> np.ndarray:
    """(n, M) -> (M, B+1) strictly increasing quantile bin edges, float32
    (the dtype the JAX package stores and bins with)."""
    qs = np.linspace(0.0, 1.0, n_bins + 1)
    edges = np.quantile(scalars, qs, axis=0).T.astype(np.float32)
    eps = 1e-6 * (1.0 + np.abs(edges))
    return np.maximum.accumulate(
        edges + eps * np.arange(n_bins + 1)[None, :], axis=1
    ).astype(np.float32)


class FrozenPredictors(nn.Module):
    """M stacked one-hidden-layer nets: v (..., d) -> logits (..., M, B)."""

    def __init__(self, d_in: int, m: int, cfg: DataEncoderConfig, *,
                 generator: torch.Generator):
        super().__init__()
        h, b = cfg.frozen_hidden, cfg.n_bins
        self.w0 = nn.Parameter(trunc_normal((m, d_in, h), 1.0 / np.sqrt(d_in),
                                            generator))
        self.b0 = nn.Parameter(torch.zeros(m, h))
        self.w1 = nn.Parameter(trunc_normal((m, h, b), 1.0 / np.sqrt(h),
                                            generator))
        self.b1 = nn.Parameter(torch.zeros(m, b))

    def logits(self, v: torch.Tensor) -> torch.Tensor:
        h = torch.relu(torch.einsum("...d,mdh->...mh", v, self.w0) + self.b0)
        return torch.einsum("...mh,mhb->...mb", h, self.w1) + self.b1

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        """Softmax bin probabilities (..., M, B)."""
        return torch.softmax(self.logits(v), dim=-1)


class DataEncoder(nn.Module):
    """Frozen predictors + trainable nets + autoencoder, and the bin edges."""

    def __init__(self, vec_dims: list, n_scalars: int, cfg: DataEncoderConfig,
                 *, device=None):
        super().__init__()
        self.cfg = cfg
        self.vec_dims = list(vec_dims)
        self.m = n_scalars
        b, t = cfg.n_bins, cfg.trainable_dim
        self.embed_dim = self.m * b + t + self.m * b  # E_vi ; E_s
        gen = torch.Generator().manual_seed(cfg.seed)
        self.frozen = nn.ModuleList(
            FrozenPredictors(d, n_scalars, cfg, generator=gen)
            for d in self.vec_dims)
        self.trainable = nn.ModuleList(
            MLP([d, cfg.frozen_hidden, cfg.trainable_dim], generator=gen)
            for d in self.vec_dims)
        self.ae_enc = MLP([self.embed_dim, cfg.ae_hidden, cfg.ae_latent],
                          generator=gen)
        self.ae_dec = MLP([cfg.ae_latent, cfg.ae_hidden, self.embed_dim],
                          generator=gen)
        self.register_buffer("edges", torch.zeros(n_scalars, b + 1))
        if device is not None:
            self.to(device)

    # -- embeddings ---------------------------------------------------------

    def evec(self, i: int, v: torch.Tensor) -> torch.Tensor:
        """E_vi = [frozen probs (M·B) ; trainable (T)] for column i."""
        fr = self.frozen[i](v)
        fr = fr.reshape(*fr.shape[:-2], -1)
        return torch.cat([fr, self.trainable[i](v)], dim=-1)

    def ae(self, e: torch.Tensor) -> torch.Tensor:
        return self.ae_dec(self.ae_enc(e))

    def _encode_values(self, scalars: torch.Tensor) -> torch.Tensor:
        """E_s of concrete rows: (n, M) -> (n, M·B) one-hot bins."""
        return value_encode(scalars, self.edges).reshape(scalars.shape[0], -1)

    def _ae_loss(self, vecs: list, es: torch.Tensor) -> torch.Tensor:
        """Mean over columns of the reconstruction MSE of [E_vi ; E_s]; the
        frozen predictors' outputs are constants (no gradient)."""
        loss = 0.0
        for i, v in enumerate(vecs):
            with torch.no_grad():
                fr = self.frozen[i](v)
            ev = torch.cat([fr.reshape(v.shape[0], -1), self.trainable[i](v)],
                           dim=-1)
            e = torch.cat([ev, es], dim=-1)
            loss = loss + torch.mean(torch.square(self.ae(e) - e))
        return loss / len(vecs)

    def _tuned_parameters(self) -> list:
        return [*self.trainable.parameters(), *self.ae_enc.parameters(),
                *self.ae_dec.parameters()]

    @torch.no_grad()
    def embed_rows(self, i: int, vecs: torch.Tensor, scalars: torch.Tensor
                   ) -> torch.Tensor:
        """[E_vi ; E_s] of table rows: vecs (n, d_i), scalars (n, M)."""
        return torch.cat([self.evec(i, vecs), self._encode_values(scalars)],
                         dim=-1)

    # -- training -----------------------------------------------------------

    def fit(self, table: Table) -> dict:
        cfg = self.cfg
        dev = table.device
        n = table.n_rows
        sub = np.random.default_rng(cfg.seed).choice(
            n, min(cfg.sample, n), replace=False)
        scal_all = table.scalars.cpu().numpy()
        scal_np = scal_all[sub]
        edges_np = _quantile_edges(scal_all, cfg.n_bins)
        self.edges = torch.as_tensor(edges_np, device=dev)
        labels = np.stack([
            np.clip(np.searchsorted(edges_np[j], scal_np[:, j], side="right")
                    - 1, 0, cfg.n_bins - 1)
            for j in range(self.m)], axis=1)  # (S, M)
        labels = torch.as_tensor(labels, dtype=torch.int64, device=dev)
        sub_t = torch.as_tensor(sub, dtype=torch.int64, device=dev)
        vec_subs = [v[sub_t] for v in table.vectors]
        opt_cfg = AdamWConfig(lr=cfg.lr, weight_decay=1e-4, grad_clip_norm=1.0)

        # ---- stage 1: frozen predictors (per vector column) ----
        metrics = {}
        rng = np.random.default_rng(cfg.seed + 1)
        for i in range(len(self.vec_dims)):
            fp = self.frozen[i]
            opt = optimizer.make_adamw(fp.parameters(), opt_cfg)
            for _ in range(cfg.frozen_steps):
                bidx = torch.as_tensor(rng.integers(0, len(sub), cfg.batch),
                                       device=dev)
                logp = torch.log_softmax(fp.logits(vec_subs[i][bidx]), dim=-1)
                loss = -logp.gather(-1, labels[bidx][:, :, None]).mean()
                optimizer.step(opt, loss, opt_cfg)
            metrics[f"frozen_loss_col{i}"] = float(loss.detach())

        # ---- stage 2: trainable + AE (frozen nets held fixed) ----
        es_all = self._encode_values(torch.as_tensor(scal_np, device=dev))
        opt = optimizer.make_adamw(self._tuned_parameters(), opt_cfg)
        for _ in range(cfg.ae_steps):
            bidx = torch.as_tensor(rng.integers(0, len(sub), cfg.batch),
                                   device=dev)
            loss = self._ae_loss([v[bidx] for v in vec_subs], es_all[bidx])
            optimizer.step(opt, loss, opt_cfg)
        metrics["ae_loss"] = float(loss.detach())
        return metrics

    def update(self, table: Table, new_rows: np.ndarray) -> dict:
        """Incremental fine-tune on the inserted rows only (paper: O(c·M̃)):
        the trainable nets and the autoencoder continue training for
        ``update_steps`` steps of AdamW at half the fit's rate, with a
        fresh optimizer state; the frozen predictors and the bin edges
        stay as they are."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + 2)
        rows = torch.as_tensor(np.asarray(new_rows), dtype=torch.int64,
                               device=table.device)
        es_new = self._encode_values(table.scalars[rows])
        vec_new = [v[rows] for v in table.vectors]
        opt_cfg = AdamWConfig(lr=cfg.lr * 0.5, weight_decay=1e-4)
        opt = optimizer.make_adamw(self._tuned_parameters(), opt_cfg)
        nb = int(rows.shape[0])
        loss = torch.zeros(())
        for _ in range(cfg.update_steps):
            bidx = torch.as_tensor(rng.integers(0, nb, min(cfg.batch, nb)),
                                   device=table.device)
            loss = self._ae_loss([v[bidx] for v in vec_new], es_new[bidx])
            optimizer.step(opt, loss, opt_cfg)
        return {"ae_update_loss": float(loss.detach())}

    # -- query phase --------------------------------------------------------

    @torch.no_grad()
    def recon_errors_batch(self, qv_b: tuple, pred_b) -> torch.Tensor:
        """ε_recon per query and vector column: qv_b per-column (B, d_i),
        pred_b a batched predicate -> (B, N)."""
        b = qv_b[0].shape[0]
        es = soft_encode(pred_b, self.edges).reshape(b, -1)
        errs = []
        for i, q in enumerate(qv_b):
            e = torch.cat([self.evec(i, q), es], dim=-1)
            errs.append(torch.mean(torch.square(self.ae(e) - e), dim=-1))
        return torch.stack(errs, dim=-1)

    def recon_errors(self, query_vectors: list, pred: PredicateLike
                     ) -> torch.Tensor:
        """ε_recon per vector column for one query (paper 'Query Phase')."""
        return self.recon_errors_batch(
            tuple(q[None] for q in query_vectors), stack([pred]))[0]
