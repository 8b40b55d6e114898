"""Carry the JAX package's trained state across to the port.

Every function takes plain numpy arrays (and nested dicts / lists of them,
in the JAX package's own parameter layout) and returns the port's objects
on ``device``. Nothing here imports JAX: the caller exports with
``np.asarray`` (e.g. ``jax.tree_util.tree_map(np.asarray, params)``).

Covered: ``IVFIndex``, ``GraphIndex``, ``Histograms``, ``DataEncoder``
parameters and bin edges, ``MHQRewriter`` parameters and the query
encoder's S_enc edges — and ``boomhq``, which assembles a fitted ``BoomHQ``
from all of them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.nn import MLP
from repro_torch.core.boomhq import BoomHQ, BoomHQConfig
from repro_torch.core.data_encoder import DataEncoder
from repro_torch.core.executor import PGVECTOR
from repro_torch.core.query_encoder import QueryEncoder
from repro_torch.core.rewriter import MHQRewriter
from repro_torch.vectordb.graph import GraphIndex
from repro_torch.vectordb.histogram import Histograms
from repro_torch.vectordb.ivf import IVFIndex


def _t(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def ivf_index(centroids, sorted_rows, offsets, metric: str, *,
              device=None) -> IVFIndex:
    dev = resolve_device(device)
    return IVFIndex(centroids=_t(centroids, dev),
                    sorted_rows=_t(sorted_rows, dev, torch.int32),
                    offsets=_t(offsets, dev, torch.int32), metric=metric)


def graph_index(neighbors, entry_points, metric: str, *,
                device=None) -> GraphIndex:
    """(n, R) adjacency (-1 = free slot) and (E,) entry points."""
    dev = resolve_device(device)
    return GraphIndex(neighbors=_t(neighbors, dev, torch.int32),
                      entry_points=_t(entry_points, dev, torch.int32),
                      metric=metric)


def histograms(edges, prefix, n_rows, *, device=None) -> Histograms:
    dev = resolve_device(device)
    return Histograms(edges=_t(edges, dev), prefix=_t(prefix, dev),
                      n_rows=_t(n_rows, dev))


def _load_mlp(mlp: MLP, params: dict) -> None:
    """``{"l0": {"w", "b"}, ...}`` -> an ``MLP`` (weights keep (in, out))."""
    if len(params) != len(mlp.layers):
        raise ValueError(f"{len(params)} layers given, MLP has "
                         f"{len(mlp.layers)}")
    with torch.no_grad():
        for i, layer in enumerate(mlp.layers):
            p = params[f"l{i}"]
            layer.w.copy_(_t(p["w"], layer.w.device))
            if layer.b is not None:
                layer.b.copy_(_t(p["b"], layer.b.device))


def data_encoder(params: dict, edges, vec_dims: list, n_scalars: int, cfg, *,
                 device=None) -> DataEncoder:
    """``params``: the JAX ``DataEncoder.params`` dict — ``frozen`` (per
    column ``w0/b0/w1/b1`` stacks), ``trainable`` (per column MLPs),
    ``ae_enc`` and ``ae_dec``; ``edges`` its (M, B+1) bin edges."""
    dev = resolve_device(device)
    de = DataEncoder(vec_dims, n_scalars, cfg, device=dev)
    with torch.no_grad():
        for fp, p in zip(de.frozen, params["frozen"]):
            for name in ("w0", "b0", "w1", "b1"):
                getattr(fp, name).copy_(_t(p[name], dev))
    for mlp, p in zip(de.trainable, params["trainable"]):
        _load_mlp(mlp, p)
    _load_mlp(de.ae_enc, params["ae_enc"])
    _load_mlp(de.ae_dec, params["ae_dec"])
    de.edges = _t(edges, dev)
    return de


def rewriter(params: dict, in_dim: int, n_vec: int, cfg, *,
             device=None) -> MHQRewriter:
    """``params``: the JAX ``MHQRewriter.params`` dict (``trunk``,
    ``strategy``, ``per_col``, ``precision``, ``graph``)."""
    rw = MHQRewriter(in_dim, n_vec, cfg, device=resolve_device(device))
    for name in ("trunk", "strategy", "per_col", "precision", "graph"):
        _load_mlp(getattr(rw, name), params[name])
    return rw


def boomhq(table, cfg: BoomHQConfig, state: dict, engine=PGVECTOR
           ) -> BoomHQ:
    """A fitted ``BoomHQ`` on ``table``'s device from the JAX package's
    exported state: ``indexes`` (list of dicts with ``centroids``,
    ``sorted_rows``, ``offsets``, ``metric``), ``hists`` (``edges``,
    ``prefix``, ``n_rows``), ``qenc_edges``, ``rewriter`` (``params``,
    ``in_dim``) and, when the encoder is on, ``data_encoder``
    (``params``, ``edges``)."""
    dev = table.device
    idxs = [ivf_index(d["centroids"], d["sorted_rows"], d["offsets"],
                      d["metric"], device=dev) for d in state["indexes"]]
    h = state["hists"]
    bq = BoomHQ(table, cfg, engine, indexes=idxs,
                hists=histograms(h["edges"], h["prefix"], h["n_rows"],
                                 device=dev))
    if bq.data_encoder is not None:
        d = state["data_encoder"]
        bq.data_encoder = data_encoder(
            d["params"], d["edges"], [v.shape[1] for v in table.vectors],
            table.schema.n_scalar, cfg.encoder, device=dev)
    bq.qenc = QueryEncoder(table, bq.indexes, bq.hists, bq.data_encoder)
    bq.qenc._edges = _t(state["qenc_edges"], dev)
    r = state["rewriter"]
    bq.rewriter = rewriter(r["params"], int(r["in_dim"]), table.schema.n_vec,
                           cfg.rewriter, device=dev)
    bq._fitted = True
    return bq
