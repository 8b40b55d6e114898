"""Carry the JAX package's trained state across to the port.

Every function takes plain numpy arrays (and nested dicts / lists of them,
in the JAX package's own parameter layout) and returns the port's objects
on ``device``. Nothing here imports JAX: the caller exports with
``np.asarray`` (e.g. ``jax.tree_util.tree_map(np.asarray, params)``).

Covered: ``IVFIndex``, ``GraphIndex``, ``Histograms``, ``DataEncoder``
parameters and bin edges, ``MHQRewriter`` parameters and the query
encoder's S_enc edges — and ``boomhq``, which assembles a fitted ``BoomHQ``
from all of them; ``cold_state`` and ``tiered_snapshot`` carry a tiered
table's epoch (cold state and hot buffers) across mid-stream;
``sharded_ivf`` carries a ``ShardedIVF`` (per-shard indexes), or one
shard's slice of it for a mesh rank, across; ``lm_params`` carries an
LM's ``lm.init`` tree (any family, MTP included, f32 or bf16) into an
``lm.LM``, and ``lm_tree`` takes the port's parameters (or an optimizer
state keyed by them) back to that layout.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.common.device import resolve_device
from repro_torch.common.nn import MLP
from repro_torch.core.boomhq import BoomHQ, BoomHQConfig
from repro_torch.core.data_encoder import DataEncoder
from repro_torch.core.executor import PGVECTOR
from repro_torch.core.query_encoder import QueryEncoder
from repro_torch.core.rewriter import MHQRewriter
from repro_torch.models import lm
from repro_torch.vectordb.graph import GraphIndex
from repro_torch.vectordb.distributed import ShardedIVF
from repro_torch.vectordb.histogram import Histograms
from repro_torch.vectordb.ivf import IVFIndex
from repro_torch.vectordb.table import Table
from repro_torch.vectordb.tiered import ColdState, HotView, TieredSnapshot


def _t(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def ivf_index(centroids, sorted_rows, offsets, metric: str, *,
              device=None) -> IVFIndex:
    dev = resolve_device(device)
    return IVFIndex(centroids=_t(centroids, dev),
                    sorted_rows=_t(sorted_rows, dev, torch.int32),
                    offsets=_t(offsets, dev, torch.int32), metric=metric)


def sharded_ivf(centroids, sorted_rows, offsets, metric: str, *,
                shard=None, device=None) -> ShardedIVF:
    """A JAX ``ShardedIVF`` (per-shard ``centroids`` (S, C, d), local
    ``sorted_rows`` (S, shard_len) and ``offsets`` (S, C+1)) as the
    port's: the same arrays give the same per-shard probes. With ``shard``
    only that shard's slice is carried, as a one-shard ``ShardedIVF``: the
    index a mesh rank holding that shard probes."""
    dev = resolve_device(device)
    part = slice(None) if shard is None else slice(shard, shard + 1)
    return ShardedIVF(
        centroids=_t(np.asarray(centroids)[part], dev),
        sorted_rows=_t(np.asarray(sorted_rows)[part], dev, torch.int32),
        offsets=_t(np.asarray(offsets)[part], dev, torch.int32),
        metric=metric)


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


def _indexes(dicts: list, device) -> list:
    return [ivf_index(d["centroids"], d["sorted_rows"], d["offsets"],
                      d["metric"], device=device) for d in dicts]


def _graphs(dicts, device):
    if dicts is None:
        return None
    return tuple(graph_index(d["neighbors"], d["entry_points"], d["metric"],
                             device=device) for d in dicts)


def boomhq(table, cfg: BoomHQConfig, state: dict, engine=PGVECTOR
           ) -> BoomHQ:
    """A fitted ``BoomHQ`` on ``table``'s device from the JAX package's
    exported state: ``indexes`` (list of dicts with ``centroids``,
    ``sorted_rows``, ``offsets``, ``metric``), ``hists`` (``edges``,
    ``prefix``, ``n_rows``), ``qenc_edges``, ``rewriter`` (``params``,
    ``in_dim``), when the encoder is on ``data_encoder`` (``params``,
    ``edges``), and optionally ``graphs`` (list of dicts with
    ``neighbors``, ``entry_points``, ``metric``; without it a graph tier
    is built as ``cfg.graph_degree`` says)."""
    dev = table.device
    h = state["hists"]
    bq = BoomHQ(table, cfg, engine, indexes=_indexes(state["indexes"], dev),
                hists=histograms(h["edges"], h["prefix"], h["n_rows"],
                                 device=dev),
                graphs=_graphs(state.get("graphs"), dev))
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


def cold_state(schema, vectors: list, scalars, indexes: list, hists: dict,
               graphs=None, *, device=None) -> ColdState:
    """A JAX ``tiered.ColdState`` as the port's: the table's ``vectors``
    and ``scalars`` (numpy) under the port's ``schema``, ``indexes``,
    ``hists`` and ``graphs`` as in ``boomhq``'s state (``graphs`` None
    without a graph tier)."""
    dev = resolve_device(device)
    table = Table.from_numpy(schema, [np.asarray(v) for v in vectors],
                             np.asarray(scalars), device=dev)
    return ColdState(table, tuple(_indexes(indexes, dev)),
                     histograms(hists["edges"], hists["prefix"],
                                hists["n_rows"], device=dev),
                     _graphs(graphs, dev))


def tiered_snapshot(epoch: int, cold: ColdState, hot_views: list
                    ) -> TieredSnapshot:
    """A JAX ``tiered.TieredSnapshot`` as the port's, on ``cold``'s device:
    ``cold`` from ``cold_state``, ``hot_views`` one dict per view with its
    full-capacity host buffers ``np_vectors`` and ``np_scalars``, its
    ``count`` and ``id_offset`` (copied, so the JAX side's later appends
    never reach them)."""
    views = tuple(
        HotView(tuple(np.array(b, np.float32) for b in v["np_vectors"]),
                np.array(v["np_scalars"], np.float32), int(v["count"]),
                int(v["id_offset"]), cold.table.device)
        for v in hot_views)
    return TieredSnapshot(epoch=int(epoch), cold=cold, hot_views=views)


_STACKS = ("blocks", "dense_blocks", "moe_blocks")


def lm_names(params: dict) -> set:
    """The port's parameter names for the leaves of a JAX ``lm.init`` tree
    (any family): leaf ``a/b/c`` is ``a.b.c``, the hybrid's one
    ``shared_attn`` block and the ``mtp`` subtree included; a stacked
    ``<stack>/<path>`` leaf (``blocks``, or the moe family's
    ``dense_blocks`` and ``moe_blocks``) is ``<stack>.{i}.<path>`` for
    each layer i of its leading axis."""
    out = set()

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
            elif path[:1] and path[0] in _STACKS:
                out.update(".".join([path[0], str(i), *path[1:], k])
                           for i in range(np.shape(v)[0]))
            else:
                out.add(".".join([*path, k]))

    walk(params, [])
    return out


def lm_leaf(params: dict, name: str) -> np.ndarray:
    """The JAX ``lm.init`` leaf behind the port's parameter ``name``:
    ``<stack>.{i}.<path>`` is layer i of the stacked ``<stack>/<path>``."""
    parts = name.split(".")
    if parts[0] in _STACKS:
        node, layer, parts = params[parts[0]], int(parts[1]), parts[2:]
    else:
        node, layer = params, None
    for k in parts:
        node = node[k]
    return np.asarray(node) if layer is None else np.asarray(node)[layer]


def lm_params(params: dict, cfg, *, device=None) -> lm.LM:
    """A JAX ``lm.init(key, cfg)`` tree (numpy leaves, block leaves stacked
    on axis 0; f32, or bf16 where ``cfg.param_dtype`` says so) as the
    port's ``lm.LM`` on ``device``, leaf for leaf: the two must have the
    same names, shapes and dtypes."""
    model = lm.LM(cfg, device=device)
    names = dict(model.named_parameters())
    if set(names) != lm_names(params):
        raise ValueError("the JAX tree's leaves and the port's parameters "
                         f"differ: {sorted(set(names) ^ lm_names(params))}")
    with torch.no_grad():
        for name, t in names.items():
            a = lm_leaf(params, name)
            if tuple(a.shape) != tuple(t.shape) or \
                    str(a.dtype) != str(t.dtype).removeprefix("torch."):
                raise ValueError(f"{name}: JAX leaf {a.shape} {a.dtype}, "
                                 f"port {tuple(t.shape)} {t.dtype}")
            # numpy has no bf16 of its own: carry the values through f32,
            # which holds every bf16 value exactly
            t.copy_(torch.tensor(a.astype(np.float32)))
    return model


def _numpy(v):
    """A tensor (bf16 through f32, which holds it exactly: numpy has no
    bf16 of its own) or a dict of them, as numpy."""
    if isinstance(v, dict):
        return {k: _numpy(x) for k, x in v.items()}
    t = v.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _stacked(vals: list):
    if isinstance(vals[0], dict):
        return {k: _stacked([v[k] for v in vals]) for k in vals[0]}
    return np.stack(vals)


def lm_tree(named) -> dict:
    """The inverse of ``lm_params``: an ``lm.LM``'s parameters, or a dict
    by the port's parameter names of tensors or of dicts of tensors (an
    optimizer's moments: ``{"q", "scale"}``, ``{"vr", "vc"}``), as the
    JAX ``lm.init`` tree of numpy leaves: ``a.b.c`` at ``a/b/c``, and a
    stack's ``<stack>.{i}.<path>`` for every layer i stacked on axis 0 at
    ``<stack>/<path>``. bf16 leaves come back as f32 arrays of the same
    values."""
    if isinstance(named, nn.Module):
        named = dict(named.named_parameters())
    tree: dict = {}
    layers: dict = {}

    def put(path, v):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v

    for name, v in named.items():
        parts = name.split(".")
        if parts[0] in _STACKS:
            layers.setdefault((parts[0], *parts[2:]), {})[int(parts[1])] = \
                _numpy(v)
        else:
            put(parts, _numpy(v))
    for path, by_layer in layers.items():
        put(path, _stacked([by_layer[i] for i in range(len(by_layer))]))
    return tree
