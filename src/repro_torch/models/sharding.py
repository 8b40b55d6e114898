"""Partition specs for DP / TP / EP / FSDP / SP, and their DTensor
placements.

Port of ``repro.models.sharding``. Layout on the production mesh:
  * batch dims            -> data axes ("data", or ("pod","data") multi-pod)
  * attention heads / ffn -> "model" (Megatron column/row parallel)
  * MoE experts           -> "model" (expert parallel)
  * FSDP (giants only)    -> the non-model dim of each large weight also
                             shards over "data" (ZeRO-3)
  * Mamba2 heads          -> "model" (the z/x/dt streams; B,C replicated)
  * decode KV caches      -> sequence dim over "model" (context parallelism)

A spec is a tuple with one entry per tensor dimension: a mesh axis name,
a tuple of them (one dimension over several axes, major first), or
``None``; ``()`` replicates (JAX's ``PartitionSpec`` is not the port's).

Parameter paths follow ``convert.lm_names``: the port's ``<stack>.{i}.
<path>`` is the reference's stacked ``<stack>/<path>`` (``ref_path``).
The port keeps one tensor a layer, so its spec is the reference's stacked
spec without the leading ``None``; ``common/nn.Linear`` stores (in, out)
as JAX does, so no dimension is permuted.

DTensor stands where the reference has GSPMD: ``placements`` turns a spec
into one ``Shard(d)`` or ``Replicate()`` per mesh dimension, and
``place_model`` / ``place_tree`` make a model's parameters, or a tree of
tensors, DTensors placed by their specs; DTensor's sharding propagation
then plays XLA's partitioner. ``constrain_batch`` redistributes a
DTensor's batch dimension onto the data axes (the reference's
``with_sharding_constraint`` with every other dimension unconstrained),
and is the identity outside an ``act_axes`` context or on a plain tensor.
"""
from __future__ import annotations

import contextlib
import contextvars
import re

import torch

from repro_torch.configs.base import ModelConfig

MODEL = "model"
STACKS = ("blocks", "dense_blocks", "moe_blocks")


def _rule_table(fsdp_axis, moe_shard_ffn_dim: bool = False):
    """Ordered (regex, base-spec) table over the reference's paths. First
    match wins. ``F`` marks the FSDP axis slot (None when FSDP is off).
    ``moe_shard_ffn_dim`` places the experts' second shard axis on the FFN
    dim instead of d_model (the weight-stationary serving layout)."""
    F = fsdp_axis
    if moe_shard_ffn_dim:
        moe_rules = [
            (r"moe/router$", (F, None)),
            (r"moe/shared/w_(up|gate)$", (F, MODEL)),
            (r"moe/shared/w_down$", (MODEL, F)),
            (r"moe/w_(up|gate)$", (MODEL, None, F)),
            (r"moe/w_down$", (MODEL, F, None)),
        ]
    else:
        moe_rules = [
            (r"moe/router$", (F, None)),
            (r"moe/shared/w_(up|gate)$", (F, MODEL)),
            (r"moe/shared/w_down$", (MODEL, F)),
            (r"moe/w_(up|gate)$", (MODEL, F, None)),
            (r"moe/w_down$", (MODEL, None, F)),
        ]
    return moe_rules + [
        # embedding / head
        (r"embed/table$", (MODEL, None)),
        (r"lm_head/w$", (None, MODEL)),
        (r"patch_proj/w$", (None, None)),
        (r"patch_proj/b$", (None,)),
        # MLA
        (r"attn/wq_a$", (F, MODEL)),
        (r"attn/wq_b$", (None, MODEL)),
        (r"attn/wkv_a$", (MODEL, None)),   # row-parallel; 576-wide output
        (r"attn/wkv_b$", (None, MODEL)),
        (r"attn/(q_norm|kv_norm|k_norm)/scale$", (None,)),
        # GQA
        (r"attn/w[qkv]$", (F, MODEL)),
        (r"attn/wo$", (MODEL, F)),
        # dense FFN
        (r"ffn/w_(up|gate)$", (F, MODEL)),
        (r"ffn/w_down$", (MODEL, F)),
        # Mamba2 (heads on model; B/C replicated)
        (r"mamba/in_z$", (F, MODEL)),
        (r"mamba/in_x$", (F, MODEL)),
        (r"mamba/in_bc$", (F, None)),
        (r"mamba/in_dt$", (F, None)),
        (r"mamba/conv_x_w$", (None, MODEL)),
        (r"mamba/conv_x_b$", (MODEL,)),
        (r"mamba/conv_bc_(w|b)$", None),  # replicate
        (r"mamba/(A_log|D|dt_bias)$", (None,)),
        (r"mamba/norm/scale$", (MODEL,)),
        (r"mamba/out_proj$", (MODEL, F)),
        # mtp glue
        (r"mtp/proj/w$", (None, None)),
        (r"mtp/proj/b$", (None,)),
        # norms (catch-all)
        (r"(norm1|norm2|final_norm|norm_h|norm_e|norm_f|norm)/(scale|bias)$",
         None),
    ]


def ref_path(name: str) -> str:
    """The reference's path of the port's parameter ``name``:
    ``<stack>.{i}.<path>`` -> ``<stack>/<path>``, else dots -> slashes."""
    parts = name.split(".")
    if parts[0] in STACKS and len(parts) > 2 and parts[1].isdigit():
        parts = [parts[0], *parts[2:]]
    return "/".join(parts)


def spec_for_path(path: str, ndim: int, fsdp_axis=None,
                  moe_shard_ffn_dim: bool = False) -> tuple:
    """The spec of a leaf at the reference's ``path`` of rank ``ndim``: the
    rule's base spec, with a leading ``None`` for a leaf one rank above it
    (the reference's stacked layer dim), ``()`` for another rank."""
    for pat, base in _rule_table(fsdp_axis, moe_shard_ffn_dim):
        if re.search(pat, path):
            if base is None:
                return ()
            base = tuple(base)
            if ndim == len(base) + 1:  # stacked layer dim
                return (None, *base)
            if ndim == len(base):
                return base
            return ()  # rank mismatch (e.g. a scalar leaf): replicate
    return ()


def _named(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_specs(cfg: ModelConfig, params, *, fsdp: bool = False,
                fsdp_axis="data", moe_shard_ffn_dim: bool = False) -> dict:
    """{parameter name: spec} for an ``lm.LM`` (or a dict of its tensors
    by name; meta tensors do)."""
    F = fsdp_axis if fsdp else None
    return {name: spec_for_path(ref_path(name), t.ndim, F, moe_shard_ffn_dim)
            for name, t in _named(params).items()}


_MOMENT_TAILS = ("vr", "vc", "v", "q", "scale")


def _moment_spec(path: str, shape, flat_p: dict) -> tuple:
    """The reference's rule for one optimizer-state leaf at the reference's
    path ``m/<param path>[/tail]``: float moments inherit their
    parameter's spec; an int8 ``scale`` (..., 1) its spec with the last
    dim unsharded; Adafactor's ``vr``/``vc`` drop the reduced dim. Like the
    reference, a parameter whose own leaf name is ``scale`` (a norm's) is
    read as an int8 scale at a full moment's rank."""
    parts = path.split("/")
    tail = parts[-1]
    core = "/".join(parts[1:-1] if tail in _MOMENT_TAILS else parts[1:])
    base = flat_p.get(core) or flat_p.get("/".join(parts[1:]))
    if base is None:
        return ()
    bs, nd = tuple(base), len(shape)
    if tail == "vr":
        return bs[:-1] if len(bs) == nd + 1 else ()
    if tail == "vc":
        return bs[:-2] + bs[-1:] if len(bs) == nd + 1 else ()
    if tail == "scale" and len(bs) == nd:
        return (*bs[:-1], None)
    if len(bs) == nd:
        return bs
    return ()


def opt_state_specs(param_spec: dict, opt_state: dict) -> dict:
    """Specs of an optimizer state (``{"step", "m", "v"}``, each moment a
    dict by parameter name of a tensor or of ``{"q", "scale"}`` /
    ``{"vr", "vc"}`` / ``{"v"}``), in its structure; ``step`` replicates."""
    flat_p = {ref_path(n): s for n, s in param_spec.items()}

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{ref_path(k) if '.' in k else k}")
                    for k, v in node.items()}
        if path.split("/")[1] not in ("m", "v"):
            return ()
        return _moment_spec(path[1:], tuple(node.shape), flat_p)

    return walk(opt_state, "")


# ---------------------------------------------------------------------------
# batch / cache / activation specs
# ---------------------------------------------------------------------------

def _batch_axis(data_axes):
    d = tuple(data_axes)
    return d if len(d) > 1 else d[0]


def batch_specs(cfg: ModelConfig, batch: dict, data_axes=("data",)) -> dict:
    """Inputs: batch dim over the data axes, everything else unsharded."""
    ax = _batch_axis(data_axes)
    return {k: (ax, *([None] * (v.ndim - 1))) for k, v in batch.items()}


def cache_specs(cfg: ModelConfig, cache: dict, data_axes=("data",), *,
                shard_batch: bool = True) -> dict:
    """Decode caches (``lm.make_cache``'s, layers stacked on axis 0): B over
    data, S over model for attention caches (context parallelism); the
    mamba state shards heads, its x window channels, over model. With
    batch 1 (long_500k) ``shard_batch=False`` keeps B whole."""
    bax = _batch_axis(data_axes) if shard_batch else None

    def one(path: str, leaf) -> tuple:
        if "conv_x" in path:  # (L, B, w-1, di)
            return (None, bax, None, MODEL)
        if "conv_bc" in path:  # (L, B, w-1, 2gn)
            return (None, bax, None, None)
        if path.endswith("state"):  # (L, B, H, N, P)
            return (None, bax, MODEL, None, None)
        if "c_kv" in path or "k_rope" in path:  # MLA: (L, B, S, r)
            return (None, bax, MODEL, None)
        if leaf.ndim == 5:  # GQA k/v: (L, B, S, KV, hd)
            return (None, bax, MODEL, None, None)
        return ()

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        return one(path, node)

    return walk(cache, "")


def activation_spec(data_axes=("data",), *, seq_shard: bool = False
                    ) -> tuple:
    """Residual-stream (B, S, D) spec for the layer loop's carry."""
    return (_batch_axis(data_axes), MODEL if seq_shard else None, None)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: tuple, mesh, shape=None) -> list:
    """One placement per mesh dimension: ``Shard(d)`` where tensor dim d's
    entry names that mesh axis (alone or in a tuple), else
    ``Replicate()``. A dim over several axes is split major axis first,
    as the mesh's dims are ordered. With the tensor's ``shape``, a dim is
    split only over those of its axes that divide it evenly
    (``even_axes``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    known = set(names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for ax in axes:
            if ax not in known:
                raise ValueError(f"spec {spec} names {ax!r}, not a "
                                 f"dimension of the mesh {names}")
        if shape is not None:
            axes = even_axes(axes, mesh, shape[d])
        for ax in axes:
            out[names.index(ax)] = Shard(d)
    return out


def even_axes(axes: tuple, mesh, n: int) -> tuple:
    """Of the mesh ``axes`` one tensor dim of size ``n`` lies over, those
    (in order) whose sizes' product is the largest that divides ``n``,
    the minor axes first among equals; the others keep the dim whole. The
    reference's GSPMD pads an uneven dim (16 microbatch rows over 2×16
    data devices hold 16 rows and 16 of padding); DTensor would cut it
    into unequal shards, and ``local_map`` (``shard_map``) infers a global
    size from the local one, wrong for an unequal shard. Replicating over
    the axes left out gives each device the same rows as the padded
    layout does."""
    sizes = [mesh.size(mesh.mesh_dim_names.index(a)) for a in axes]
    best, best_n = (), 1
    for mask in range(1 << len(axes)):
        pick = [i for i in range(len(axes)) if mask >> i & 1]
        prod = 1
        for i in pick:
            prod *= sizes[i]
        if n % prod == 0 and (prod > best_n or prod == best_n
                              and sum(pick) > sum(best)):
            best, best_n = tuple(pick), prod
    return tuple(axes[i] for i in best)


def place(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """``t`` (the whole tensor, alike on every rank: each rank keeps its
    part, nothing is sent) as a DTensor placed by ``spec``; a DTensor is
    redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = placements(spec, mesh)
    if isinstance(t, DTensor):
        return t.redistribute(mesh, pl)
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


@torch.no_grad()
def place_model(model: torch.nn.Module, mesh, specs: dict
                ) -> torch.nn.Module:
    """Replace every parameter of ``model`` in place by a DTensor parameter
    placed by ``specs[name]``. -> model."""
    for name, _ in list(model.named_parameters()):
        *path, leaf = name.split(".")
        mod = model.get_submodule(".".join(path)) if path else model
        old = mod._parameters[leaf]
        mod._parameters[leaf] = torch.nn.Parameter(
            place(old.data, specs[name], mesh),
            requires_grad=old.requires_grad)
    return model


def place_tree(tree, specs, mesh):
    """A tree (nested dicts) of tensors as DTensors placed by the same
    tree of specs."""
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], mesh) for k, v in tree.items()}
    return place(tree, specs, mesh)


# ---------------------------------------------------------------------------
# activation-sharding context: batch-dim constraints inside the model
# ---------------------------------------------------------------------------
# Propagation can lose the batch dim through the reshape/transpose-heavy
# attention and MoE interiors and replicate the batch across `data` (the
# reference saw 16x redundant attention compute on deepseek prefill). The
# fix is a hard constraint on the batch dim only, every other dim left as
# propagation placed it.

_ACT_CTX = contextvars.ContextVar("repro_torch_act_ctx", default=None)


@contextlib.contextmanager
def act_axes(batch_axis, model_axis: str = MODEL, mesh=None):
    """Enable batch-dim constraints (and mesh-aware layers) inside."""
    tok = _ACT_CTX.set({"batch": batch_axis, "model": model_axis,
                        "mesh": mesh} if batch_axis is not None else None)
    try:
        yield
    finally:
        _ACT_CTX.reset(tok)


def with_act_axes(fn, batch_axis, model_axis: str = MODEL, mesh=None):
    def wrapped(*a, **kw):
        with act_axes(batch_axis, model_axis, mesh):
            return fn(*a, **kw)

    return wrapped


def act_ctx():
    return _ACT_CTX.get()


def constrain_batch(x, batch_dim: int = 0):
    """Pin x's batch dim to the context's data axes, other dims as they
    are (a mesh dim that sharded the batch dim elsewhere replicates). The
    identity outside a context or on a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    ctx = _ACT_CTX.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    bd = batch_dim % x.ndim
    axes = even_axes(ctx["batch"] if isinstance(ctx["batch"], tuple)
                     else (ctx["batch"],), mesh, x.shape[bd])
    want = []
    for name, p in zip(mesh.mesh_dim_names, x.placements):
        if name in axes:
            want.append(Shard(bd))
        elif isinstance(p, Shard) and p.dim == bd:
            want.append(Replicate())
        else:
            want.append(p)
    return _pinned(x if want == list(x.placements)
                   else x.redistribute(mesh, want))


# ---------------------------------------------------------------------------
# shard_map: the reference's per-device bodies, on DTensors
# ---------------------------------------------------------------------------

class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def shard_map(fn, mesh, in_specs, out_specs):
    """``fn`` over each rank's local tensors, as the reference's
    ``shard_map(fn, mesh, in_specs, out_specs)`` with ``check_vma=False``:
    ``local_map`` with the specs' placements (inputs redistributed to
    them), the body's collectives its own. Gradients follow the
    reference's transpose: an output whole over some mesh dims has its
    cotangent divided by their size before the body's backward, and an
    input whole over some mesh dims gets a gradient that is a partial sum
    over them."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    in_pl = tuple(placements(s, mesh) for s in in_specs)
    grad_pl = tuple([Partial() if isinstance(p, Replicate) else p
                     for p in pls] for pls in in_pl)
    out_pl = tuple(placements(s, mesh) for s in out_specs)
    scales = []
    for pls in out_pl:
        n = 1
        for i, p in enumerate(pls):
            if isinstance(p, Replicate):
                n *= mesh.size(i)
        scales.append(1.0 / n)

    def body(*args):
        # the inputs' gradients leave contiguous: torch 2.11's DTensor
        # runs a view of a global tensor as a ``view`` of its local shard,
        # which a permuted gradient (an einsum's) cannot always take
        outs = fn(*(_ContiguousGrad.apply(a) if a.requires_grad else a
                    for a in args))
        return tuple(_ScaleGrad.apply(o, s) if o.requires_grad and s != 1.0
                     else o for o, s in zip(outs, scales))

    return local_map(body, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)


def constrain(x, spec: tuple):
    """A DTensor ``x`` redistributed to ``spec`` on its mesh (the
    reference's ``with_sharding_constraint``); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    pl = placements(spec, x.device_mesh, x.shape)
    return _pinned(x if list(x.placements) == pl
                   else x.redistribute(x.device_mesh, pl))


class _PinGrad(torch.autograd.Function):
    """Identity whose backward brings the gradient to the forward's
    placements: a sharding constraint holds for the cotangent too, as
    JAX's ``with_sharding_constraint`` does."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate

        # a partial sum's gradient is whole
        ctx.mesh = x.device_mesh
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def _pinned(x):
    return _PinGrad.apply(x) if x.requires_grad else x


def settle(x):
    """A DTensor ``x`` with its partial sums reduced (``Partial`` ->
    ``Replicate``), other placements kept, its gradient whole; a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(x, DTensor) or not any(
            isinstance(p, Partial) for p in x.placements):
        return x
    return _Settle.apply(x, [Replicate() if isinstance(p, Partial) else p
                             for p in x.placements])


class _Settle(torch.autograd.Function):
    """The reduction of partial sums (the Megatron all-reduce). Its
    backward gives every rank's part the whole cotangent: a cotangent that
    arrives as a partial sum (the residual stream's, from the
    column-parallel products after it) is reduced first, where DTensor's
    own would pass it on partial and the products before it would gather
    their weights."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.redistribute(x.device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        if any(p.is_partial() for p in g.placements):
            g = g.redistribute(g.device_mesh, ctx.pl)
        return g, None


def rows_of(x):
    """The mesh axes that shard a DTensor's dim 0, its batch rows, as a
    spec entry: one axis name, a tuple of several, or None."""
    from torch.distributed.tensor import Shard

    rows = tuple(n for n, p in zip(x.device_mesh.mesh_dim_names,
                                   x.placements)
                 if isinstance(p, Shard) and p.dim == 0)
    return (rows if len(rows) > 1 else rows[0]) if rows else None


def spec_of(x) -> tuple:
    """The spec of a DTensor's placements (``Shard`` dims by mesh axis
    name; ``Partial`` is not a spec and raises)."""
    from torch.distributed.tensor import Replicate, Shard

    dims: list = [[] for _ in range(x.ndim)]
    for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
        if isinstance(p, Shard):
            dims[p.dim].append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"{p} has no spec")
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in dims)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, table)``. On DTensors with the table's rows
    sharded (the vocab-parallel embedding, ``embed/table`` (model, None)):
    each rank looks up the ids in its rows, zeroes the others, and the
    parts are summed over the rows' mesh dims, through ``shard_map`` with
    the table's and the ids' specs (DTensor's own masked-partial lookup
    cannot carry a gradient through a settled sum)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(table, DTensor):
        return torch.nn.functional.embedding(ids, table)
    from repro_torch.common.mesh import psum

    mesh = table.device_mesh
    t_spec, i_spec = spec_of(table), spec_of(ids)
    rows = t_spec[0] if t_spec else None
    axes = () if rows is None else rows if isinstance(rows, tuple) \
        else (rows,)
    n_rows = table.shape[0]

    def local(t, i):
        if not axes:
            return (torch.nn.functional.embedding(i, t),)
        shard = 0
        for a in axes:
            d = mesh.mesh_dim_names.index(a)
            shard = shard * mesh.size(d) + mesh.get_coordinate()[d]
        n = 1
        for a in axes:
            n *= mesh.size(mesh.mesh_dim_names.index(a))
        lo = shard * (-(-n_rows // n))
        mine = (i >= lo) & (i < lo + t.shape[0])
        out = torch.nn.functional.embedding(torch.where(mine, i - lo, 0), t)
        out = out * mine[..., None].to(out.dtype)
        for a in axes:
            out = psum(out, mesh.get_group(a))
        return (out,)

    (out,) = shard_map(local, mesh, in_specs=(t_spec, i_spec),
                       out_specs=((*i_spec, None),))(table, ids)
    return out


def whole(x):
    """A DTensor ``x`` whole on every mesh dim but those sharding its batch
    dim (partial sums reduced, other shards gathered), its cotangent held
    there too; a plain tensor as it is. For a product's output that the
    next product contracts whole (MLA's low-rank streams)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    x = settle(x)
    pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in x.placements]
    return _pinned(x if pl == list(x.placements)
                   else x.redistribute(x.device_mesh, pl))
