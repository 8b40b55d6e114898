"""Fault-tolerant checkpointing of nested dicts of tensors.

Port of ``repro.checkpoint.ckpt``, in its layout and with its guarantees::

    <root>/step_<N>/
        manifest.json         # each leaf's path, key, shape, logical dtype
                              # and crc32; the step; the caller's meta
        shard_p0.npz          # the leaves (one process)
        COMMIT                # written last — the validity marker

  * atomic commit: a save writes into ``.tmp-step_<N>``, fsyncs the
    manifest and ``COMMIT``, and ``os.replace``s the directory into place
    (a save of an existing step replaces it); ``latest_step`` skips a
    directory without ``COMMIT``, so a half-written checkpoint is never
    restored.
  * a crc32 per leaf, checked at restore: bit-rot or truncation raises.
  * ``restore(..., like=)`` refuses a leaf that is missing or whose shape
    differs.

Neither ``msgpack`` nor ``ml_dtypes`` is needed: the manifest is JSON, and
a bf16 leaf is stored as its int16 view with ``"bfloat16"`` recorded as
its logical dtype. A leaf is a tensor (read back from any device) or a
numpy array; a tree is nested dicts of them.

A tree of DTensors (a train state on a mesh) saves whole: each leaf is
gathered (``full_tensor``, a collective every rank joins), the mesh's
first rank writes, and the others wait at a barrier until the step is
committed. ``restore(..., shardings=)`` places each whole array by a tree
of ``(mesh, placements)`` (``distributed/elastic.replan``'s), so one
checkpoint restores onto any mesh shape.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device


def _leaf_key(i: int, path: str) -> str:
    return f"{i:05d}__{path.replace('/', '.')}"


def tree_paths(tree, prefix: str = "") -> list:
    """Flatten nested dicts into (``a/b/c`` path, leaf) pairs, keys in
    insertion order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k, v in tree.items():
        out.extend(tree_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(like, leaves):
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in like.items()}
    return next(leaves)


def _dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _to_numpy(leaf) -> tuple:
    """-> (the array to store, its logical dtype)."""
    if _dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def _fsync_write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def save(root: str, step: int, tree, *, meta: Optional[dict] = None) -> str:
    """Checkpoint ``tree`` at ``step``; ``meta`` must be JSON. -> the
    committed directory. A tree with DTensor leaves is saved by every rank
    of their process group alike: gathered everywhere, written by the
    first rank, the others waiting at a barrier for the commit."""
    final = os.path.join(root, f"step_{step:08d}")
    paths = tree_paths(tree)
    if any(_dtensor(leaf) for _, leaf in paths):
        import torch.distributed as dist

        whole = [(p, _to_numpy(leaf)) for p, leaf in paths]
        if dist.get_rank() == 0:
            _write(root, step, whole, meta)
        dist.barrier()
        return final
    return _write(root, step, [(p, _to_numpy(leaf)) for p, leaf in paths],
                  meta)


def _write(root: str, step: int, whole: list, meta) -> str:
    final = os.path.join(root, f"step_{step:08d}")
    tmp = os.path.join(root, f".tmp-step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    arrays, leaves = {}, []
    for i, (path, (arr, logical)) in enumerate(whole):
        key = _leaf_key(i, path)
        arrays[key] = arr
        leaves.append({"path": path, "key": key, "shape": list(arr.shape),
                       "dtype": logical, "crc32": zlib.crc32(arr.tobytes())})
    np.savez(os.path.join(tmp, "shard_p0.npz"), **arrays)
    manifest = {"step": step, "leaves": leaves, "meta": dict(meta or {})}
    _fsync_write(os.path.join(tmp, "manifest.json"),
                 json.dumps(manifest).encode())
    _fsync_write(os.path.join(tmp, "COMMIT"), b"ok")
    if os.path.exists(final):  # overwrite-in-place restart of the same step
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(root: str) -> Optional[int]:
    """Newest *valid* (committed) checkpoint step under ``root``."""
    if not os.path.isdir(root):
        return None
    best = None
    for name in os.listdir(root):
        m = re.fullmatch(r"step_(\d+)", name)
        if not m:
            continue
        if not os.path.exists(os.path.join(root, name, "COMMIT")):
            continue  # half-written (preemption mid-save) — skip
        s = int(m.group(1))
        best = s if best is None or s > best else best
    return best


def restore(root: str, step: Optional[int] = None, *, like=None,
            device=None, shardings=None) -> tuple:
    """-> (step, tree, meta); the newest committed step unless given.

    Without ``like``, the tree is a flat dict by path, each leaf a tensor
    on ``device`` (the CUDA device unless the caller names another). With
    ``like``, the tree has its structure and each leaf follows its ``like``
    leaf: a tensor on ``device`` if given, else on that tensor's device
    (a DTensor leaf: its mesh's device type); a numpy array for a numpy
    leaf. The stored dtype is kept. ``shardings`` (``like``'s structure,
    each leaf ``(mesh, placements)``) makes each restored whole array a
    DTensor so placed, every rank reading its own copy (no collective)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {root}")
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {}
    with np.load(os.path.join(d, "shard_p0.npz")) as data:
        for leaf in manifest["leaves"]:
            arr = data[leaf["key"]]
            if zlib.crc32(arr.tobytes()) != leaf["crc32"]:
                raise IOError(f"checksum mismatch for {leaf['path']} in {d}")
            by_path[leaf["path"]] = (arr, leaf["dtype"])
    meta = manifest.get("meta", {})
    if like is None:
        dev = resolve_device(device)
        return step, {p: _to_tensor(a, dt, dev)
                      for p, (a, dt) in by_path.items()}, meta
    if shardings is not None:
        like_paths = dict(tree_paths(like))
        placed = dict(tree_paths(shardings))
        if set(placed) != set(like_paths):
            raise KeyError(f"shardings and like differ: "
                           f"{sorted(set(placed) ^ set(like_paths))}")
    leaves = []
    for path, ref in tree_paths(like):
        if path not in by_path:
            raise KeyError(f"checkpoint missing leaf {path}")
        arr, dt = by_path[path]
        shape = tuple(ref.shape) if hasattr(ref, "shape") else np.shape(ref)
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch for {path}: ckpt {arr.shape} "
                             f"vs {shape}")
        if shardings is not None:
            from torch.distributed.tensor import distribute_tensor

            mesh, pl = placed[path]
            leaves.append(distribute_tensor(
                _to_tensor(arr, dt, device or mesh.device_type), mesh, pl,
                src_data_rank=None))
        elif _dtensor(ref):
            leaves.append(_to_tensor(arr, dt,
                                     device or ref.device_mesh.device_type))
        elif isinstance(ref, torch.Tensor):
            leaves.append(_to_tensor(arr, dt, device or ref.device))
        else:
            leaves.append(np.array(arr))
    return step, _unflatten(like, iter(leaves)), meta
