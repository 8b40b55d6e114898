"""Meta-tensor stand-ins for every model input (no device allocation).

Port of ``repro.launch.input_specs``: ``input_specs(arch, shape_name)``
returns the abstract inputs of the step that shape runs (train_* -> the
train step's batch; prefill_* -> the prefill batch; decode_*/long_* ->
(inputs, pos, cache)), each a tensor on the ``meta`` device with the
reference's shape and dtype. ``abstract_model`` is the counterpart of
``jax.eval_shape(lm.init)``: ``lm.LM`` on the meta device, whose
parameters have shapes and dtypes and no values (nothing is drawn).
The dry-run (``launch/dryrun.py``) runs the steps on these.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec, \
    get_config
from repro_torch.models import lm

I32 = torch.int32
BF16 = torch.bfloat16


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_model(cfg: ModelConfig) -> lm.LM:
    """``lm.LM(cfg)`` on the meta device (``cfg.param_dtype``, the
    ``_KEEP_F32`` leaves f32)."""
    return lm.LM(cfg, device="meta")


def batch_struct(cfg: ModelConfig, shape: ShapeSpec, *, with_labels: bool
                 ) -> dict:
    """Train/prefill batch: tokens/labels (+ modality stub embeddings)."""
    b, s = shape.global_batch, shape.seq_len
    out: dict = {}
    if cfg.modality == "vlm":
        s_tok = s - cfg.n_prefix_embeds
        out["patch_embeds"] = _meta((b, cfg.n_prefix_embeds, cfg.d_model),
                                    BF16)
        out["tokens"] = _meta((b, s_tok), I32)
        if with_labels:
            out["labels"] = _meta((b, s_tok), I32)
    elif cfg.inputs_are_embeds:
        out["embeds"] = _meta((b, s, cfg.d_model), BF16)
        if with_labels:
            out["labels"] = _meta((b, s), I32)
    else:
        out["tokens"] = _meta((b, s), I32)
        if with_labels:
            out["labels"] = _meta((b, s), I32)
    return out


def decode_structs(cfg: ModelConfig, shape: ShapeSpec) -> tuple:
    """-> (inputs, pos, cache) abstract values for one decode step."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.inputs_are_embeds:
        inputs = {"embed": _meta((b, cfg.d_model), BF16)}
    else:
        inputs = {"token": _meta((b,), I32)}
    pos = _meta((), I32)
    cache = lm.make_cache(cfg, b, s, dtype=BF16, device="meta")
    return inputs, pos, cache


def serve_params_struct(cfg: ModelConfig, dtype: str = "bfloat16") -> dict:
    """{parameter name: meta tensor}, every floating leaf in the serving
    dtype (as the reference casts its whole tree)."""
    dt = getattr(torch, dtype)
    return {k: _meta(t.shape, dt if t.is_floating_point() else t.dtype)
            for k, t in abstract_model(cfg).named_parameters()}


def input_specs(arch: str, shape_name: str, *, smoke: bool = False) -> dict:
    """The abstract inputs for (arch × shape)."""
    cfg = get_config(arch, smoke=smoke)
    shape = SHAPES[shape_name]
    if shape.step == "train":
        return {"batch": batch_struct(cfg, shape, with_labels=True)}
    if shape.step == "prefill":
        return {"batch": batch_struct(cfg, shape, with_labels=False)}
    inputs, pos, cache = decode_structs(cfg, shape)
    return {"inputs": inputs, "pos": pos, "cache": cache}
