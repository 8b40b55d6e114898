"""LM serving steps: prefill (prompt -> cache) and decode (one token/step).

Port of ``repro.models.lm_serving``. Each step casts each block to the
compute dtype at its use, as the reference's scan does, so no step holds a
whole-model copy beside the parameters. ``greedy_generate`` is the host
loop: prefill once, then one decode step
per token. The tokens stay on the model's device through the loop (the
cache slot ``pos`` is a host int), so the loop reads nothing back; the
caller reads the result once at the end.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm


def make_prefill_step(model: lm.LM, max_len: int):
    def prefill_step(batch: dict):
        return lm.prefill(model, batch, max_len)

    return prefill_step


def make_decode_step(model: lm.LM):
    def decode_step(inputs: dict, pos: int, cache: dict):
        return lm.decode_step(model, inputs, pos, cache)

    return decode_step


def prompt_len(cfg, batch: dict) -> int:
    """Positions the prefill fills: a vlm's counts ``n_prefix_embeds``."""
    if cfg.modality == "vlm":
        return batch["tokens"].shape[1] + cfg.n_prefix_embeds
    if cfg.inputs_are_embeds:
        return batch["embeds"].shape[1]
    return batch["tokens"].shape[1]


def next_inputs(cfg, tok: torch.Tensor) -> dict:
    """The decode inputs for the sampled ids: the id itself, or (audio)
    ``one_hot(id % d_model)`` through the fixed stub table."""
    if cfg.inputs_are_embeds:
        return {"embed": torch.nn.functional.one_hot(
            tok.long() % cfg.d_model, cfg.d_model).float()}
    return {"token": tok}


def greedy_token(cfg, logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[..., : cfg.vocab], dim=-1).to(torch.int32)


@torch.no_grad()
def greedy_generate(model: lm.LM, batch: dict, *, steps: int,
                    max_len: int) -> torch.Tensor:
    """Prefill on ``batch`` then greedily decode ``steps`` tokens.

    Returns tokens (B, steps) int32 on the model's device.
    """
    cfg = model.cfg
    prefill = make_prefill_step(model, max_len)
    decode = make_decode_step(model)
    logits, cache = prefill(batch)
    start = prompt_len(cfg, batch)
    outs = []
    tok = greedy_token(cfg, logits)
    for i in range(steps):
        outs.append(tok)
        logits, cache = decode(next_inputs(cfg, tok), start + i, cache)
        tok = greedy_token(cfg, logits)
    return torch.stack(outs, dim=1)
