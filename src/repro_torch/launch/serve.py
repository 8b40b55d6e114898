"""Serving CLI: batched prefill + greedy decode for a dense, moe, ssm or
hybrid arch.

Port of ``repro.launch.serve``; runs on the CUDA device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
      --smoke --batch 4 --prompt-len 32 --steps 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
      --batch 8 --prompt-len 512 --steps 64
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v3-671b --smoke

A prompt longer than an ssm or hybrid arch's ``ssm_chunk`` must be a
multiple of it (the SSD scan pads nothing).

The model is initialized from ``--seed`` (no weights are read), the prompt
drawn from ``np.random.default_rng(seed)`` as the reference draws it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.common.device import resolve_device, synchronize
from repro_torch.models import lm
from repro_torch.models.lm_serving import greedy_generate


def main(argv=None, *, device=None) -> torch.Tensor:
    """-> the generated tokens (batch, steps) int32 on ``device`` (the CUDA
    device unless the caller names another)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    model = lm.init(cfg, seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    b, s = args.batch, args.prompt_len

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    batch = {}
    if cfg.modality == "vlm":
        npre = min(cfg.n_prefix_embeds, s // 2)
        batch["patch_embeds"] = f32(rng.normal(size=(b, npre, cfg.d_model)))
        batch["tokens"] = i32(rng.integers(0, cfg.vocab, (b, s - npre)))
    elif cfg.inputs_are_embeds:
        batch["embeds"] = f32(rng.normal(size=(b, s, cfg.d_model)))
    else:
        batch["tokens"] = i32(rng.integers(0, cfg.vocab, (b, s)))

    synchronize(dev)
    t0 = time.perf_counter()
    toks = greedy_generate(model, batch, steps=args.steps,
                           max_len=s + args.steps + 1)
    first = toks[0].cpu()  # the one read of the generated tokens
    dt = time.perf_counter() - t0
    print(f"generated {tuple(toks.shape)} tokens in {dt:.2f}s "
          f"({toks.numel() / dt:.1f} tok/s on {dev.type}, first call)")
    print("first sequence:", first[:16].tolist())
    return toks


if __name__ == "__main__":
    main()
