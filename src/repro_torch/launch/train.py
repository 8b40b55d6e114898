"""Training entry point.

Port of ``repro.launch.train``; runs on the CUDA device unless
``--device`` (or ``device=``) names another.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
      --smoke --steps 50 --ckpt /tmp/run1 --resume auto
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
      --smoke --steps 6 --device cpu

Wires together the config registry, the data pipeline, the train-step
factory (the arch's ``TRAIN_PLANS`` entry gives ``remat``, the optimizer
and the moment dtype; the warmup is a tenth of the schedule's horizon),
checkpointing (auto-resume from the newest committed step), the preemption
guard and the straggler watchdog. A sequence of an ssm or hybrid arch
longer than its ``ssm_chunk`` must be a multiple of it (the SSD scan pads
nothing).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import ckpt
from repro_torch.common.device import resolve_device
from repro_torch.data.pipeline import BatchSpec, make_source
from repro_torch.distributed.fault_tolerance import (
    PreemptionGuard, StepWatchdog,
)
from repro_torch.launch.plans import TRAIN_PLANS
from repro_torch.train.step import TrainPlan, init_state, make_train_step


def main(argv=None, *, device=None) -> list:
    """-> the losses of the steps run (floats)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--schedule-total", type=int, default=None,
                    help="LR-schedule horizon (defaults to --steps); pass "
                         "the full-run horizon when training in resumable "
                         "legs")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (the CUDA device unless given)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device if device is None else device)
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    base = TRAIN_PLANS.get(args.arch, TrainPlan())
    total = args.schedule_total or args.steps
    plan = TrainPlan(
        microbatches=args.microbatches, remat=base.remat,
        optimizer=base.optimizer, state_dtype=base.state_dtype,
        lr=args.lr, warmup=max(1, total // 10), total_steps=total)

    model, opt_state = init_state(cfg, plan, seed=args.seed, device=dev)
    params = dict(model.named_parameters())
    step_fn = make_train_step(cfg, plan)

    spec = BatchSpec(args.global_batch, args.seq_len, cfg.vocab)
    src = make_source("synthetic", spec, seed=args.seed)

    start = 0
    if args.ckpt and args.resume == "auto":
        latest = ckpt.latest_step(args.ckpt)
        if latest is not None:
            start, tree, _ = ckpt.restore(
                args.ckpt, like={"params": params, "opt": opt_state})
            with torch.no_grad():
                for k, t in params.items():
                    t.copy_(tree["params"][k])
            opt_state = tree["opt"]
            print(f"resumed from step {start}")

    guard = PreemptionGuard()
    watchdog = StepWatchdog()
    losses = []
    for step in range(start, args.steps):
        batch = src.batch_at(step)
        feed = _adapt_batch(cfg, batch, dev)
        t0 = time.perf_counter()
        opt_state, metrics = step_fn(model, opt_state, feed)
        loss = float(metrics["loss"])
        watchdog.record(time.perf_counter() - t0)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"p50 {watchdog.p50()*1e3:.0f}ms"
                  + (" [STRAGGLER]" if watchdog.flagged else ""))
        do_ckpt = args.ckpt and (
            (step + 1) % args.ckpt_every == 0 or step == args.steps - 1
            or guard.should_checkpoint)
        if do_ckpt:
            ckpt.save(args.ckpt, step + 1,
                      {"params": params, "opt": opt_state},
                      meta={"arch": args.arch, "loss": loss})
        if guard.should_checkpoint:
            print(f"preempted at step {step + 1}; checkpointed; exiting")
            break
    guard.restore()
    if len(losses) >= 10:
        print(f"loss: first10={np.mean(losses[:10]):.4f} "
              f"last10={np.mean(losses[-10:]):.4f}")
    return losses


def _adapt_batch(cfg, batch: dict, device) -> dict:
    """Token batch -> the arch's input dict on ``device`` (modality stubs:
    a vlm's patch prefix drawn from a numpy generator seeded with the
    first token, an audio arch's one-hot frame embeddings)."""
    tokens = np.asarray(batch["tokens"])
    labels = np.asarray(batch["labels"])
    b, s = tokens.shape

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    if cfg.modality == "vlm":
        npre = min(cfg.n_prefix_embeds, s // 2)
        rng = np.random.default_rng(int(tokens[0, 0]))
        patches = np.asarray(rng.normal(size=(b, npre, cfg.d_model)),
                             np.float32)
        return {"tokens": i32(tokens[:, npre:]),
                "labels": i32(labels[:, npre:]),
                "patch_embeds": torch.as_tensor(patches, device=device)}
    if cfg.inputs_are_embeds:
        emb = np.eye(cfg.d_model, dtype=np.float32)[tokens % cfg.d_model]
        return {"embeds": torch.as_tensor(emb, device=device),
                "labels": i32(labels % cfg.vocab)}
    return {"tokens": i32(tokens % cfg.vocab),
            "labels": i32(labels % cfg.vocab)}


if __name__ == "__main__":
    main()
