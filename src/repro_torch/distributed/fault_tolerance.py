"""Fault tolerance for training.

A copy of ``repro.distributed.fault_tolerance`` (numpy only), but that
``run_resilient`` saves and restores through the port's
``repro_torch.checkpoint.ckpt``.

Pieces, all host-side and engine-agnostic:
  * ``StepWatchdog``     — rolling p50 step time; flags hosts whose steps
                           exceed ``straggler_factor × p50`` for ``patience``
                           consecutive steps (straggler mitigation = report
                           to the coordinator, checkpoint, restart without
                           the slow host — exercised in tests with a fake
                           clock).
  * ``PreemptionGuard``  — SIGTERM/SIGINT handler that requests a final
                           synchronous checkpoint before exit (a cluster's
                           maintenance events deliver SIGTERM).
  * ``Heartbeat``        — tiny file-based liveness protocol: every host
                           touches ``<dir>/host_<i>`` each step; a
                           coordinator scanning mtimes finds dead hosts.
                           (On a real cluster this is the job
                           orchestrator's role; the file protocol makes it
                           testable.)
  * ``run_resilient``    — drives a train loop with periodic checkpoints,
                           auto-resume from the newest valid manifest and
                           checkpoint-on-preemption.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Callable, Optional

import numpy as np


class StepWatchdog:
    def __init__(self, straggler_factor: float = 2.0, patience: int = 3,
                 window: int = 50):
        self.factor = straggler_factor
        self.patience = patience
        self.window = window
        self.times: list[float] = []
        self.strikes = 0
        self.flagged = False

    def record(self, step_seconds: float) -> bool:
        """Record one step; returns True if this host is now flagged."""
        self.times.append(step_seconds)
        hist = self.times[-self.window:]
        if len(hist) >= 5:
            p50 = float(np.median(hist))
            if step_seconds > self.factor * p50:
                self.strikes += 1
            else:
                self.strikes = 0
            if self.strikes >= self.patience:
                self.flagged = True
        return self.flagged

    def p50(self) -> float:
        return float(np.median(self.times[-self.window:])) if self.times else 0.0


class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers that set a flag; the train loop
    checks ``should_checkpoint`` each step and exits cleanly."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.should_checkpoint = False
        self._prev = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):  # noqa: ARG002
        self.should_checkpoint = True

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


class Heartbeat:
    def __init__(self, directory: str, host_index: int):
        self.dir = directory
        self.host = host_index
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"host_{host_index:05d}")

    def beat(self):
        with open(self.path, "w") as f:
            f.write(str(time.time()))

    @staticmethod
    def dead_hosts(directory: str, timeout_s: float, now: Optional[float] = None):
        now = now if now is not None else time.time()
        dead = []
        if not os.path.isdir(directory):
            return dead
        for name in sorted(os.listdir(directory)):
            if not name.startswith("host_"):
                continue
            mtime = os.path.getmtime(os.path.join(directory, name))
            if now - mtime > timeout_s:
                dead.append(int(name.split("_")[1]))
        return dead


@dataclasses.dataclass
class ResilientReport:
    start_step: int
    end_step: int
    checkpoints: list[int]
    preempted: bool
    straggler_flagged: bool


def run_resilient(step_fn: Callable[[int, dict], dict], state: dict, *,
                  ckpt_dir: str, total_steps: int, ckpt_every: int = 100,
                  watchdog: Optional[StepWatchdog] = None,
                  guard: Optional[PreemptionGuard] = None,
                  save_fn=None, restore_fn=None) -> ResilientReport:
    """Generic resilient loop: auto-resume + periodic/preemption checkpoints.

    ``save_fn(dir, step, state)`` / ``restore_fn(dir) -> (step, state)`` default
    to repro_torch.checkpoint.ckpt.
    """
    from repro_torch.checkpoint import ckpt

    save_fn = save_fn or (lambda d, s, st: ckpt.save(d, s, st))
    if restore_fn is None:
        def restore_fn(d):
            step = ckpt.latest_step(d)
            if step is None:
                return 0, None
            s, tree, _ = ckpt.restore(d, like=state)
            return s, tree

    start, restored = restore_fn(ckpt_dir)
    if restored is not None:
        state = restored
    watchdog = watchdog or StepWatchdog()
    saved = []
    preempted = False
    step = start
    while step < total_steps:
        t0 = time.perf_counter()
        state = step_fn(step, state)
        watchdog.record(time.perf_counter() - t0)
        step += 1
        if guard is not None and guard.should_checkpoint:
            save_fn(ckpt_dir, step, state)
            saved.append(step)
            preempted = True
            break
        if step % ckpt_every == 0 or step == total_steps:
            save_fn(ckpt_dir, step, state)
            saved.append(step)
    return ResilientReport(start_step=start, end_step=step, checkpoints=saved,
                           preempted=preempted,
                           straggler_flagged=watchdog.flagged)
