"""Deterministic, shardable, resumable data pipeline.

A copy of ``repro.data.pipeline`` (numpy only; the port imports nothing of
the JAX package): the same (seed, step, host) give the same batches, bit
for bit.

Requirements at pod scale:
  * every host derives its own batch shard purely from (seed, step, host) — no
    coordinator traffic, no file-offset state to lose on preemption;
  * a replacement host (straggler swap / elastic reshard) reproduces the
    exact stream the failed host would have produced;
  * resume-from-checkpoint only needs the integer ``step`` cursor.

Two sources:
  * ``SyntheticLM``: Zipf-ish token stream (smoke tests, dry-runs, examples).
  * ``PackedCorpus``: document packing from an in-memory token array with
    deterministic shuffling — the real-data path.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    global_batch: int
    seq_len: int
    vocab: int
    num_hosts: int = 1
    host_index: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


class SyntheticLM:
    """Deterministic synthetic LM batches: tokens + next-token labels."""

    def __init__(self, spec: BatchSpec, seed: int = 0):
        self.spec = spec
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        s = self.spec
        gen = np.random.default_rng([self.seed, step, s.host_index, 0x0B00])
        # Zipf-flavoured marginal so the loss curve is non-trivial
        z = gen.zipf(1.3, size=(s.host_batch, s.seq_len + 1))
        tokens = np.minimum(z - 1, s.vocab - 1).astype(np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PackedCorpus:
    """Pack documents into fixed-length sequences, deterministic per step."""

    def __init__(self, docs: list[np.ndarray], spec: BatchSpec, seed: int = 0,
                 eos_id: int = 0):
        self.spec = spec
        self.seed = seed
        stream = []
        for d in docs:
            stream.append(np.asarray(d, np.int32))
            stream.append(np.array([eos_id], np.int32))
        self.stream = np.concatenate(stream) if stream else np.zeros((1,), np.int32)

    def batch_at(self, step: int) -> dict:
        s = self.spec
        need = s.host_batch * (s.seq_len + 1)
        rng = np.random.default_rng([self.seed, step, s.host_index, 1])
        # deterministic random window offsets into the packed stream
        offs = rng.integers(0, max(1, len(self.stream) - s.seq_len - 1), size=s.host_batch)
        rows = np.stack(
            [np.take(self.stream, np.arange(o, o + s.seq_len + 1), mode="wrap") for o in offs]
        )
        assert rows.size == need
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def make_source(kind: str, spec: BatchSpec, seed: int = 0, docs=None):
    if kind == "synthetic":
        return SyntheticLM(spec, seed)
    if kind == "packed":
        return PackedCorpus(docs or [], spec, seed)
    raise ValueError(f"unknown data source {kind!r}")
