"""boomlint configuration for the port: the hot-path registry, the rules'
constants and the card's resource envelope.

The hot-function registry and the EP field lists are the reference's
(``repro.analysis.config``), path for path: every name exists in the port.
The reference's VMEM budget and shape grids have no counterpart here (no
Pallas tile, no jit cache); the card's limits take the budget's place.
"""
from __future__ import annotations

import dataclasses

# Host functions on the serving hot path (HS001's scope): host reads inside
# their loops are per-iteration syncs, and repeated reads of the same value
# are duplicate round-trips. Offline code (fit/build/bench) is deliberately
# NOT here: a host read is free there.
DEFAULT_HOT_FUNCTIONS = (
    ("serve/batch.py", "BatchedHybridExecutor.*"),
    ("serve/batch.py", "ServingEngine.*"),
    ("serve/queue.py", "AsyncServingEngine.*"),
    ("serve/queue.py", "BatchFormer.*"),
    ("core/executor.py", "HybridExecutor.execute"),
    ("core/executor.py", "HybridExecutor._subquery"),
    ("core/boomhq.py", "BoomHQ.execute"),
    ("core/boomhq.py", "BoomHQ.execute_batch"),
    ("core/boomhq.py", "BoomHQ.optimize"),
    ("core/boomhq.py", "BoomHQ.optimize_batch"),
    ("core/boomhq.py", "BoomHQ._merge_hot"),
    ("core/boomhq.py", "BoomHQ._execute_batch_sharded"),
)

# EP001: TieredTable fields that hold the MUTABLE ingest state
# (vectordb/tiered.py). Serving hot paths must never read these directly:
# every epoch-consistent view comes from ONE tiered.snapshot() call taken
# at batch-formation time.
TIERED_MUTABLE_FIELDS = (
    "_hot", "_cold", "_sealing", "_snap", "_epoch", "_compacting",
)

# EP002: payload fields of a semantic-cache entry (serve/semcache.py
# CacheEntry). The sanctioned read is SemanticCache.lookup(), which
# enforces the (epoch, n_rows) freshness token; `token` itself is NOT
# banned: comparing it IS the freshness check.
CACHE_ENTRY_FIELDS = (
    "ids", "scores", "centroids",
)

# CM001: all-gathers allowed in the sharded merge (ids + scores of the
# O(shards·k) merge); at least one must be there
MAX_ALL_GATHERS = 2


@dataclasses.dataclass(frozen=True)
class CardEnvelope:
    """One Hopper SM's limits that a kernel's compiled resources must fit
    (H100, sm_90: CUDA's ``sharedMemPerBlockOptin``, the default dynamic
    shared-memory ceiling, the register file)."""

    smem_optin: int = 232_448  # 227 KB a block, after cudaFuncSetAttribute
    smem_default: int = 48 * 1024  # a block's static + dynamic, no opt-in
    regs_per_sm: int = 65_536
    regs_per_thread: int = 255
    spill_bytes: int = 0  # spill stores/loads and stack frame allowed
    # for the resident-CTA arithmetic
    ctas_per_sm: int = 32
    threads_per_sm: int = 2048
    smem_per_sm: int = 233_472  # 228 KB
    smem_reserved: int = 1024  # a CTA's shared memory the system keeps
    reg_unit: int = 256  # registers are allocated a warp at a time in these


@dataclasses.dataclass
class LintConfig:
    """Settings of one analyzer run (tests construct these; the CLI maps
    flags onto them)."""

    # hot host functions for HS001: (path suffix, qualname glob)
    hot_functions: tuple = DEFAULT_HOT_FUNCTIONS
    # run the level-2 checks (CLI --no-runtime disables)
    runtime: bool = True
    # directory of nvcc -Xptxas -v reports (``*.log``); None -> the logs
    # kernels/build.py keeps beside the built libraries
    ptxas_logs: str | None = None
    # the card PL001 holds each kernel to
    card: CardEnvelope = dataclasses.field(default_factory=CardEnvelope)
