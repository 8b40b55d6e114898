"""Kernel block shapes, sentinels and the declared support envelope.

The port's copy of the constants in ``repro.kernels.shapes``. The TPU
VMEM byte estimators there have no Hopper counterpart and are not carried
over.
"""
from __future__ import annotations

# Score sentinel for masked-out / padded rows and the id sentinel that sorts
# padding behind every real row id (2**30 keeps int32 arithmetic safe).
NEG = -1e30
ID_SENTINEL = 2**30

# Row tile of the full-scan kernels (masked_topk, int8_scan).
SCAN_BLOCK_ROWS = 1024

# Candidate slots per block of the gather+score kernel.
GATHER_BLOCK_S = 256

# Declared support envelope — the largest shapes the serving kernels are
# expected to launch with.
MAX_COL_DIM = 768  # widest single vector column
MAX_VEC_COLS = 4  # most vector columns per table
MAX_SCALARS = 16  # most scalar predicate columns
MAX_TOPK = 128  # largest k a kernel is launched with

# Graph-index beam search envelope.
MAX_BEAM_WIDTH = 16
MAX_BEAM_HOPS = 8
MAX_GRAPH_DEGREE = 32
GRAPH_ENTRY_POINTS = 8  # static entry-point count (medoid + strided)
GRAPH_SEED_FACTOR = 4  # qualifying seed rows per beam slot
