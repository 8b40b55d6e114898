"""Chip smoke test of the PyTorch/CUDA port of BoomHQ.

    python3 chip_smoke.py        # from the repository root, on a CUDA card

Phases (any failure raises and exits non-zero):

  1. the card's name and power limit (``nvidia-smi``); TF32 off for matmul
     and cuDNN, so fp32 means fp32;
  2. build the port's two CUDA sources (``gather_score.cu``,
     ``masked_topk.cu``), one ``nvcc`` each, started together, and report
     the build seconds; then build the per-column proximity graphs of the
     200,000-row ``part`` table (BoomHQ's default ``graph_degree=16``) and
     report the seconds per column;
  3. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes on that table — qualifying counts (``valid``) equal,
     scores within atol=1e-3, rtol=1e-4, ids equal except between rows
     whose plain scores tie within that tolerance (each differing id is
     rescored by the plain formula; no row twice; every row clear of ties
     present), and the check must refuse the result once two of its
     untied ids are swapped — with the entry point's time,
     the kernel's alone (CUDA events around 20 launches, which time the
     host's enqueue where it is the slower, and the same 20 launches
     replayed from a CUDA graph: the device time), the plain version's and
     the bound (bytes the call must move over 3.35 TB/s vs. its flops over
     67 TFLOP/s fp32, the larger; a gather or a scan under a predicate
     must read every row's scalars it decides but only the qualifying
     rows' vectors; a scan also reports the bound of every row's vector and
     scalars, ``bound_all_rows_ms``).
     Gather-score: IVF-probed candidates (fp32 and the int8 stage) under
     random DNFs, and both also under ≈1%, ≈10% and 100% price ranges
     (fp32 at k=32, the int8 stage at kq=128), the ±1.4e-45 bounds of
     ``~(col == 0)`` on a column holding zeros, and one conjunction over
     all M columns; the rerank union, and
     the candidate pool of a real graph walk at the largest knobs (beam
     16, 8 hops: 8 + 4·16 + 8·16·16 = 2,120 slots), and a tiered table's
     hot view as ``tiered._hot_topk`` scores it (B=32, S=2,048 slots
     with the 548 past the view's 1,500 rows at -1, rows from the view's
     own buffer, both columns weighted, predicates folded on a fifth
     scalar column, the tenant, k=16), and the per-shard probe of
     ``distributed.sharded_ivf_topk`` (B=32 queries × 4 logical shards
     folded into 128 rows, each row the 2,048 slots
     ``legalize_for_shard(max_scan=8192, n_shards=4)`` gives, probed in
     its own shard's 32-cluster index and globalized, both columns
     weighted, a one-clause DNF, k=32). Full-table scans of column 0:
     ``ops.masked_topk`` (dot, l2) and ``ops.int8_masked_topk`` on
     ``table.quantized(0)``, k ∈ {10, 128}, conjunctive predicates at
     ≈1%, ≈10% and 100% selectivity and one over all M columns (≈12.5%);
  4. the main path: fit BoomHQ (default graph tier, the quickstart's
     encoder and rewriter step budgets, labels without the per-column trim
     as in the tests' fitted fixture) on a mixed conjunctive + DNF
     workload, then serve 256 unseen queries through
     ``ServingEngine(batch_size=32)`` twice — the default cost model and
     ``CostModel(force="candidate_local")`` — and a third time through the
     batched executor under one fixed graph plan (beam 8, 4 hops), so the
     walk runs whatever plans the rewriter learned (and once more at the
     grid's largest graph knobs: beam 16, 8 hops, k_i = 8k, for the recall
     the walk can reach); mean recall@10 against
     ``flat.ground_truth``. Launch counts are zeroed just before the fit
     and read after the graph passes: every gather kernel must have
     launched, the forced pass must launch the fp32 kernel, graph groups
     must have run in the third pass and their extraction must have
     launched the fp32 kernel (more launches than the pass's reranks).
     The two learned passes run the same plans through two scoring paths,
     so their mean recalls must lie within 0.02; each must also be no
     worse (by more than 0.02) than the robust ``default_plan`` on the same
     queries. Whether each pass meets the queries' recall target (0.9) is
     reported, not enforced: at 200,000 rows the JAX package's own
     ``default_plan`` and the best plan of the labelling grid fall short of
     it or barely clear it (``crosscheck/recall_witness.py``), so a miss is
     printed as an unmet target and kept in ``chip_smoke.json``;
  5. the full-table scan path: with the scan counts zeroed, every
     conjunctive serving query runs ``ops.masked_topk`` and
     ``ops.int8_masked_topk`` on column 0 under its own predicate; the fp32
     scan must match ``flat.ground_truth`` on that column (scores within
     the phase-3 tolerance, ids equal except between ties) and the int8
     scan must return as many valid rows; both kernels must have launched;
  6. (run after phases 10 and 11) a profile of one candidate-local batch
     and of one graph batch (device time by kernel), then one batch of
     each phase-10 configuration (S, route) after a warm batch, its wall
     and device-busy ms;
  7. data updates on the served instance: column 0's int8 replica built,
     then two skewed inserts (a copy of ``benchmarks/data_updates``'s
     ``_skewed_insert``, ratios 0.1 and 0.5 of the 200,000 rows: +20,000
     rows, which ``ivf.extend`` splices incrementally, then +80,000, which
     it regroups) through ``BoomHQ.insert(finetune=True)``. After each:
     every index's ``sorted_rows`` a permutation of range(n) with
     ``offsets[-1] == n``, the histograms and every graph at n rows, the
     int8 replica's old rows and scales byte for byte the pre-insert ones
     and its new rows ``quantize_rows`` of the new rows; the insert's
     seconds by step; the default and the forced candidate-local pass and
     ``default_plan`` over the serving queries against
     ``flat.ground_truth`` on the grown table (the passes' recalls within
     0.02 of each other, the forced pass launching the fp32 kernel, and
     some served id a new row whenever the ground truth holds one; whether
     a pass falls below ``default_plan``'s recall less 0.02 is reported,
     not enforced: after these inserts the JAX package's learned plans
     fall below it too, on the same state, by 0.02-0.12 over two fits,
     ``scripts/update_witness.py``); and the gather kernels against their
     plain versions at four grown IVF shapes;
  8. ``sift`` at the paper's 1,000,000 rows (d=128, scalars from
     ``augment_with_scalars``): build seconds and each scalar column's
     values, one IVF index, phase 3's gather checks at d=128 on 32 of its
     queries (no graph pool) and at the searches' own shapes (nprobe 4:
     the fp32 gather at k=10, the int8 stage at kq=40, the rerank of its
     survivors), then the 32 queries through ``ivf.search_local_batch``
     and its int8 twin with the counts zeroed (both kernels must launch;
     each search's result held to its plain version on the same
     candidates; recall@10 reported);
  9. the tiered, tenanted, cached path: ``part``'s 200,000 rows with a
     categorical ``tenant`` column of 3 values (``run_semcache``'s draw;
     phase 2's vectors, so its graphs are bound again), fitted as phase
     4, ``bind_tenants("tenant")``. (a)
     ``run_semcache``'s trace (16 tenanted queries, 80 requests) served
     one by one through ``AsyncServingEngine`` without and with
     ``SemanticCache(eps=0)``: QPS, hit rate, recall against the
     tenant-folded oracle (the cached run's must equal the uncached
     run's), per-tenant accounting; every cache event is logged and each
     hit must replay the entry its miss stored under the same
     ``(epoch, n_rows)`` token; then under ``bind_tiered`` 48 rows go hot
     and a compaction swaps the epoch, and the first pass after each must
     miss throughout. (b) ``run_mixed`` at full width: ``bind_tiered(
     hot_capacity=2048)``, tenanted requests in Poisson arrivals at 60%
     of the warm batch throughput (batch 16, ``max_wait`` 0.02 s) while
     ``skewed_insert`` rows (+20,000 in 8 chunks) stream in and compact
     in the background; the arrivals (at least 256) go on until the
     ingest has ended and every compaction has published, then 32 more:
     QPS, p50/p99, requests by epoch, each compaction's seconds by step
     (timed on the compacting thread, device work included), the
     worker's idle gaps with work pending (reported), recall
     before, per request against its own snapshot's hot ∪ cold oracle
     and after, ``default_plan``'s on the final snapshot, and the
     ``hot_view_transfers`` delta over an insert-only window (must be 0).
     Every request must resolve ``ok``, every tenanted result hold rows
     of its tenant only, no served result miss a hot row its snapshot's
     oracle ranks in the top-k (float ties aside), at least one
     compaction run with the engine's epoch the table's, the requests'
     snapshots span two epochs or more up to the final one, and the fp32
     kernel launch on the hot views. The launch counts are zeroed before
     and read after each serving run (the engine runs of (a), and (b)'s
     pass before the stream, the stream and the pass after it); the
     compaction thread's warm-up launches are counted apart, and the
     oracle and ``default_plan`` comparisons are not counted;
 10. logical shards, run after phase 5 and before phase 6's profiler
     (once it has run, host-bound serving in the process reads slower)
     on phase 4's instance: for S ∈ {1, 2, 4} (``bind_shards(S)``; S=1 is
     the unsharded path) the 256 serving queries through
     ``ServingEngine(batch_size=32)`` under the default cost model and
     ``CostModel(force=...)`` "candidate_local" (index groups probe per
     shard), "dense" (the exact sharded scan) and "single_device", then
     a fixed-plan pass (``default_plan`` without re-expansion, every index
     group forced to per-shard probing) through ``execute_batch_sharded``
     of an executor over S shards: QPS, recall@10, routes, escalated
     queries, gather launches per probing chunk, and each S's
     ``ShardedIVF`` build seconds (phase 6 profiles one batch of each
     configuration). Fails unless every
     served id is distinct, in range, satisfies its predicate and carries
     its row's plain score; every query on an exact route equals its
     exact filtered top-k (ties aside); the forced S=1 pass equals phase
     4's forced pass bit for bit, and the fixed-plan S=1 pass the same
     plan on one device wherever it did not escalate; every probing chunk
     launches the fp32 kernel once per probed column plus once (never the
     int8 stage), whatever S; and the forced S=2, 4 passes launch it;
 11. the mesh (``torch.distributed``), right after phase 10 on the same
     instance. (a) A one-rank NCCL world in this process and its
     ``(data,)`` ``DeviceMesh``: ``bind_shards(mesh=)`` serves the 256
     queries through ``ServingEngine(batch_size=32)`` under the default
     cost model, forced candidate_local and forced dense, each with phase
     10's checks, and every ``execute_batch_sharded`` call of each pass
     must equal the logical one-shard executor's on the same plans and
     dense matrices (the probing route bit for bit with the same
     escalated queries and per-shard fill and boundary, the exact route
     ties aside); then phase 10's fixed-plan pass on a mesh executor, bit
     for bit phase 10's S=1 pass. (b) Four gloo ranks in their own
     processes on the one card (a check of correctness, not of four
     cards: gloo moves each gather through host memory), each given only
     its 50,000 rows (its table is NaN elsewhere) and its shard of phase
     10's S=4 indexes: the fixed-plan pass and the same plans forced
     dense through ``BatchedHybridExecutor(mesh=)``, every rank equal to
     the logical S=4 passes (ids, escalated queries, per-shard fill;
     scores and boundaries within 1e-5), every rank launching the fp32
     kernel once per probed column plus once a probing chunk. (c) The
     serving front end over four gloo ranks on the one card, each holding
     phase 4's fitted instance (its tensors shared through CUDA IPC) and
     its shard of phase 10's S=4 indexes, on a four-rank mesh under the
     default cost model: the first rank serves through
     ``AsyncServingEngine`` (``max_wait`` 0.002 s) the ``semcache_draws``
     pool once as a warm-up, its trace one request at a time (batch 8,
     ``SemanticCache(eps=0)``) and the first ``FRONT_HELD`` = 128 serving
     queries at once through ``serve_stream`` (batch 32, with the cache;
     128, not 256, so that the script stays near its time budget with
     (d)); the others run
     ``serve_follower``. Every rank must exit 0, every follower run as
     many batches as the first rank with results equal bit for bit, each
     of the first rank's batches replayed here on the instance bound to
     logical ``bind_shards(4)`` (the same indexes) give equal ids and
     scores within 1e-5 (exact-route ties as ``check_tied``), every hit
     equal its miss, the hits equal the one-process engine's on the same
     sessions, ``check_served`` hold and every rank launch the fp32
     kernel; the mesh engine's QPS, p50/p99, hits, timeouts and wall
     seconds print beside the one-process engine's, with the broadcasts
     a batch. (d) Tiered ingest over four gloo ranks on the one card,
     run inside phase 9 between (a) and (b) on phase 9's fitted tenant
     instance (phase 4's has no tenant column), each rank holding it
     through CUDA IPC on a four-rank mesh with ``bind_tiered(
     hot_capacity=2048)``: the first rank serves (b)'s stream through
     ``AsyncServingEngine`` (a warm session of two batches of 16 first,
     whose second batch's time sets the rate) at 60% of the mesh's own
     warm batch-16 rate while +20,000 ``tenant_skewed_insert`` rows go in
     through its ``BoomHQ.insert`` in 8 chunks and compact in the
     background; every other rank runs ``serve_follower`` (the ingest and
     the compaction starts arrive with each batch, and each follower
     compacts on its own). Every rank must exit 0; every follower run
     every batch on the stamp the first rank cut it on, with results
     equal bit for bit, and end on its final stamp; every rank publish
     the same epochs on the same rows with equal cold-state digests; the
     stamps span two epochs or more; every rank score the hot views with
     the fp32 kernel, as often as the others; every batch replayed here
     on logical ``bind_shards(4)`` at its stamp (each compaction driven
     where the first rank's ran) equal the mesh's (scores within 1e-5,
     ids except between tied slots) and hold to its snapshot's cold ∪
     hot oracle with no hot row missed. Printed beside the same stream
     through one process on logical S=4 at the same rate: QPS, p50/p99,
     each rank's compaction seconds by step, each follower's publish lag
     by epoch, channel messages and bytes a batch, peak device memory by
     rank. Every process group has a finite timeout and is destroyed
     after its phase;
 12. the static checks (``repro_torch.analysis``), (a) and (b) right after
     phase 2's build, (c) right after phase 4's counted passes. (a)
     boomlint over ``src/repro_torch`` with level 2 on this build's
     ``nvcc -Xptxas -v`` reports and the card's own limits
     (``get_device_properties``): any finding beyond
     ``boomlint_torch.baseline.json`` fails; one line per kernel:
     registers, static and dynamic shared memory at the envelope, spills,
     stack, resident CTAs a SM (the card's arithmetic). (b) The four
     kernels at the declared envelope of ``kernels/shapes.py``, held to
     their plain versions with phase 3's tolerance and tie rule and timed
     as there: both gather kernels at B=32, S=8,192, 4 columns × 768, 16
     scalars, a 4-clause DNF, k=128; both scans at n=200,000, d=768, a
     conjunction of all 16 scalars, k=128. (c) One served batch of 32
     under the default and the forced candidate-local cost model, run
     under ``torch.cuda.set_sync_debug_mode("warn")``: its synchronizing
     calls counted and attributed to the port's file:line; every line
     inside a hot function must be one of (a)'s findings (suppressed or
     baselined), or share its statement with one;
 13. the dense language models (``repro_torch.models``; plain torch, no
     custom kernel, so the kernel report is unchanged), after phase 9:
     (a) ``stablelm`` and ``qwen3`` smoke configs in f32 on the card and
     on the CPU with the same parameters — ``hidden``, the prefill's and
     four decode steps' logits within atol and rtol 1e-4, eight greedy
     tokens equal; (b) ``stablelm-1.6b`` at full width in f32, drawn on
     the card from a seeded ``torch.Generator("cuda")``: its parameter
     count less the LayerNorm biases equal to ``cfg.n_params()``, then
     prefill of B=8 × 512 tokens and four decode steps against the full
     forward's logits at the same positions (atol 2e-2, rtol 2e-3, TF32
     off); (c) the same model in bf16 (its config): ``greedy_generate``
     with B=8, a 512-token prompt and 64 steps, then the same loop timed
     with CUDA events (prefill, each step; read after the loop), its
     tokens equal to ``greedy_generate``'s, with peak memory and each time
     beside its bound, the device's own time of a step and of a prefill
     (replayed from a CUDA graph) and one profile of each; (d) ``bench.augment.lm_embed`` at full width on
     20,000 rows of ``datasets._scalar_table`` (seq 16, batch 256, 768-d):
     shape, finite, unit norms to 1e-3, two runs (own init, carried model)
     equal bit for bit, rows/s beside the bound; (e)
     ``launch.serve.main`` at ``stablelm-1.6b``'s full width (B=4, 32-token
     prompt, 16 steps) returns its tokens on the card;
     (f) ``qwen3-14b`` at full width, bf16 compute on its f32 parameters
     (each block cast at its use): ``greedy_generate`` with B=8, a
     512-token prompt and 64 steps, its tokens in the vocab, its peak
     memory beside the parameters' bytes and the whole-model bf16 copy
     the serving steps no longer hold; it runs in a process of its own
     right after phase 1;
 14. the SSM and hybrid language models (``models/mamba2.py``, ``lm``'s
     ``ssm`` and ``hybrid`` families; plain torch, no custom kernel), after
     phase 13: (a) ``mamba2`` and ``zamba2`` smoke configs in f32 on the
     card against the CPU, as 13 (a); (b) ``mamba2-370m`` and
     ``zamba2-2.7b`` at full width in f32, drawn on the card: the
     parameter count equal to ``cfg.n_params()`` plus what it leaves out,
     named leaf by leaf (the padded vocab's rows), then a prefill of B=8 ×
     256 tokens (a multiple of both SSD chunks; the scan pads nothing) and
     four decode steps against the full forward over 512 positions (atol
     2e-2, rtol 2e-3, TF32 off); (c) both in bf16: ``greedy_generate``
     with B=8, a 512-token prompt and 64 steps, timed as 13 (c), each time
     beside ``ssm_bounds`` (a decode step's bytes: weights as cast, the
     shared block at each use, the f32 head, the state and conv windows
     read and written, the k/v rows; the prefill's bf16 products, f32 SSD
     contractions and attention scores, the larger); (d)
     ``launch.serve.main`` for both archs at full width returns its tokens
     on the card;
 15. the ``moe`` family (``models/moe.py``, ``moe_sharded.py``, MLA in
     ``attention.py``, ``lm``'s dense prefix and MoE blocks; plain torch,
     no custom kernel), in a process of its own right after phase 1 and
     13 (f), each model freed before the next: (a) the ``deepseek-v3``
     (MLA, MTP) and ``kimi-k2`` smoke configs in f32 on the card against
     the CPU at their own capacity factor (the prompt drops): ``hidden``
     and its aux, logits, every layer's cache (1e-4); and
     ``moe_apply_sharded`` over four ``gloo`` ranks sharing the card on a
     (data 2, model 2) mesh: at ``capacity_factor=8`` against one-process
     ``moe_apply``, at 1.25 (the first data shard overflowing) against
     the same ranks on the CPU; (b) ``deepseek-v3-671b`` at full width
     cut to 4 layers (3 dense + 1 MoE) in f32 at ``capacity_factor`` E/k
     = 32, where nothing can drop (at 8 the random router overfills an
     expert, and the dropped share is printed):
     its parameters beside ``n_params()`` (the MTP block's MoE FFN that it
     counts, named), a B=2 × 128 prefill and four decode steps against
     the full forward (atol 2e-2, rtol 2e-3), the first layer's absorbed
     MLA decode against the expanded form; (c) ``deepseek-v3-671b`` (4
     layers) and ``kimi-k2-1t-a32b`` (2 layers) in bf16 on bf16
     parameters (``param_dtype="bfloat16"``, the router f32) at their own
     capacity factor: ``greedy_generate`` with B=8, a 512-token prompt and
     64 steps, timed as 13 (c), beside ``moe_bounds``, with the prompt's
     ``moe_drop_frac``;
 16. LM training (``models/lm.loss_fn`` with remat, ``train/step``,
     ``train/optimizer``, ``checkpoint/ckpt``, ``launch/train``; plain
     torch, no custom kernel: the reference's training path reaches no
     Pallas kernel), in a process of its own right after 15: (a) the
     ``stablelm``, ``deepseek-v3`` (MLA, MTP, the MoE aux), ``mamba2`` and
     ``zamba2`` smoke configs in f32, three ``make_train_step`` steps on
     the card and on the CPU from the same parameters and batches under
     AdamW f32, AdamW int8 with two microbatches and Adafactor with two:
     every loss, metric and parameter within 1e-4 (but up to
     ``TRAIN_FLIP_SHARE`` of a leaf at Adam's noise floor, each within the
     steps' summed learning rates); (b) ``stablelm-1.6b`` at full width
     and depth, f32 parameters, bf16 compute, its ``TRAIN_PLANS`` plan as
     ``launch.train`` assembles it (four microbatches, remat, int8 first
     moment, the cosine schedule over the run), B=8 × 2,048 tokens of
     ``SyntheticLM(seed=0)``: the parameter count against ``n_params()``,
     the first step's loss and gradient norm with remat against without
     and one microbatch against four, each within 1e-2 relative, then
     eight steps, every loss finite and the last below the first, timed
     with CUDA events and one step profiled (device time, idle share),
     beside ``train_bounds``, peak memory beside the parameters, f32
     gradients and moments; (c) ``mamba2-370m`` at full width (f32
     parameters, bf16 compute, B=4 × 512) through ``launch.train.main``:
     every gradient leaf of the first step finite, four steps straight
     against two, a checkpoint and two resumed (steps 3–4 within rtol
     1e-4), the checkpoint's bytes and its save and restore seconds;
     (b) and (c) time their steps with CUDA events and profile none;
 17. the mesh slice (``models/sharding.py``, DTensor training through
     ``train/step.py``, ``distributed/pipeline.py``, ``launch/dryrun.py``;
     plain torch, no custom kernel), in a process of its own right after
     16: (a) the ``stablelm`` (AdamW f32, AdamW int8 with two
     microbatches) and ``deepseek-v3`` (``moe_impl="sharded"``, reached
     through ``_moe_dispatch``) smoke configs, two steps as DTensors over
     four ``gloo`` ranks on a (data 2, model 2) mesh (their tensors on the
     host: torch 2.11's functional collectives over ``gloo`` on CUDA
     tensors crash), against the same steps in one process on the card
     (losses and
     parameters within 1e-4, Adam's noise-floor elements as in 16 (a)),
     the last step's collectives by kind and bytes and its ms beside the
     one-process step's; (b) 16 (b)'s ``stablelm-1.6b`` step as DTensors
     on a one-rank NCCL (1, 1) mesh: its first loss within 1e-3 relative
     of 16 (b)'s plain first step, the steps' ms beside 16 (b)'s, a warm
     step's peak memory; (c) ``pipeline_apply`` over four ``gloo`` stages
     on the card, eight microbatches, one smoke block a stage, against
     the blocks in turn (1e-5): the hand-off path, the ticks, each
     stage's idle share beside ``bubble(4, 8)``; (d) the dry-run in a
     process of its own (torch's fake process group, meta tensors):
     ``stablelm-1.6b × train_4k`` and ``deepseek-v3-671b × decode_32k`` on
     16×16, ``dryrun_boomhq`` C0–C2, and 16 (b)'s step on a (1, 1) mesh,
     whose predicted peak must be within ±15% of (b)'s measured one.

The ``launches`` of the kernel report sum the main paths' counts (phase 4,
7, 9, 10 and 11's serving passes, phase 11's ranks included, 11 (d)'s
too, phase 8's
searches for the gather kernels; phase 5 for the scans); phase 12 (b)'s
are apart, as ``envelope_launches``; ``chip_smoke.json`` keeps each
phase's apart. The phases run in the order 1, 13 (f), 15, 16, 17, 2, 12 (a, b),
3, 4, 12 (c), 5, 10, 11 (a–c), 6–8, 9 (a), 11 (d), 9 (b), 13 (a–e), 14.

The line before the last is the JSON kernel report; the last line is
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import ast
import asyncio
import concurrent.futures
import contextlib
import copy
import dataclasses
import datetime
import json
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
ROWS = 200_000  # the paper's row count for part
SOURCES = ("gather_score", "masked_topk")
GRAPH_DEGREE = 16  # BoomHQConfig's default
N_SERVE = 256  # unseen serving queries
BATCH = 32
ATOL, RTOL = 1e-3, 1e-4
RECALL_SPREAD = 0.02  # allowed gap between two recall means on one run
UPDATE_RATIOS = (0.1, 0.5)  # two of benchmarks/data_updates.RATIOS
UPDATE_SEED = 0  # data_updates.run's seed; insert r draws seed + int(r·1e4)
SIFT_ROWS = 1_000_000  # the paper's row count for sift
SIFT_NPROBE = 4
# phase 3's gather shapes that phase 7 repeats on each grown table
GROWN_SHAPES = ("S=8192 C=1 dot", "S=8192 C=1 dot kq=128",
                "S=8192 range 10% k=32", "S=8192 range 10% kq=128")
# phase 9: benchmarks/serving.run_semcache's tenants and cache trace, and
# benchmarks/data_updates.run_mixed's tiered stream, at full width
TENANTS = 3
CACHE_UNIQUE, CACHE_TRACE, CACHE_INSERT = 16, 80, 48
HOT_CAPACITY = 2048
HOT_CASE_ROWS = 1500  # phase 3's hot view: a tail of -1 past its count
MIXED_REQUESTS, MIXED_BATCH, MIXED_WAIT = 256, 16, 0.02
# arrivals go on past MIXED_REQUESTS until the ingest has ended and every
# compaction has published, then MIXED_TAIL more, at most MIXED_MAX in all
MIXED_TAIL, MIXED_MAX = 2 * MIXED_BATCH, 16384
MIXED_UTILIZATION = 0.6
MIXED_INSERT_RATIO, MIXED_CHUNKS = 0.1, 8
PAUSE_SLACK = 0.25  # run_mixed's slack for asyncio scheduling jitter
# phase 10: logical shard counts served, and phase 3's sharded probe shape
# (S=4 shards of the table, a global max_scan of 8192 split over them)
SHARD_COUNTS = (1, 2, 4)
SHARD_PROBE, SHARD_MAX_SCAN = 4, 8192
# phase 11: the gloo ranks of (b), every process group's timeout, and the
# score tolerance of a mesh rank against the logical shards
MESH_RANKS = 4
MESH_TIMEOUT_S = 120
MESH_ATOL = 1e-5
T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in a CUDA
    graph, whose replay is timed with CUDA events, so the host's enqueue
    (a wrapper's checks and allocations) is out of the reading."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cuda_time_ms(graph.replay, iters=5, warmup=1) / iters


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def build_kernels() -> dict:
    """Build the port's CUDA sources in parallel (one ``nvcc`` each, all
    started together). -> {source: seconds to its build's end}."""
    from repro_torch.kernels import build

    def one(name):
        build.build(name)
        return name, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        secs = dict(pool.map(one, SOURCES))
    for name in SOURCES:
        path = build.library_path(name)
        log(f"built {path.name} in {secs[name]:.2f} s")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("    " + line.strip())
    return secs


def build_graphs(table) -> tuple:
    """The per-column graphs BoomHQ builds at its default degree, timed
    one column at a time. -> (graphs, seconds per column)."""
    from repro_torch.vectordb import graph

    graphs, secs = [], []
    for v in table.vectors:
        torch.cuda.synchronize()
        t = time.perf_counter()
        graphs.append(graph.build(v, GRAPH_DEGREE,
                                  metric=table.schema.metric))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        log(f"graph of a {v.shape[1]}-d column: {secs[-1]:.1f} s")
    return tuple(graphs), secs


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def smoke_config():
    """Phase 4's ``BoomHQConfig``: 32 IVF clusters, the default graph tier,
    the quickstart's encoder and rewriter step budgets, labels without the
    per-column trim (``scripts/update_witness.py`` fits the same)."""
    from repro_torch.core.boomhq import BoomHQConfig
    from repro_torch.core.data_encoder import DataEncoderConfig
    from repro_torch.core.rewriter import RewriterConfig

    return BoomHQConfig(
        n_clusters=32,
        encoder=DataEncoderConfig(frozen_steps=40, ae_steps=80, sample=1024),
        rewriter=RewriterConfig(steps=200, refine_columns=False))


def smoke_workloads(table, n_serve: int = N_SERVE) -> tuple:
    """Phase 4's workloads on ``table``: 40 training queries (24
    conjunctive + 16 DNF) and ``n_serve`` unseen serving queries (half
    each). -> (fit, serve)."""
    from repro_torch.bench import queries as qgen

    fit_wl = qgen.gen_workload(table, 24, n_vec_used=2, seed=1) + \
        qgen.gen_dnf_workload(table, 16, n_vec_used=2, seed=2)
    serve_wl = qgen.gen_workload(table, n_serve // 2, n_vec_used=2, seed=3) \
        + qgen.gen_dnf_workload(table, n_serve // 2, n_vec_used=2, seed=4)
    return fit_wl, serve_wl


def _random_dnf(m: int, c: int, b: int, scal_np: np.ndarray, rng, device):
    from repro_torch.vectordb.predicates import PredicateSet, stack

    preds = []
    for _ in range(b):
        clauses = []
        for _ in range(c):
            col = int(rng.integers(0, m))
            lo, hi = np.quantile(scal_np[:, col], sorted(rng.uniform(0, 1, 2)))
            clauses.append({col: (float(lo), float(hi))})
        preds.append(PredicateSet.from_clauses(m, clauses, n_clauses=c,
                                               device=device))
    return stack(preds)


def _gather_traffic(cand, dims, elem_bytes, m, k, *, int8, l2, qual=None):
    """The least work of one gather-score call. -> (bytes, flops).

    Bytes: the candidate matrix and the queries read and the block outputs
    written once; each distinct row read once (a row that several queries'
    slots repeat need not leave HBM twice) — with a predicate (``qual``:
    the (B, S) qualifying slots), the scalars of every distinct row a valid
    slot names and the vectors (and int8 scales) of the distinct rows that
    qualify for some slot, since a row that qualifies nowhere scores NEG
    whatever its vector holds; without one, every named row's vectors.
    Flops: the dots (and norms) of every slot that must be scored."""
    b, s = cand.shape
    named = cand[cand >= 0]
    scored = named if qual is None else cand[qual]
    vec_row = sum(d * elem_bytes for d in dims) + (4 * len(dims) if int8
                                                   else 0)
    bytes_ = int(torch.unique(scored).numel()) * vec_row \
        + b * s * 4 + b * -(-s // 256) * (8 * k + 4) + b * sum(dims) * 4
    if qual is not None:
        bytes_ += int(torch.unique(named).numel()) * 4 * m
    flops = int(scored.numel()) * sum(dims) * (4 if l2 else 2)
    return bytes_, flops


def _bound_ms(cand, dims, elem_bytes, m, k, *, int8, l2, qual=None):
    """Least time for one call: ``_gather_traffic``'s bytes over 3.35 TB/s
    against its flops over 67 TFLOP/s, the larger. -> (ms, what binds)."""
    bytes_, flops = _gather_traffic(cand, dims, elem_bytes, m, k, int8=int8,
                                    l2=l2, qual=qual)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _held_to_plain(label, got_s, got_i, plain_s, plain_i, rescore) -> tuple:
    """Scores within atol/rtol, ids equal except where the plain version
    itself ties (the kernel and cuBLAS sum the dots in other orders, so
    near-ties may come out in either order): a slot whose id differs must
    name a row whose plain score (``rescore(ids)``: the plain formula and
    mask recomputed for those ids, NEG for -1 or an excluded row) lies
    within the tolerance of the plain score at that slot, no row may come
    twice, and every row the plain version scores above its last live
    slot by more than the tolerance must be among the kernel's. -> (max
    |score error| over live slots, id swaps)."""
    if not torch.allclose(got_s, plain_s, atol=ATOL, rtol=RTOL):
        raise AssertionError(f"{label}: scores differ beyond atol={ATOL}, "
                             f"rtol={RTOL}")
    got_i, plain_i = got_i.long(), plain_i.long()
    tol = ATOL + RTOL * plain_s.abs()
    swapped = got_i != plain_i
    if bool(swapped.any()):
        redo = rescore(got_i)
        if bool((swapped & ((redo - plain_s).abs() > tol)).any()):
            raise AssertionError(f"{label}: a kernel id names a row whose "
                                 f"plain score does not tie the plain "
                                 f"version's at its slot")
    g, p, ps, t = (x.reshape(-1, x.shape[-1])
                   for x in (got_i, plain_i, plain_s, tol))
    srt = g.sort(dim=1).values
    if bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()):
        raise AssertionError(f"{label}: the kernel returns a row twice")
    last = torch.where(p >= 0, ps, torch.full_like(ps, float("inf"))).min(
        dim=1, keepdim=True).values
    clear = (p >= 0) & (ps > last + t)
    if bool((clear & ~(p[:, :, None] == g[:, None, :]).any(-1)).any()):
        raise AssertionError(f"{label}: the kernel misses a row the plain "
                             f"version ranks clear of ties")
    live = plain_s > -1e29
    err = float((got_s - plain_s).abs()[live].max()) if live.any() else 0.0
    return err, int(swapped.sum())


def _refuses_planted_ids(label, got_s, got_i, plain_s, plain_i,
                         rescore) -> None:
    """Swap the ids of two live slots whose plain scores differ beyond the
    tolerance — scores and id set untouched — and require
    ``_held_to_plain`` to refuse the result."""
    g = got_i.reshape(-1, got_i.shape[-1]).long().clone()
    ps = plain_s.reshape(-1, plain_s.shape[-1])
    for r in range(g.shape[0]):
        live = torch.nonzero(g[r] >= 0).flatten()
        if live.numel() < 2:
            continue
        i, j = int(live[0]), int(live[-1])
        if float((ps[r, i] - ps[r, j]).abs()) > ATOL + RTOL * float(
                ps[r, i].abs()):
            g[r, i], g[r, j] = g[r, j].clone(), g[r, i].clone()
            break
    else:
        raise AssertionError(f"{label}: no two live slots to swap")
    try:
        _held_to_plain(label, got_s, g.reshape(got_i.shape), plain_s,
                       plain_i, rescore)
    except AssertionError as e:
        if "does not tie" in str(e):
            return
        raise
    raise AssertionError(f"{label}: the id check accepted swapped ids")


def _table_rescore(scores):
    """``rescore`` over a full-table score vector: each id's entry, NEG
    for -1."""
    from repro_torch.kernels.shapes import NEG

    return lambda ids: torch.where(ids >= 0, scores[ids.clamp(min=0)],
                                   torch.full(ids.shape, NEG,
                                              device=scores.device))


def gather_cases(table, index, graph_, queries, device) -> list:
    """Phase 3's gather-score shapes on the table (phases 7 and 8 reuse
    them on the grown table and at d=128). The price-range predicates use
    the last numeric scalar column; without a graph (``graph_`` None) the
    graph-walk pool is left out. -> [(label, variant, arguments of
    ``gather_score_topk``)]."""
    from repro_torch.core.executor import rrf_union_total, subquery_width
    from repro_torch.kernels.beam_search import seeded_candidates
    from repro_torch.vectordb import ivf, predicates
    from repro_torch.vectordb.algebra import col
    from repro_torch.vectordb.predicates import Predicates

    rng = np.random.default_rng(0)
    scal_np = table.scalars.cpu().numpy()
    m = table.schema.n_scalar
    b = BATCH
    n_vec = table.schema.n_vec
    qcols = tuple(torch.stack([q.query_vectors[i] for q in queries[:b]])
                  for i in range(n_vec))
    q0 = qcols[0]
    range_col = max(i for i, c in enumerate(table.schema.scalar_cols)
                    if c.kind == "num")
    rows, valid = ivf.probe_slots_batch(index, q0, nprobe=2, max_scan=8192)
    cand = torch.where(valid, rows, torch.full_like(rows, -1)).to(torch.int32)
    vq, sc = table.quantized(0)
    ones = torch.ones((b, 1), device=device)
    cases = []
    for c in (1, 2, 4):
        pred = _random_dnf(m, c, b, scal_np, rng, device)
        for metric in ("dot", "l2"):
            cases.append((f"S=8192 C={c} {metric}", "fp32",
                          dict(cand=cand, vectors=(table.vectors[0],),
                               qs=(q0,), w=ones, pred=pred, k=32,
                               metric=metric, scales=None)))
            cases.append((f"S=8192 C={c} {metric} kq=128", "int8",
                          dict(cand=cand, vectors=(vq,), qs=(q0,), w=ones,
                               pred=pred, k=128, metric=metric,
                               scales=(sc,))))
    # the rerank shape: every column over the RRF candidate union, no mask
    s_rr = rrf_union_total(n_vec * 40)
    w2 = torch.as_tensor(np.asarray([q.weights for q in queries[:b]],
                                    np.float32), device=device)
    rr = torch.randint(0, table.n_rows, (b, s_rr), device=device,
                       dtype=torch.int32)
    cases.append((f"rerank S={s_rr} {n_vec} cols", "fp32",
                  dict(cand=rr, vectors=tuple(table.vectors), qs=qcols,
                       w=w2, pred=None, k=10, metric="dot", scales=None)))
    if graph_ is not None:
        # the extraction of a graph walk at the largest knobs: every row
        # the walk visited, under the queries' own predicates, at the
        # subquery width of k_mult=8
        pred_w = predicates.stack([q.predicates for q in queries[:b]])
        walk, _ = seeded_candidates(
            graph_.neighbors, graph_.entry_points, table.vectors[0],
            table.scalars, pred_w, q0, beam_width=16, n_hops=8,
            metric=table.schema.metric)
        cases.append((f"graph walk S={walk.shape[1]}", "fp32",
                      dict(cand=walk, vectors=(table.vectors[0],), qs=(q0,),
                           w=ones, pred=pred_w,
                           k=subquery_width(8 * 10, table.n_rows),
                           metric=table.schema.metric, scales=None)))
    # both gather kernels' selectivity branches: ≈1%, ≈10% and 100% price
    # ranges, the denormal strict bounds of ~(col == 0) on a column holding
    # zeros, and one conjunction over all M columns
    sel_preds = [(f"range {frac:.0%}", predicates.stack(
        [_range_pred(scal_np, frac, device, col=range_col)] * b))
        for frac in (0.01, 0.10, 1.0)]
    zero_cols = [c for c in range(m) if (scal_np[:, c] == 0).any()]
    if not zero_cols:
        raise AssertionError("no scalar column holds a zero")
    zc = zero_cols[0]
    not_zero = (~(col(zc) == 0.0)).compile(m=m, device=device)
    tiny = float(np.nextafter(np.float32(0), np.float32(1)))
    if not (bool((not_zero.lo == tiny).any())
            and bool((not_zero.hi == -tiny).any())):
        raise AssertionError("~(col == 0) did not compile to ±1.4e-45")
    sel_preds.append((f"~(col{zc} == 0)", predicates.stack([not_zero] * b)))
    sel_preds.append((f"all {m} cols", predicates.stack([
        Predicates.from_conditions(m, {c: tuple(float(x) for x in np.quantile(
            scal_np[:, c], [0.02, 0.9])) for c in range(m)}, device=device)]
        * b)))
    for label, pred in sel_preds:
        cases.append((f"S=8192 {label} kq=128", "int8",
                      dict(cand=cand, vectors=(vq,), qs=(q0,), w=ones,
                           pred=pred, k=128, metric="dot", scales=(sc,))))
    for label, pred in sel_preds:
        cases.append((f"S=8192 {label} k=32", "fp32",
                      dict(cand=cand, vectors=(table.vectors[0],), qs=(q0,),
                           w=ones, pred=pred, k=32, metric="dot",
                           scales=None)))
    return cases


def hot_case(table, queries, device, count: int = HOT_CASE_ROWS) -> list:
    """Phase 3's hot-segment gather shape, the arguments
    ``tiered._hot_topk`` gives ``gather_score_topk``: a hot view of
    ``HOT_CAPACITY`` slots holding ``count`` rows (``tenant_skewed_insert``
    of the tenant ``table``), candidates ``arange(capacity)`` with the
    slots from ``count`` on set to -1, broadcast over the first ``BATCH``
    tenanted ``queries``, rows and scalars from the view's own buffer,
    every vector column weighted, predicates folded on the tenant column,
    k the padded bucket of k=10. -> one ``check_kernels`` case."""
    from repro_torch.core.executor import K_BUCKET_FLOOR, next_bucket
    from repro_torch.vectordb import predicates
    from repro_torch.vectordb.tiered import HotView

    vecs, scal = tenant_skewed_insert(table, count, UPDATE_SEED + 7)
    buf_v = [np.zeros((HOT_CAPACITY, v.shape[1]), np.float32) for v in vecs]
    buf_s = np.zeros((HOT_CAPACITY, scal.shape[1]), np.float32)
    for b, v in zip(buf_v, vecs):
        b[:count] = v
    buf_s[:count] = scal
    view = HotView(tuple(buf_v), buf_s, count, table.n_rows, device)
    qs = queries[:BATCH]
    tcol = table.schema.n_scalar - 1
    pred = predicates.stack([predicates.fold_conjunct(
        q.predicates, tcol, float(q.tenant_id), float(q.tenant_id))
        for q in qs])
    slots = torch.arange(HOT_CAPACITY, dtype=torch.int32, device=device)
    cand = torch.where(slots < count, slots, torch.full_like(slots, -1))
    return [(f"hot S={HOT_CAPACITY} count={count} "
             f"M={table.schema.n_scalar}", "fp32",
             dict(cand=cand.expand(len(qs), -1).contiguous(),
                  vectors=view.vectors,
                  qs=tuple(torch.stack([q.query_vectors[i] for q in qs])
                           for i in range(table.schema.n_vec)),
                  w=torch.as_tensor(np.asarray([q.weights for q in qs],
                                               np.float32), device=device),
                  pred=pred, k=next_bucket(10, K_BUCKET_FLOOR),
                  metric=table.schema.metric, scales=None,
                  scalars=view.scalars))]


def sharded_case(table, queries, device) -> list:
    """Phase 3's sharded probe shape, the arguments
    ``distributed.sharded_ivf_topk`` gives ``gather_score_topk`` for one
    probed column, with every column weighted: the first ``BATCH`` queries
    × ``SHARD_PROBE`` shards folded into ``SHARD_PROBE · BATCH`` rows, each
    row the slots of ``legalize_for_shard(k_i=20, nprobe=2,
    max_scan=SHARD_MAX_SCAN)`` (2,048) probed in its own shard's index of
    column 0 (a ``ShardedIVF`` of 32 clusters a shard) and globalized, a
    one-clause DNF per query, k the probe width. -> one ``check_kernels``
    case."""
    from repro_torch.core.executor import legalize_for_shard, subquery_width
    from repro_torch.vectordb import distributed, predicates

    rng = np.random.default_rng(1)
    qs = queries[:BATCH]
    metric = table.schema.metric
    sivf = distributed.build_sharded_ivf(table.vectors[0], SHARD_PROBE,
                                         n_clusters=32, seed=0,
                                         metric=metric)
    k_s, np_s, ms_s = legalize_for_shard(
        20, 2, SHARD_MAX_SCAN, n_shards=SHARD_PROBE,
        shard_len=sivf.shard_len, n_clusters=sivf.n_clusters)
    if ms_s != min(sivf.shard_len, SHARD_MAX_SCAN // SHARD_PROBE):
        raise AssertionError(f"per-shard slot budget {ms_s}")
    qcols = tuple(torch.stack([q.query_vectors[i] for q in qs])
                  for i in range(table.schema.n_vec))
    cand = distributed.probe_shards(
        sivf.centroids, sivf.sorted_rows, sivf.offsets, qcols[0],
        sivf.shard_len, metric=metric, nprobe=np_s, max_scan=ms_s)
    fold = np.tile(np.arange(len(qs)), SHARD_PROBE)
    pred = predicates.take(_random_dnf(table.schema.n_scalar, 1, len(qs),
                                       table.scalars.cpu().numpy(), rng,
                                       device), fold)
    w = torch.as_tensor(np.asarray([q.weights for q in qs], np.float32),
                        device=device)
    return [(f"sharded S={SHARD_PROBE}x{len(qs)} slots={ms_s} C=1 "
             f"{table.schema.n_vec} cols", "fp32",
             dict(cand=cand, vectors=tuple(table.vectors),
                  qs=tuple(q.repeat(SHARD_PROBE, 1) for q in qcols),
                  w=w.repeat(SHARD_PROBE, 1), pred=pred,
                  k=subquery_width(k_s, ms_s), metric=metric,
                  scales=None))]


def check_kernels(table, cases, device) -> list:
    """Gather-score kernel vs plain version on ``cases`` ((label, variant,
    arguments of ``gather_score_topk``), as ``gather_cases`` gives them;
    a case's ``scalars`` stand in for the table's, as a hot view's do).
    Returns one row per (shape, variant)."""
    from repro_torch.kernels import gather_score as gs
    from repro_torch.kernels.ref import gather_score_ref, gather_scores_ref
    from repro_torch.vectordb import predicates

    out = []
    for label, variant, a in cases:
        scal = a.get("scalars", table.scalars)
        m = scal.shape[1]
        b = a["cand"].shape[0]

        def kern(a=a, scal=scal):
            return gs.gather_score_topk(a["cand"], a["vectors"], a["qs"],
                                        a["w"], scal, a["pred"],
                                        k=a["k"], metric=a["metric"],
                                        scales=a["scales"])

        fields = gs._pred_fields(a["pred"], b, m, device)

        def plain(a=a, fields=fields, scal=scal):
            return gather_score_ref(a["cand"], a["vectors"], a["qs"], a["w"],
                                    scal, *fields, k=a["k"],
                                    metric=a["metric"],
                                    apply_pred=a["pred"] is not None,
                                    scales=a["scales"])

        ids_k, s_k, q_k = kern()
        ids_p, s_p, q_p = plain()
        torch.cuda.synchronize()
        if not torch.equal(q_k.long(), q_p.long()):
            raise AssertionError(f"{label} {variant}: qualifying counts "
                                 f"differ from the plain version")
        def rescore(ids, a=a, fields=fields, scal=scal):
            return gather_scores_ref(
                ids.to(torch.int32), a["vectors"], a["qs"], a["w"],
                scal, *fields, metric=a["metric"],
                apply_pred=a["pred"] is not None, scales=a["scales"])[0]

        err, n_swaps = _held_to_plain(f"{label} {variant}", s_k, ids_k, s_p,
                                      ids_p, rescore)
        _refuses_planted_ids(f"{label} {variant}", s_k, ids_k, s_p, ids_p,
                             rescore)
        ms = cuda_time_ms(kern)
        s_len = a["cand"].shape[1]
        bs = min(256, gs._next_pow2(max(s_len, a["k"], 8)))
        # the kernel alone takes S in whole blocks: pad as the entry does
        cand_k = torch.cat([a["cand"], torch.full(
            (b, (-s_len) % bs), -1, dtype=torch.int32, device=device)], 1)

        def blocks(a=a, fields=fields, cand_k=cand_k, bs=bs, scal=scal):
            return gs.gather_score_blocks(
                cand_k, a["vectors"], a["qs"], a["w"], scal,
                *(f.contiguous() for f in fields), a["scales"], k=a["k"],
                block_s=bs, metric=a["metric"],
                apply_pred=a["pred"] is not None)

        kernel_only_ms = cuda_time_ms(blocks)
        device_ms = graph_time_ms(blocks)
        plain_ms = cuda_time_ms(plain, iters=5, warmup=1)
        elem = 1 if variant == "int8" else 4
        dims = [v.shape[1] for v in a["vectors"]]
        qual = None if a["pred"] is None else (
            predicates.eval_mask(a["pred"], scal[
                a["cand"].clamp(min=0).long()]) & (a["cand"] >= 0))
        bound, by = _bound_ms(a["cand"], dims, elem, m, a["k"],
                              int8=variant == "int8",
                              l2=a["metric"] == "l2", qual=qual)
        n_valid = int((a["cand"] >= 0).sum())
        sel = 1.0 if qual is None else int(qual.sum()) / max(n_valid, 1)
        row = dict(shape=label, variant=variant, ms=ms,
                   kernel_only_ms=kernel_only_ms, device_ms=device_ms,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   max_abs_err=err, tie_swaps=n_swaps,
                   qualifying_share=sel)
        out.append(row)
        log(f"  {variant} {label:28s} entry {ms:7.4f} ms (kernel "
            f"{kernel_only_ms:7.4f}, device {device_ms:7.4f})  plain "
            f"{plain_ms:8.4f} ms  bound {bound:8.4f} ms ({by})  "
            f"qualifying {sel:.4f}  max|err| {err:.3g}  tie swaps "
            f"{n_swaps}")
    return out


def _scan_bound_ms(n, d, m, k, nb, *, n_qual, any_active, int8, l2):
    """Least time for one full-table scan: every row's scalars when some
    column is active (none when no column is), the vectors (int8: + the f32
    scale) of the ``n_qual`` qualifying rows only — a failing row scores NEG
    whatever its vector holds — the query and predicate read and the block
    pools written once, against the dots (and l2 norms) of the qualifying
    rows. ``n_qual=n, any_active=True`` counts every row's vector and
    scalars. -> (ms, what binds)."""
    bytes_ = (n * 4 * m if any_active else 0) \
        + n_qual * (d * (1 if int8 else 4) + (4 if int8 else 0)) \
        + 4 * (d + 3 * m) + nb * k * 8
    flops = n_qual * d * (4 if l2 else 2)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _range_pred(scal_np, frac, device, col=3):
    """A conjunctive (M,) range on column ``col`` (``part``'s uniform
    price by default) holding about ``frac`` of the rows; ``frac`` 1
    activates no column."""
    from repro_torch.vectordb.predicates import Predicates

    m = scal_np.shape[1]
    if frac >= 1.0:
        return Predicates.none(m, device=device)
    lo, hi = np.quantile(scal_np[:, col], [0.5 - frac / 2, 0.5 + frac / 2])
    return Predicates.from_conditions(m, {col: (float(lo), float(hi))},
                                      device=device)


def _all_cols_pred(scal_np, device):
    """A conjunction over all M columns: each column's central 47.5% by
    quantile, ≈12.5% of the 200,000-row ``part`` table in all (two of its
    columns are discrete, so the share moves in steps)."""
    from repro_torch.vectordb.predicates import Predicates

    return Predicates.from_conditions(scal_np.shape[1], {
        c: tuple(float(x) for x in np.quantile(scal_np[:, c],
                                               [0.2625, 0.7375]))
        for c in range(scal_np.shape[1])}, device=device)


def check_scans(table, q, device, *, preds=None, ks=(10, 128),
                variants=("dot", "l2", "int8")) -> list:
    """Full-table scan kernels vs their plain versions on column 0 for the
    query ``q``: fp32 (dot, l2) and int8, k ∈ {10, 128}, ≈1%, ≈10% and
    100% price ranges and one conjunction over all M columns, unless
    ``preds``, ``ks`` or ``variants`` name others. Returns one row per
    (variant, k, predicate)."""
    from repro_torch.kernels import masked_topk as mt
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.shapes import SCAN_BLOCK_ROWS

    scal_np = table.scalars.cpu().numpy()
    v0 = table.vectors[0]
    n, d = v0.shape
    m = table.schema.n_scalar
    vq, sc = table.quantized(0)
    nb = -(-n // SCAN_BLOCK_ROWS)
    out = []
    if preds is None:
        preds = [_range_pred(scal_np, frac, device)
                 for frac in (0.01, 0.10, 1.0)]
        preds.append(_all_cols_pred(scal_np, device))
    for p in preds:
        lo, hi, act = (x.to(torch.float32) for x in (p.lo, p.hi, p.active))
        n_qual = int(torch.all(((table.scalars >= lo) & (table.scalars <= hi))
                               | (act < 0.5), dim=1).sum())
        n_act = int((act >= 0.5).sum())
        for k in ks:
            for variant in variants:
                int8 = variant == "int8"
                if int8:
                    def kern(k=k, lo=lo, hi=hi, act=act):
                        return ops.int8_masked_topk(q, vq, sc, table.scalars,
                                                    lo, hi, act, k=k)

                    def plain(k=k, lo=lo, hi=hi, act=act):
                        return ref.int8_topk_ref(q, vq, sc, table.scalars,
                                                 lo, hi, act, n, k=k)

                    def blocks(k=k, lo=lo, hi=hi, act=act):
                        return mt.launch_blocks(
                            q, vq, sc, table.scalars, lo, hi, act, n, k=k,
                            block_rows=SCAN_BLOCK_ROWS, metric="dot")
                else:
                    def kern(k=k, lo=lo, hi=hi, act=act, metric=variant):
                        return ops.masked_topk(q, v0, table.scalars, lo, hi,
                                               act, k=k, metric=metric)

                    def plain(k=k, lo=lo, hi=hi, act=act, metric=variant):
                        return ref.masked_topk_ref(q, v0, table.scalars, lo,
                                                   hi, act, n, k=k,
                                                   metric=metric)

                    def blocks(k=k, lo=lo, hi=hi, act=act, metric=variant):
                        return mt.masked_topk_blocks(
                            q, v0, table.scalars, lo, hi, act, n, k=k,
                            metric=metric)
                label = (f"{variant} k={k} sel={n_qual / n:.4f}"
                         + (f" {n_act} cols" if n_act > 1 else ""))
                s_k, i_k, valid = kern()
                s_p, i_p = plain()
                torch.cuda.synchronize()
                if not torch.equal(valid, i_p >= 0):
                    raise AssertionError(f"scan {label}: valid slots differ "
                                         f"from the plain version")
                deq = vq.to(torch.float32) * sc[:, None] if int8 else v0

                def rescore(ids, lo=lo, hi=hi, act=act, deq=deq,
                            metric="dot" if int8 else variant):
                    return _table_rescore(ref.scan_scores_ref(
                        q, deq, table.scalars, lo, hi, act, n,
                        metric=metric))(ids)

                err, n_swaps = _held_to_plain(f"scan {label}", s_k, i_k, s_p,
                                              i_p, rescore)
                _refuses_planted_ids(f"scan {label}", s_k, i_k, s_p, i_p,
                                     rescore)
                ms = cuda_time_ms(kern)
                kernel_only_ms = cuda_time_ms(blocks)
                device_ms = graph_time_ms(blocks)
                plain_ms = cuda_time_ms(plain, iters=5, warmup=1)
                bound, by = _scan_bound_ms(n, d, m, k, nb, n_qual=n_qual,
                                           any_active=n_act > 0, int8=int8,
                                           l2=variant == "l2")
                bound_all = _scan_bound_ms(n, d, m, k, nb, n_qual=n,
                                           any_active=True, int8=int8,
                                           l2=variant == "l2")[0]
                out.append(dict(shape=label, variant=variant, k=k,
                                selectivity=n_qual / n, active_cols=n_act,
                                ms=ms, kernel_only_ms=kernel_only_ms,
                                device_ms=device_ms,
                                plain_ms=plain_ms, bound_ms=bound,
                                bound_by=by, bound_all_rows_ms=bound_all,
                                max_abs_err=err, tie_swaps=n_swaps))
                log(f"  scan {label:33s} entry {ms:7.4f} ms (kernel "
                    f"{kernel_only_ms:7.4f}, device {device_ms:7.4f})  "
                    f"plain {plain_ms:8.4f} ms  "
                    f"bound {bound:7.4f} ms ({by}), all rows "
                    f"{bound_all:7.4f}  max|err| {err:.3g}  "
                    f"tie swaps {n_swaps}")
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def serve_pass(bq, queries, gt, label):
    from repro_torch.kernels import gather_score as gs
    from repro_torch.serve.batch import ServingEngine

    before = dict(gs.LAUNCHES)
    engine = ServingEngine(bq, batch_size=BATCH)
    engine.warmup(queries)
    results, report = engine.serve(queries, gt_ids=gt)
    launches = {k: gs.LAUNCHES[k] - before[k] for k in gs.LAUNCHES}
    _check_results(results, label)
    log(f"  serve[{label}]: {report.describe()}; kernel launches {launches}")
    return report, launches, results


def _check_results(results, label) -> None:
    for ids, scores in results:
        if ids.shape != (10,) or not np.isfinite(scores[ids >= 0]).all():
            raise AssertionError(f"{label}: malformed result {ids} {scores}")


def graph_plan(n_vec: int, beam_width: int = 8, n_hops: int = 4,
               k_mult: int = 2):
    """A fixed graph plan; the defaults are the third pass's (beam 8, 4
    hops, k_i = 2k)."""
    from repro_torch.core.query import ExecutionPlan, SubqueryParams

    return ExecutionPlan("graph", tuple(
        SubqueryParams(k_mult=k_mult, iterative=False) for _ in range(n_vec)),
        beam_width=beam_width, n_hops=n_hops)


def graph_pass(bq, queries, gt, plan, label) -> dict:
    """The serving queries through the batched executor under one fixed
    graph plan, batch by batch after one warm-up batch."""
    from repro_torch.core.executor import recall_at_k
    from repro_torch.kernels import gather_score as gs

    bx = bq._batched_executor()
    bx.execute_batch(queries[:BATCH], [plan] * BATCH)
    bx.dispatcher.take()
    before = dict(gs.LAUNCHES)
    torch.cuda.synchronize()
    t = time.perf_counter()
    results = []
    for s in range(0, len(queries), BATCH):
        part = queries[s: s + BATCH]
        results.extend(bx.execute_batch(part, [plan] * len(part)))
    seconds = time.perf_counter() - t
    counts, decisions = bx.dispatcher.take()
    launches = {k: gs.LAUNCHES[k] - before[k] for k in gs.LAUNCHES}
    _check_results(results, "graph plan")
    recall = float(np.mean([recall_at_k(ids, g)
                            for (ids, _), g in zip(results, gt)]))
    out = dict(qps=len(queries) / seconds, seconds=seconds,
               mean_recall=recall, path_counts=counts, launches=launches,
               groups=len(decisions),
               graph_groups=sum(d["group"][0] == "gr" for d in decisions))
    log(f"  serve[{label}]: {len(queries)} queries in "
        f"{seconds:.2f}s ({out['qps']:.1f} QPS, mean recall {recall:.4f}), "
        f"{out['graph_groups']} graph groups of {out['groups']}, kernel "
        f"launches {launches}")
    return out


def scan_pass(table, queries) -> dict:
    """The full-table scan path: each conjunctive query's column-0 vector
    under its own predicate through ``ops.masked_topk`` and
    ``ops.int8_masked_topk``, held to ``flat.ground_truth`` on column 0."""
    from repro_torch.core.executor import recall_at_k
    from repro_torch.kernels import masked_topk as mt
    from repro_torch.kernels import ops, ref
    from repro_torch.vectordb import flat
    from repro_torch.vectordb.predicates import Predicates

    conj = [q for q in queries if isinstance(q.predicates, Predicates)]
    vq, sc = table.quantized(0)
    zero = torch.zeros_like(conj[0].query_vectors[1])
    mt.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = []
    for q in conj:
        p = q.predicates
        got.append((ops.masked_topk(q.query_vectors[0], table.vectors[0],
                                    table.scalars, p.lo, p.hi, p.active,
                                    k=q.k, metric=table.schema.metric),
                    ops.int8_masked_topk(q.query_vectors[0], vq, sc,
                                         table.scalars, p.lo, p.hi, p.active,
                                         k=q.k)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = dict(mt.LAUNCHES)
    errs, swaps, recalls = [], 0, []
    for q, ((s, i, v), (s8, i8, v8)) in zip(conj, got):
        p = q.predicates
        gt_i, gt_s = flat.ground_truth(table, [q.query_vectors[0], zero],
                                       [1.0, 0.0], q.predicates, q.k)
        if not torch.equal(v, gt_i >= 0) or not torch.equal(v8, v):
            raise AssertionError("scan path: valid slots differ from the "
                                 "ground truth")
        rescore = _table_rescore(ref.scan_scores_ref(
            q.query_vectors[0], table.vectors[0], table.scalars, p.lo, p.hi,
            p.active, table.n_rows, metric=table.schema.metric))
        err, n_sw = _held_to_plain("scan path", s, i, gt_s, gt_i, rescore)
        errs.append(err)
        swaps += n_sw
        recalls.append(recall_at_k(i8, gt_i))
    out = dict(queries=len(conj), seconds=seconds, launches=launches,
               max_abs_err=max(errs), tie_swaps=swaps,
               int8_mean_recall=float(np.mean(recalls)))
    log(f"  scan path: {len(conj)} queries x (fp32 + int8 scan) in "
        f"{seconds:.3f} s; launches {launches}; fp32 vs ground truth max|err| "
        f"{out['max_abs_err']:.3g}, {swaps} tie swaps; int8 recall@10 "
        f"{out['int8_mean_recall']:.4f}")
    return out


def profile_batch(run, top: int = 8) -> dict:
    """Device time by kernel (and copy) over one batch; their sum over the
    batch's wall time is the device's busy share. Prints the ``top``
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.key.startswith(("aten::", "cuda")):
            continue  # operators and runtime calls; their kernels are listed
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    log(f"  profile: wall {wall_ms:.2f} ms, device busy {device_ms:.2f} ms "
        f"({100 * device_ms / max(wall_ms, 1e-9):.1f}%)")
    for key, ms, cnt in rows[:top]:
        print(f"    {ms:9.3f} ms  x{cnt:<5d} {key[:90]}")
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                launches=sum(r[2] for r in rows),
                top=[dict(kernel=k, ms=ms, count=c) for k, ms, c in rows[:12]])


# ---------------------------------------------------------------------------
# phase 7: data updates
# ---------------------------------------------------------------------------

def skewed_insert(table, n_new: int, seed: int):
    """Rows whose vectors are shifted and whose scalars are re-correlated:
    a plain-numpy copy of ``benchmarks/data_updates._skewed_insert``
    (same draws, same order), reading the table's current columns."""
    rng = np.random.default_rng(seed)
    vecs = []
    for i, vc in enumerate(table.schema.vector_cols):
        base = table.vectors[i].cpu().numpy()
        mu = base.mean(axis=0) + 0.8 * base.std(axis=0)  # distribution shift
        vecs.append((mu[None] + 0.4 * rng.normal(
            size=(n_new, vc.dim))).astype(np.float32))
    scal = table.scalars.cpu().numpy()
    idx = rng.integers(0, scal.shape[0], n_new)
    new_scal = scal[idx].copy()
    m = new_scal.shape[1]
    new_scal[:, m - 1] = new_scal[:, m - 1] * 1.5 + 1.0  # shift a numeric col
    return vecs, new_scal.astype(np.float32)


def check_layout(index, n: int, label: str) -> None:
    """An IVF layout over ``n`` rows: offsets from 0 to n, non-decreasing,
    and ``sorted_rows`` a permutation of range(n)."""
    rows = index.sorted_rows.long()
    off = index.offsets.long()
    if int(off[0]) != 0 or int(off[-1]) != n or bool((off[1:] < off[:-1])
                                                     .any()):
        raise AssertionError(f"{label}: offsets do not run from 0 to {n}")
    if rows.numel() != n or not torch.equal(
            torch.sort(rows).values, torch.arange(n, device=rows.device)):
        raise AssertionError(f"{label}: sorted_rows is not a permutation of "
                             f"range({n})")


def check_int8_carry(table, n_old: int, old_q, old_s, label: str) -> None:
    """Column 0's int8 replica carried across the append: built without a
    call to ``quantized``, its old rows and scales byte for byte the
    pre-insert replica's, its new rows ``quantize_rows`` of the new rows."""
    from repro_torch.kernels.int8_scan import quantize_rows

    if table.vectors_i8 is None or table.vectors_i8[0] is None:
        raise AssertionError(f"{label}: the int8 replica was not carried")
    q, s = table.vectors_i8[0], table.scales[0]
    if q.shape[0] != table.n_rows or s.shape[0] != table.n_rows:
        raise AssertionError(f"{label}: the replica holds {q.shape[0]} rows "
                             f"of {table.n_rows}")
    if not (torch.equal(q[:n_old], old_q) and torch.equal(s[:n_old], old_s)):
        raise AssertionError(f"{label}: the replica's old rows changed")
    nq, ns = quantize_rows(table.vectors[0][n_old:])
    if not (torch.equal(q[n_old:], nq) and torch.equal(s[n_old:], ns)):
        raise AssertionError(f"{label}: the replica's new rows are not the "
                             f"quantized new rows")


def new_row_shares(gt, results, first_new: int, label: str) -> tuple:
    """(share of ground-truth ids, share of served ids) that are rows
    ``first_new`` and later; refuses results that hold no such row when
    the ground truth holds some."""
    gt_ids = np.concatenate([np.asarray(g) for g in gt])
    served = np.concatenate([np.asarray(ids) for ids, _ in results])
    gt_ids, served = gt_ids[gt_ids >= 0], served[served >= 0]
    gt_new = float(np.mean(gt_ids >= first_new)) if gt_ids.size else 0.0
    served_new = float(np.mean(served >= first_new)) if served.size else 0.0
    if gt_new > 0 and served_new == 0:
        raise AssertionError(f"{label}: the ground truth holds new rows "
                             f"({gt_new:.4f} of its ids) but no served "
                             f"result does")
    return gt_new, served_new


def update_phase(bq, queries, device) -> dict:
    """Phase 7: two skewed inserts into the served instance (ratios 0.1 and
    0.5 of ``benchmarks/data_updates.RATIOS``: an incremental and a regroup
    IVF splice), each checked, served on both scoring paths and timed by
    step. -> the per-insert report and the serving passes' launches."""
    from repro_torch.core.executor import recall_at_k
    from repro_torch.core.query import default_plan
    from repro_torch.kernels import gather_score as gs
    from repro_torch.serve.batch import CANDIDATE_LOCAL, SLOT_BUDGET, \
        CostModel, pow2_at_most, MAX_BATCH_KERNEL
    from repro_torch.vectordb import flat, ivf

    base = bq.table.n_rows
    bq.table.quantized(0)
    paths: list = []
    inner = {name: getattr(ivf, name) for name in ("_extend_incremental",
                                                   "_extend_regroup")}

    def counted(name):
        def fn(*a):
            paths.append(name.split("_")[-1])
            return inner[name](*a)
        return fn

    launches = {k: 0 for k in gs.LAUNCHES}
    inserts, inserted = [], 0
    for ratio in UPDATE_RATIOS:
        add = int(base * ratio) - inserted
        t = bq.table
        n_old = t.n_rows
        vecs, scal = skewed_insert(t, add, UPDATE_SEED + int(ratio * 1e4))
        old_q, old_s = (x.clone() for x in t.quantized(0))
        expect = ("incremental" if add <= max(1, int(
            n_old * ivf.EXTEND_INCREMENTAL_FRACTION)) else "regroup")
        paths.clear()
        for name in inner:
            setattr(ivf, name, counted(name))
        try:
            t0 = time.perf_counter()
            enc = bq.insert(vecs, scal, finetune=True)
            seconds = time.perf_counter() - t0
        finally:
            for name, fn in inner.items():
                setattr(ivf, name, fn)
        inserted += add
        n = bq.table.n_rows
        label = f"insert +{add} ({n} rows)"
        if paths != [expect] * len(bq.indexes):
            raise AssertionError(f"{label}: IVF extend took {paths}, "
                                 f"expected {expect}")
        for i, idx in enumerate(bq.indexes):
            check_layout(idx, n, f"{label} index {i}")
        if float(bq.hists.n_rows) != n:
            raise AssertionError(f"{label}: histograms count "
                                 f"{float(bq.hists.n_rows)} rows")
        if any(g.n_rows != n for g in bq.graphs):
            raise AssertionError(f"{label}: a graph does not hold {n} rows")
        check_int8_carry(bq.table, n_old, old_q, old_s, label)
        del old_q, old_s
        sizes = np.diff(bq.indexes[0].offsets.cpu().numpy())
        log(f"  {label}: {seconds:.2f} s, IVF {expect}; by step "
            + ", ".join(f"{k} {v:.3f}" for k, v in bq.insert_seconds.items())
            + f"; encoder {enc}; column-0 lists {sizes.min()}-{sizes.max()} "
            f"rows (mean {sizes.mean():.0f})")
        gt = [flat.ground_truth(bq.table, list(q.query_vectors),
                                list(q.weights), q.predicates, q.k)[0]
              .cpu().numpy() for q in queries]
        rep_d, l_d, res_d = serve_pass(bq, queries, gt, f"default, {n} rows")
        bq.bind_cost_model(CostModel(force=CANDIDATE_LOCAL))
        rep_c, l_c, res_c = serve_pass(bq, queries, gt,
                                       f"candidate_local, {n} rows")
        bq.bind_cost_model()
        robust = bq._batched_executor().execute_batch(
            queries, [default_plan(q.n_vec, bq.engine) for q in queries])
        robust_recall = float(np.mean([recall_at_k(ids, g) for (ids, _), g
                                       in zip(robust, gt)]))
        shares = {name: new_row_shares(gt, res, base, f"{label} {name}")
                  for name, res in (("default", res_d),
                                    ("candidate_local", res_c))}
        gt_new = shares["default"][0]
        served_new = {name: sh[1] for name, sh in shares.items()}
        by_strategy: dict = {}
        for s in range(0, len(queries), BATCH):
            for j, p in enumerate(bq.optimize_batch(queries[s: s + BATCH])):
                by_strategy.setdefault(bq.executor.legalize(p).strategy,
                                       []).append(s + j)
        by_strategy = {st: dict(
            queries=len(ix),
            learned=float(np.mean([recall_at_k(res_d[i][0], gt[i])
                                   for i in ix])),
            default_plan=float(np.mean([recall_at_k(robust[i][0], gt[i])
                                        for i in ix])))
            for st, ix in by_strategy.items()}
        for k in launches:
            launches[k] += l_d[k] + l_c[k]
        chunk = pow2_at_most(max(1, min(MAX_BATCH_KERNEL,
                                        SLOT_BUDGET // n)))
        row = dict(rows=n, added=add, ratio=ratio, ivf_path=expect,
                   seconds=seconds, seconds_by_step=dict(bq.insert_seconds),
                   encoder=enc, list_rows_min=int(sizes.min()),
                   list_rows_max=int(sizes.max()),
                   list_rows_mean=float(sizes.mean()),
                   batch_chunk=chunk, default_plan_recall=robust_recall,
                   recall_by_strategy=by_strategy,
                   gt_new_share=gt_new, served_new_share=served_new,
                   passes={name: dict(qps=rep.qps,
                                      mean_recall=rep.mean_recall,
                                      seconds=rep.seconds,
                                      path_counts=rep.path_counts,
                                      launches=lc)
                           for name, rep, lc in (("default", rep_d, l_d),
                                                 ("candidate_local", rep_c,
                                                  l_c))})
        log(f"  {label}: default_plan recall {robust_recall:.4f}; new rows "
            f"are {gt_new:.4f} of the ground truth's ids and {served_new} "
            f"of the served ids; batches chunked at {chunk}; recall by "
            f"learned strategy (learned / default_plan): "
            + ", ".join(f"{st} x{v['queries']} {v['learned']:.4f} / "
                        f"{v['default_plan']:.4f}"
                        for st, v in by_strategy.items()))
        if l_c["fp32"] <= 0:
            raise AssertionError(f"{label}: the fp32 gather kernel did not "
                                 f"launch")
        if abs(rep_d.mean_recall - rep_c.mean_recall) > RECALL_SPREAD:
            raise AssertionError(f"{label}: scoring paths disagree: "
                                 f"{rep_d.mean_recall} vs "
                                 f"{rep_c.mean_recall}")
        # reported, not enforced: after a skewed insert the learned plans
        # (trained on the pre-insert table) fall below default_plan in the
        # JAX package itself, on the same state, plans and queries
        # (scripts/update_witness.py), so that floor is no target for
        # the port; the witness holds the port to the JAX package there
        for name, rep in (("default", rep_d), ("candidate_local", rep_c)):
            below = rep.mean_recall < robust_recall - RECALL_SPREAD
            row["passes"][name]["below_default_plan"] = below
            if below:
                log(f"  {label}: {name} pass mean recall "
                    f"{rep.mean_recall:.4f} BELOW the default plan's "
                    f"{robust_recall:.4f} less {RECALL_SPREAD} (as in the "
                    f"JAX package; reported, not enforced)")
        # the gather kernels at the grown IVF shapes, held to their plain
        # versions
        grown = [c for c in gather_cases(bq.table, bq.indexes[0], None,
                                         queries, device)
                 if c[0] in GROWN_SHAPES]
        if len(grown) != len(GROWN_SHAPES):
            raise AssertionError(f"{label}: {len(grown)} of the "
                                 f"{len(GROWN_SHAPES)} grown shapes found")
        row["kernel_shapes"] = check_kernels(bq.table, grown, device)
        inserts.append(row)
    return dict(inserts=inserts, launches=launches)


# ---------------------------------------------------------------------------
# phase 8: a vector->scalar set at the paper's row count
# ---------------------------------------------------------------------------

def search_cases(table, index, queries, device) -> tuple:
    """The gather launches of phase 8's two candidate-local searches
    (``ivf.search_local_batch`` and ``search_local_batch_int8`` at nprobe
    ``SIFT_NPROBE`` over their own slot count, k=10, the queries'
    predicates) as ``check_kernels`` cases: the fp32 gather, the int8
    stage, and the fp32 rerank of the plain int8 stage's survivors.
    -> (cases, (plain fp32 search, plain int8 search) as
    ``gather_score_ref`` gives (ids, scores, n_qualified), rescore)."""
    from repro_torch.kernels import gather_score as gs
    from repro_torch.kernels.ref import gather_score_ref, gather_scores_ref
    from repro_torch.kernels.shapes import MAX_TOPK
    from repro_torch.vectordb import ivf, predicates

    k = 10
    kq = max(k, min(gs.RERANK_MULT * k, MAX_TOPK))
    metric = table.schema.metric
    max_scan = SIFT_NPROBE * table.n_rows // index.centroids.shape[0]
    pred = predicates.stack([q.predicates for q in queries])
    q_b = torch.stack([q.query_vectors[0] for q in queries])
    rows, valid = ivf.probe_slots_batch(index, q_b, nprobe=SIFT_NPROBE,
                                        max_scan=max_scan)
    cand = torch.where(valid, rows, torch.full_like(rows, -1)).to(torch.int32)
    vq, sc = table.quantized(0)
    v0 = table.vectors[0]
    ones = torch.ones((q_b.shape[0], 1), device=device)
    fields = gs._pred_fields(pred, q_b.shape[0], table.schema.n_scalar,
                             device)
    plain32 = gather_score_ref(cand, (v0,), (q_b,), ones, table.scalars,
                               *fields, k=k, metric=metric)
    surv = gather_score_ref(cand, (vq,), (q_b,), ones, table.scalars,
                            *fields, k=kq, metric=metric, scales=(sc,))
    ids8, s8, _ = gather_score_ref(surv[0], (v0,), (q_b,), ones,
                                   table.scalars, *fields, k=k,
                                   metric=metric, apply_pred=False)
    cases = [
        (f"search S={max_scan} k={k}", "fp32",
         dict(cand=cand, vectors=(v0,), qs=(q_b,), w=ones, pred=pred, k=k,
              metric=metric, scales=None)),
        (f"search S={max_scan} kq={kq}", "int8",
         dict(cand=cand, vectors=(vq,), qs=(q_b,), w=ones, pred=pred, k=kq,
              metric=metric, scales=(sc,))),
        (f"search rerank S={kq} k={k}", "fp32",
         dict(cand=surv[0], vectors=(v0,), qs=(q_b,), w=ones, pred=None,
              k=k, metric=metric, scales=None))]

    def rescore(ids):
        # the survivors qualify, so the predicate leaves the rerank's
        # exact fp32 scores as they are
        return gather_scores_ref(ids.to(torch.int32), (v0,), (q_b,), ones,
                                 table.scalars, *fields, metric=metric)[0]

    return cases, (plain32, (ids8, s8, plain32[2])), rescore


def sift_phase(device) -> dict:
    """Phase 8: ``sift`` at 1,000,000 rows (d=128, scalars from the three
    §4 constructions), one IVF index, phase 3's gather checks at d=128 on
    32 of its queries and at the searches' own shapes, then those queries
    through the candidate-local searches (fp32 and int8) with the gather
    counts zeroed, each search's result held to its plain version on the
    same candidates."""
    from repro_torch.bench import datasets, queries as qgen
    from repro_torch.core.boomhq import BoomHQConfig
    from repro_torch.core.executor import recall_at_k
    from repro_torch.kernels import gather_score as gs
    from repro_torch.vectordb import flat, ivf, predicates

    torch.cuda.synchronize()
    t = time.perf_counter()
    table = datasets.make("sift", rows=SIFT_ROWS, seed=0, device=device)
    vq, sc = table.quantized(0)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t
    scal = table.scalars.cpu().numpy()
    counts = {c.name: np.unique(scal[:, j], return_counts=True)
              for j, c in enumerate(table.schema.scalar_cols)}
    value_counts = {
        name: ({str(int(v)): int(n) for v, n in zip(*vc)}
               if table.schema.scalar_cols[j].kind == "cat"
               else dict(distinct=int(vc[0].size), min=float(vc[0][0]),
                         max=float(vc[0][-1])))
        for j, (name, vc) in enumerate(counts.items())}
    log(f"sift: {table.n_rows} rows x {table.vectors[0].shape[1]} built in "
        f"{make_s:.1f} s (with its int8 replica); scalar columns "
        + "; ".join(f"{k}: {v}" for k, v in value_counts.items()))
    t = time.perf_counter()
    n_clusters = BoomHQConfig().n_clusters
    index = ivf.build(table.vectors[0], n_clusters, seed=0,
                      metric=table.schema.metric)
    torch.cuda.synchronize()
    ivf_s = time.perf_counter() - t
    wl = qgen.gen_workload(table, BATCH, n_vec_used=1, seed=3)
    log(f"sift: IVF of {n_clusters} clusters in {ivf_s:.1f} s; "
        f"{len(wl)} queries")
    s_cases, plains, rescore = search_cases(table, index, wl, device)
    rows = check_kernels(table, gather_cases(table, index, None, wl, device)
                         + s_cases, device)
    pred_b = predicates.stack([q.predicates for q in wl])
    q_b = torch.stack([q.query_vectors[0] for q in wl])
    gt = [flat.ground_truth(table, list(q.query_vectors), list(q.weights),
                            q.predicates, q.k)[0].cpu().numpy() for q in wl]
    max_scan = SIFT_NPROBE * table.n_rows // n_clusters
    gs.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = ivf.search_local_batch(index, table.vectors[0], table.scalars,
                                 pred_b, q_b, nprobe=SIFT_NPROBE,
                                 max_scan=max_scan, k=10)
    got8 = ivf.search_local_batch_int8(
        index, table.vectors[0], vq, sc, table.scalars, pred_b, q_b,
        nprobe=SIFT_NPROBE, max_scan=max_scan, k=10)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t
    launches = dict(gs.LAUNCHES)
    recalls, held = {}, {}
    for name, (ids, scores, _, n_qual), (p_ids, p_s, p_qual) in (
            ("fp32", got, plains[0]), ("int8", got8, plains[1])):
        if not torch.equal(n_qual.long(), p_qual.long()):
            raise AssertionError(f"sift search {name}: qualifying counts "
                                 f"differ from the plain version")
        err, swaps = _held_to_plain(f"sift search {name}", scores, ids, p_s,
                                    p_ids, rescore)
        held[name] = dict(max_abs_err=err, tie_swaps=swaps)
        ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
        if ids.shape != (BATCH, 10) or not np.isfinite(
                scores[ids >= 0]).all():
            raise AssertionError(f"sift search {name}: malformed result")
        recalls[name] = float(np.mean([recall_at_k(i, g)
                                       for i, g in zip(ids, gt)]))
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"sift search: the {name} gather kernel "
                                 f"never launched")
    log(f"  sift search (nprobe {SIFT_NPROBE}, {max_scan} slots): "
        f"{BATCH} queries x (fp32 + int8) in {search_s:.3f} s; launches "
        f"{launches}; held to the plain searches {held}; recall@10 fp32 "
        f"{recalls['fp32']:.4f}, int8 {recalls['int8']:.4f}")
    return dict(rows=table.n_rows, dim=int(table.vectors[0].shape[1]),
                make_s=make_s, ivf_s=ivf_s, n_clusters=n_clusters,
                value_counts=value_counts, kernel_shapes=rows,
                search=dict(nprobe=SIFT_NPROBE, max_scan=max_scan,
                            seconds=search_s, recall=recalls,
                            held_to_plain=held),
                launches=launches)


# ---------------------------------------------------------------------------
# phase 9: the tiered, tenanted, cached path
# ---------------------------------------------------------------------------

def semcache_draws(n_rows: int, seed: int = 0) -> tuple:
    """``benchmarks/serving.run_semcache``'s draws from its one generator,
    in its order: a tenant for every row, then the repeat trace (every
    unique query once, then random repeats). -> (tenants, trace, the
    generator)."""
    rng = np.random.default_rng(seed + 11)
    tcol = rng.integers(0, TENANTS, n_rows).astype(np.float32)
    trace = list(range(CACHE_UNIQUE)) + [
        int(i) for i in rng.integers(0, CACHE_UNIQUE,
                                     CACHE_TRACE - CACHE_UNIQUE)]
    return tcol, trace, rng


def tenant_table(table):
    """``table`` with one more categorical scalar column, ``tenant``, of
    ``TENANTS`` values (``run_semcache``'s construction); the vector
    columns are ``table``'s own tensors."""
    from repro_torch.vectordb.table import ScalarCol, Table

    tcol = torch.as_tensor(semcache_draws(table.n_rows)[0],
                           device=table.device)
    schema = dataclasses.replace(table.schema, scalar_cols=tuple(
        table.schema.scalar_cols) + (ScalarCol("tenant", "cat", TENANTS),))
    return Table(schema, list(table.vectors),
                 torch.cat([table.scalars, tcol[:, None]], dim=1))


def tenant_skewed_insert(table, n_new: int, seed: int):
    """``skewed_insert`` rows for a tenant table: the skew drawn on the
    columns without the tenant (so the shifted column is the last numeric
    one, as in ``data_updates``), then one tenant a row from ``seed + 1``."""
    from repro_torch.vectordb.table import Table

    base = Table(dataclasses.replace(
        table.schema, scalar_cols=table.schema.scalar_cols[:-1]),
        table.vectors, table.scalars[:, :-1])
    vecs, scal = skewed_insert(base, n_new, seed)
    tenant = np.random.default_rng(seed + 1).integers(
        0, TENANTS, n_new).astype(np.float32)
    return vecs, np.concatenate([scal, tenant[:, None]], axis=1)


def audit_cache(cache) -> list:
    """Log every ``lookup`` of ``cache`` (query, token, result or None)
    and every ``insert`` (query, token, result). -> the event list."""
    events = []
    lookup, insert = cache.lookup, cache.insert

    def logged_lookup(q, token):
        got = lookup(q, token)
        events.append(("lookup", q, tuple(token), None if got is None else
                       tuple(np.asarray(x).copy() for x in got)))
        return got

    def logged_insert(q, token, ids, scores):
        insert(q, token, ids, scores)
        events.append(("insert", q, tuple(token),
                       (np.asarray(ids).copy(), np.asarray(scores).copy())))

    cache.lookup, cache.insert = logged_lookup, logged_insert
    return events


def check_cache_events(events, label: str) -> int:
    """Each cache hit must be the entry that its exact query's last miss
    stored, under the token of the hit: a hit never crosses an epoch or a
    hot insert (either changes the ``(epoch, n_rows)`` token), and it
    replays the miss's ids and scores bit for bit. -> the hit count."""
    from repro_torch.serve.semcache import k_bucket, query_signature

    def key(q):
        return (q.tenant_id, query_signature(q), k_bucket(q.k),
                b"".join(v.cpu().numpy().tobytes() for v in q.query_vectors))

    stored, hits = {}, 0
    for kind, q, token, res in events:
        if kind == "insert":
            stored[key(q)] = (token, res)
            continue
        if res is None:
            continue
        hits += 1
        src = stored.get(key(q))
        if src is None or src[0] != token:
            raise AssertionError(
                f"{label}: a cache hit under token {token} was stored under "
                f"{None if src is None else src[0]}: a stale hit")
        if not (np.array_equal(res[0], src[1][0][: q.k])
                and np.array_equal(res[1], src[1][1][: q.k])):
            raise AssertionError(f"{label}: a cache hit does not replay its "
                                 f"miss's result")
    return hits


def check_tenant_ids(results, tenants, tenant_of_row, label: str) -> None:
    """Every id of a tenanted result names a row of its tenant.
    ``tenant_of_row``: the logical table's tenant column (numpy); rows
    never move, so the last snapshot's covers every id served before."""
    for (ids, _), t in zip(results, tenants):
        if t is None:
            continue
        ids = np.asarray(ids)
        ids = ids[ids >= 0]
        if ids.size and (int(ids.max()) >= tenant_of_row.shape[0]
                         or bool(np.any(tenant_of_row[ids] != t))):
            raise AssertionError(f"{label}: a result of tenant {t} holds a "
                                 f"row of another tenant")


def missed_hot_rows(ids, scores, oracle_ids, oracle_scores,
                    first_hot: int) -> list:
    """Rows of the hot segment (global id ≥ ``first_hot``) that the exact
    top-k (``oracle_ids``/``oracle_scores``) holds and the served result
    (``ids``/``scores``) lacks — except a row that ties the served k-th
    score within the phase-3 tolerance, which the merge may drop for its
    tie."""
    ids, scores = np.asarray(ids), np.asarray(scores)
    served = {int(i) for i in ids if i >= 0}
    kth = float(scores[-1]) if ids[-1] >= 0 else None
    out = []
    for h, sc in zip(np.asarray(oracle_ids), np.asarray(oracle_scores)):
        if h < first_hot or int(h) in served:
            continue
        if kth is not None and abs(float(sc) - kth) <= ATOL + RTOL * abs(kth):
            continue
        out.append(int(h))
    return out


def check_epochs_served(epochs, final_epoch: int, label: str) -> None:
    """The stream must run across an epoch publish: the snapshots its
    requests were served on span at least two epochs, the table's final
    one among them."""
    seen = sorted(set(int(e) for e in epochs))
    if len(seen) < 2 or seen[-1] != final_epoch:
        raise AssertionError(f"{label}: requests were served on epochs "
                             f"{seen} and the table ended at epoch "
                             f"{final_epoch}: no batch ran across a swap")


def count_launches(fn, counts: dict):
    """Run ``fn()`` with the gather launch counts set to 0 just before it
    and read just after: the serving launches add to ``counts["serving"]``,
    the compaction warm-up's to ``counts["prewarm"]``. -> ``fn()``."""
    from repro_torch.kernels import gather_score as gs

    gs.reset_launches()
    out = fn()
    for name, got in (("serving", gs.LAUNCHES),
                      ("prewarm", gs.PREWARM_LAUNCHES)):
        for k, v in got.items():
            counts[name][k] += v
    return out


def snapshot_topk(snap, queries, k: int = 10) -> tuple:
    """The exact filtered top-k over a tiered snapshot's cold ∪ hot rows
    in global id order, for resolved (tenant-folded) ``queries``: plain
    torch on the snapshot's device. -> (ids (B, k), scores (B, k)) numpy,
    id -1 past the qualifying rows."""
    from repro_torch.kernels.shapes import NEG
    from repro_torch.vectordb import predicates
    from repro_torch.vectordb.table import similarity_batch

    cold = snap.cold.table
    dev, metric, n_vec = cold.device, cold.schema.metric, cold.schema.n_vec
    segs = [(cold.vectors, cold.scalars)] + [
        (tuple(torch.from_numpy(b[: v.count]).to(dev) for b in v.np_vectors),
         torch.from_numpy(v.np_scalars[: v.count]).to(dev))
        for v in snap.hot_views]
    out_i, out_s = [], []
    for s in range(0, len(queries), MIXED_BATCH):
        qs = queries[s: s + MIXED_BATCH]
        pred = predicates.stack([q.predicates for q in qs])
        w = torch.as_tensor(np.asarray([q.weights for q in qs], np.float32),
                            device=dev)
        parts = []
        for vecs, scal in segs:
            tot = sum(w[:, i, None] * similarity_batch(
                torch.stack([q.query_vectors[i] for q in qs]), vecs[i],
                metric) for i in range(n_vec))
            parts.append(torch.where(predicates.eval_mask(pred, scal), tot,
                                     torch.full_like(tot, NEG)))
        top_s, top_i = torch.topk(torch.cat(parts, dim=1), k, dim=1)
        top_i = torch.where(top_s > NEG / 2, top_i, torch.full_like(top_i,
                                                                    -1))
        out_i.append(top_i.cpu().numpy())
        out_s.append(top_s.cpu().numpy())
    return np.concatenate(out_i), np.concatenate(out_s)


def _tenant_column(snap) -> np.ndarray:
    t = snap.cold.table
    col = t.schema.n_scalar - 1
    return np.concatenate([t.scalars[:, col].cpu().numpy()] + [
        v.np_scalars[: v.count, col] for v in snap.hot_views])


def cache_pass(bq, table, device, launches: dict) -> dict:
    """Phase 9 (a): ``run_semcache``'s trace through ``AsyncServingEngine``
    (batch 8, ``max_wait`` 0.002 s, requests one by one) without and with
    ``SemanticCache(eps=0)``, then the epoch-swap oracle under
    ``bind_tiered``: 48 rows go hot, then a compaction; the first pass
    after each must miss throughout. Each engine run's launches add to
    ``launches`` (``count_launches``)."""
    from repro_torch.bench import datasets, queries as qgen
    from repro_torch.core.executor import recall_at_k
    from repro_torch.serve.queue import AsyncServingEngine
    from repro_torch.serve.semcache import SemanticCache
    from repro_torch.vectordb import flat

    _, trace, rng = semcache_draws(table.n_rows)
    pool = [dataclasses.replace(q, tenant_id=i % TENANTS)
            for i, q in enumerate(qgen.gen_workload(
                table, CACHE_UNIQUE, n_vec_used=2, k=10, seed=100))]
    gts = [flat.ground_truth(table, list(q.query_vectors), list(q.weights),
                             bq.resolve_tenant(q).predicates, q.k)[0]
           .cpu().numpy() for q in pool]

    async def serve_seq(eng, qs):
        async with eng:
            t = time.perf_counter()
            reqs = [await eng.submit(q) for q in qs]
            return reqs, time.perf_counter() - t

    def engine(cache=None):
        return AsyncServingEngine(bq, batch_size=8, max_wait=0.002,
                                  semcache=cache)

    def serve(eng, qs):
        return count_launches(lambda: asyncio.run(serve_seq(eng, qs)),
                              launches)

    serve(engine(), pool)  # warm-up
    stream = [pool[i] for i in trace]
    reqs_b, dt_b = serve(engine(), stream)
    cache = SemanticCache(eps=0.0)
    events = audit_cache(cache)
    eng_c = engine(cache)
    reqs_c, dt_c = serve(eng_c, stream)
    hits = check_cache_events(events, "cache pass")
    rec_b = [recall_at_k(r.result[0], gts[trace[i]])
             for i, r in enumerate(reqs_b)]
    rec_c = [recall_at_k(r.result[0], gts[trace[i]])
             for i, r in enumerate(reqs_c)]
    parity_bad = sum(
        r.cache_hit and not (np.array_equal(r.result[0], b.result[0])
                             and np.array_equal(r.result[1], b.result[1]))
        for r, b in zip(reqs_c, reqs_b))
    rep = eng_c.report(gt_ids={r.seq: gts[trace[i]]
                               for i, r in enumerate(reqs_c)})
    tcol = table.scalars[:, -1].cpu().numpy()
    for reqs in (reqs_b, reqs_c):
        if any(r.status != "ok" for r in reqs):
            raise AssertionError("cache pass: a request did not resolve ok")
        check_tenant_ids([r.result for r in reqs],
                         [r.query.tenant_id for r in reqs], tcol,
                         "cache pass")
    if float(np.mean(rec_c)) != float(np.mean(rec_b)):
        raise AssertionError(f"cache pass: the cached run's recall "
                             f"{np.mean(rec_c)} is not the uncached run's "
                             f"{np.mean(rec_b)}")

    # the epoch-swap oracle: hot insert, then compaction
    bq.bind_tiered(hot_capacity=CACHE_INSERT + 16)
    swap_cache = SemanticCache(eps=0.0)
    swap_events = audit_cache(swap_cache)
    eng_s = engine(swap_cache)
    extra = datasets.make("part", rows=CACHE_INSERT, seed=31, device=device)
    new_scal = np.concatenate(
        [extra.scalars.cpu().numpy(), rng.integers(
            0, TENANTS, CACHE_INSERT).astype(np.float32)[:, None]], axis=1)

    async def swap_phase():
        async with eng_s:
            passes = {}
            for name in ("first", "warm", "after_insert", "after_swap",
                         "again"):
                if name == "after_insert":
                    bq.insert([v.cpu().numpy() for v in extra.vectors],
                              new_scal)
                elif name == "after_swap":
                    passes["compaction"] = bq.tiered.compact()
                passes[name] = [await eng_s.submit(q) for q in pool]
            return passes

    epoch0 = bq.tiered.epoch
    passes = count_launches(lambda: asyncio.run(swap_phase()), launches)
    swap_hits = {n: sum(r.cache_hit for r in passes[n])
                 for n in ("first", "warm", "after_insert", "after_swap",
                           "again")}
    check_cache_events(swap_events, "epoch swap")
    snap = bq.tiered.snapshot()
    for n in swap_hits:
        check_tenant_ids([r.result for r in passes[n]],
                         [r.query.tenant_id for r in passes[n]],
                         _tenant_column(snap), f"epoch swap {n}")
    if swap_hits["after_insert"] or swap_hits["after_swap"]:
        raise AssertionError(f"epoch swap: a hit crossed a hot insert or an "
                             f"epoch: {swap_hits}")
    if bq.tiered.epoch != epoch0 + 1 or swap_hits["warm"] != len(pool) or \
            swap_hits["again"] != len(pool):
        raise AssertionError(f"epoch swap: epoch {bq.tiered.epoch}, hits "
                             f"{swap_hits}")
    comp = passes["compaction"]
    bq.unbind_tiered()
    out = dict(
        requests=len(stream), qps_nocache=len(stream) / dt_b,
        qps_cache=len(stream) / dt_c, speedup=dt_b / dt_c,
        hit_rate=hits / len(stream), n_cache_hits=rep.n_cache_hits,
        mean_recall_uncached=float(np.mean(rec_b)),
        mean_recall_cached=float(np.mean(rec_c)),
        replay_parity_mismatches=int(parity_bad), per_tenant=rep.tenants,
        cache_stats=cache.stats(),
        epoch_swap=dict(hits=swap_hits, stats=swap_cache.stats(),
                        compaction=comp))
    log(f"  cache pass: {out['qps_nocache']:.1f} QPS uncached, "
        f"{out['qps_cache']:.1f} cached ({out['speedup']:.2f}x) at hit rate "
        f"{out['hit_rate']:.3f}; recall {out['mean_recall_uncached']:.4f} "
        f"both; {parity_bad} replay mismatches against the uncached run; "
        f"epoch swap hits {swap_hits}, stale drops "
        f"{swap_cache.stats()['stale_drops']}; compaction "
        f"{comp['seconds']:.2f} s")
    return out


def mixed_pass(bq, table, stream_wl, device, launches: dict) -> dict:
    """Phase 9 (b): ``benchmarks/data_updates.run_mixed`` at full width —
    tenanted Poisson arrivals through ``AsyncServingEngine`` while
    ``tenant_skewed_insert`` rows stream in and compact in the
    background. The arrivals go on until the ingest has ended and every
    compaction has published, so batches run across each epoch swap.
    Every batch, compaction step and hot-view scoring is timed; the
    serving passes' launches add to ``launches``."""
    from repro_torch.core.data_encoder import DataEncoder
    from repro_torch.core.executor import recall_at_k
    from repro_torch.core.query import default_plan
    from repro_torch.kernels import gather_score as gs
    from repro_torch.serve import batch as batchmod
    from repro_torch.serve.batch import warm_bucket_ladder
    from repro_torch.serve.queue import AsyncServingEngine
    from repro_torch.vectordb import graph as graphmod
    from repro_torch.vectordb import histogram, ivf, tiered
    from repro_torch.vectordb.table import Table

    bq.bind_tiered(hot_capacity=HOT_CAPACITY)

    def request(i):
        return stream_request(stream_wl, i)

    stream = [request(i) for i in range(MIXED_REQUESTS)]
    folded = [bq.resolve_tenant(q) for q in stream]

    def recalls(results, snap, qs):
        o_ids, _ = snapshot_topk(snap, qs)
        return [recall_at_k(r[0], g) for r, g in zip(results, o_ids)]

    snap0 = bq.tiered.snapshot()
    pre = count_launches(lambda: bq.execute_batch(stream), launches)
    pre_recall = float(np.mean(recalls(pre, snap0, folded)))
    warm_bucket_ladder(bq.execute_batch, stream, MIXED_BATCH)
    torch.cuda.synchronize()
    t = time.perf_counter()
    bq.execute_batch(stream[:MIXED_BATCH])
    warm_batch_s = time.perf_counter() - t
    lam = MIXED_UTILIZATION * MIXED_BATCH / warm_batch_s
    arrivals = np.random.default_rng(UPDATE_SEED + 17)
    n_insert = int(ROWS * MIXED_INSERT_RATIO)
    per = -(-n_insert // MIXED_CHUNKS)
    t = time.perf_counter()
    # set-up: each chunk's skew statistics over a host copy of the table,
    # the chunks drawn side by side (numpy's reductions leave the GIL)
    host = dataclasses.replace(table, vectors=[v.cpu() for v in
                                               table.vectors],
                               scalars=table.scalars.cpu())
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        chunks = list(pool.map(
            lambda d: tenant_skewed_insert(host, min(per, n_insert - d),
                                           UPDATE_SEED + 31 + d),
            range(0, n_insert, per)))
    del host
    data_s = time.perf_counter() - t

    exec_spans, compactions, hot = [], [], {"calls": 0, "fp32": 0}
    inner_exec, inner_compact = bq.execute_batch, bq.tiered.compact
    inner_hot = tiered._hot_topk
    in_flight = [0]  # compactions running (timed_compact)
    # each compaction's steps, timed to the end of their device work on the
    # compacting thread only (``step_secs.secs`` is set there); graph
    # extension's own steps — the kNN on the card, the reverse fill and
    # the reachability repair on the host — summed over all compactions
    step_secs = threading.local()
    graph_steps = ("_chunk_topk", "_reverse_fill", "_repair_reachability")
    graph_s = dict.fromkeys(graph_steps, 0.0)
    patches = [(Table, "append", "append"), (ivf, "extend", "ivf"),
               (ivf, "build", "ivf"), (histogram, "update", "histograms"),
               (graphmod, "extend", "graphs"),
               (DataEncoder, "update", "encoder"),
               (bq, "_prewarm_cold", "prewarm")] + [
        (graphmod, n, n) for n in graph_steps]
    saved = [(obj, attr, vars(obj).get(attr)) for obj, attr, _ in patches]
    saved.append((batchmod, "BatchedHybridExecutor",
                  batchmod.BatchedHybridExecutor))
    # the epoch executors built, and their seconds, by thread: the
    # compaction's warm-up builds the new epoch's; a batch on an older
    # snapshot rebuilds its own on the serving thread (one cache slot)
    builds = {"serving": [0, 0.0], "compaction": [0, 0.0]}

    def counted_build(*a, **kw):
        t0 = time.perf_counter()
        out = saved[-1][2](*a, **kw)
        torch.cuda.synchronize()
        b = builds["serving" if getattr(step_secs, "secs", None) is None
                   else "compaction"]
        b[0] += 1
        b[1] += time.perf_counter() - t0
        return out

    def timed(fn, step):
        def wrapper(*a, **kw):
            secs = graph_s if step in graph_s else getattr(step_secs, "secs",
                                                           None)
            if secs is None:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            secs[step] = secs.get(step, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    def timed_exec(queries, **kw):
        t0 = time.perf_counter()
        try:
            return inner_exec(queries, **kw)
        finally:
            exec_spans.append((t0, time.perf_counter(), list(queries)))

    def timed_compact():
        in_flight[0] += 1
        step_secs.secs = secs = {}
        t0 = time.perf_counter()
        try:
            out = inner_compact()
        finally:
            step_secs.secs = None
            in_flight[0] -= 1
        if out["compacted"]:
            # the encoder's copy and the query encoder's and executors'
            # rebuilds
            secs["other"] = out["seconds"] - sum(secs.values())
        compactions.append(dict(start=t0, end=time.perf_counter(),
                                seconds_by_step=secs, **out))
        return out

    def counted_hot(*a, **kw):
        before = gs.LAUNCHES["fp32"]
        out = inner_hot(*a, **kw)
        hot["calls"] += 1
        hot["fp32"] += gs.LAUNCHES["fp32"] - before
        return out

    async def drive():
        eng = AsyncServingEngine(bq, batch_size=MIXED_BATCH,
                                 max_wait=MIXED_WAIT, clock=time.perf_counter)
        loop = asyncio.get_running_loop()

        async def ingest():
            for vecs, scal in chunks:
                await loop.run_in_executor(None, bq.insert, vecs, scal)
                await asyncio.sleep(MIXED_REQUESTS / lam / MIXED_CHUNKS / 2)

        async with eng:
            ing = asyncio.ensure_future(ingest())
            tasks, end = [], MIXED_MAX
            for i in range(MIXED_MAX):
                if i >= end:
                    break
                if i > 0:
                    await asyncio.sleep(arrivals.exponential(1.0 / lam))
                tasks.append(asyncio.ensure_future(eng.submit(request(i))))
                if end == MIXED_MAX and ing.done() and not in_flight[0] \
                        and not bq.tiered.needs_compaction():
                    end = max(MIXED_REQUESTS, i + 1 + MIXED_TAIL)
            reqs = await asyncio.gather(*tasks)
            stream_end = time.perf_counter()
            await ing
        return eng, reqs, stream_end

    bq.execute_batch, bq.tiered.compact = timed_exec, timed_compact
    tiered._hot_topk = counted_hot
    for obj, attr, step in patches:
        setattr(obj, attr, timed(getattr(obj, attr), step))
    batchmod.BatchedHybridExecutor = counted_build
    try:
        t_start = time.perf_counter()
        eng, reqs, stream_end = count_launches(lambda: asyncio.run(drive()),
                                               launches)
        wall = time.perf_counter() - t_start
    finally:
        del bq.execute_batch, bq.tiered.compact
        tiered._hot_topk = inner_hot
        for obj, attr, fn in saved:
            if fn is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, fn)
    rep = eng.report()
    if any(r.status != "ok" for r in reqs):
        raise AssertionError(f"mixed pass: {sum(r.status != 'ok' for r in reqs)}"
                             f" requests did not resolve ok")

    # run_mixed's pause measure: with one execution worker, batch i+1 may
    # start once its cut deadline and batch i have both passed; more idle
    # time than the slack is the worker waiting on something else
    arrival_of = {id(r.query): r.arrival for r in reqs}
    gaps_idle, prev_end, serving_spans = [], None, []
    for start, end, qs in sorted(exec_spans, key=lambda x: x[0]):
        oldest = min((arrival_of[id(q)] for q in qs if id(q) in arrival_of),
                     default=None)
        if oldest is None:
            continue  # the compaction thread's warm-up batches
        serving_spans.append((start, end, len(qs)))
        ready = oldest + MIXED_WAIT if prev_end is None \
            else max(oldest + MIXED_WAIT, prev_end)
        gaps_idle.append(start - ready)
        prev_end = end
    violations = int(np.sum(np.asarray(gaps_idle) > PAUSE_SLACK))
    # what a compaction running beside a batch costs it: the batches'
    # seconds with and without one overlapping (the warm batch of 16,
    # timed alone before the stream, is the reference)
    busy = [(c["start"], c["end"]) for c in compactions if c["compacted"]]
    batch_ms: dict = {"during_compaction": [], "outside": []}
    for start, end, _ in serving_spans:
        beside = any(start < ce and end > cs for cs, ce in busy)
        batch_ms["during_compaction" if beside else "outside"].append(
            (end - start) * 1e3)

    # per request: recall and hot rows against its own snapshot's oracle
    by_snap: dict = {}
    for r in reqs:
        by_snap.setdefault(id(r.snapshot), (r.snapshot, []))[1].append(r)
    req_recall, missed, hot_in_oracle = {}, [], 0
    for snap, rs in by_snap.values():
        o_ids, o_s = snapshot_topk(snap, [r.query for r in rs])
        first_hot = snap.cold.table.n_rows
        for r, oi, os_ in zip(rs, o_ids, o_s):
            req_recall[r.seq] = recall_at_k(r.result[0], oi)
            hot_in_oracle += int(np.sum(oi >= first_hot))
            missed += missed_hot_rows(r.result[0], r.result[1], oi, os_,
                                      first_hot)
    by_epoch: dict = {}
    for r in reqs:
        by_epoch[r.snapshot.epoch] = by_epoch.get(r.snapshot.epoch, 0) + 1
    # an insert-only window: publishing views costs no transfer
    base_t = tiered.hot_view_transfers()
    extra = tenant_skewed_insert(table, 48, UPDATE_SEED + 99)
    for j in range(3):
        bq.insert([v[16 * j: 16 * (j + 1)] for v in extra[0]],
                  extra[1][16 * j: 16 * (j + 1)])
    transfers = tiered.hot_view_transfers() - base_t
    final = bq.tiered.snapshot()
    uniq = folded[: len(stream_wl)]
    post = count_launches(lambda: bq.execute_batch(
        stream[: len(stream_wl)], snapshot=final), launches)
    post_recall = float(np.mean(recalls(post, final, uniq)))
    # comparison, outside the launch windows: default_plan on the same state
    bx = bq._batched_executor(final.cold)
    dp = bx.execute_batch(uniq, [default_plan(q.n_vec, bq.engine)
                                 for q in uniq])
    if final.hot_views:
        dp = bq._merge_hot(dp, uniq, final)
    dp_recall = float(np.mean(recalls(dp, final, uniq)))
    check_tenant_ids([r.result for r in reqs],
                     [r.query.tenant_id for r in reqs],
                     _tenant_column(final), "mixed pass")
    if missed:
        raise AssertionError(f"mixed pass: served results miss {len(missed)}"
                             f" hot rows their snapshot's oracle ranks in the"
                             f" top-k: {missed[:8]}")
    if rep.n_compactions < 1 or rep.epoch != bq.tiered.epoch:
        raise AssertionError(f"mixed pass: {rep.n_compactions} compactions, "
                             f"engine epoch {rep.epoch} against the table's "
                             f"{bq.tiered.epoch}")
    check_epochs_served(list(by_epoch), bq.tiered.epoch, "mixed pass")
    if hot["calls"] <= 0 or hot["fp32"] <= 0:
        raise AssertionError(f"mixed pass: the fp32 gather kernel did not "
                             f"launch on the hot views ({hot})")
    if transfers != 0:
        raise AssertionError(f"mixed pass: {transfers} hot-view transfers "
                             f"over an insert-only window")
    done = [c for c in compactions if c["compacted"]]
    steps = sorted({k for c in done for k in c["seconds_by_step"]})
    out = dict(
        requests=len(reqs), lam=lam, warm_batch_s=warm_batch_s,
        insert_data_s=data_s, qps=rep.qps, qps_wall=len(reqs) / wall,
        stream_s=stream_end - t_start, wall_s=wall, p50_ms=rep.p50_ms,
        p99_ms=rep.p99_ms, p99_over_p50=rep.p99_ms / rep.p50_ms,
        n_batches=rep.n_batches, n_inserted=rep.n_inserted,
        n_compactions=rep.n_compactions, epoch=rep.epoch,
        requests_by_epoch={str(e): n for e, n in sorted(by_epoch.items())},
        executor_builds={k: dict(n=n, s=sec) for k, (n, sec) in
                         builds.items()},
        compactions=[dict(compacted=c["compacted"], seconds=c["seconds"],
                          start=c["start"] - t_start, end=c["end"] - t_start,
                          seconds_by_step=c["seconds_by_step"])
                     for c in done],
        idle_gaps_ms=[g * 1e3 for g in gaps_idle],
        max_idle_gap_ms=max(gaps_idle) * 1e3 if gaps_idle else 0.0,
        pause_violations=violations,
        pause_bound_ms=(MIXED_WAIT + max(e - s for s, e, _ in serving_spans)
                        + PAUSE_SLACK) * 1e3,
        batch_size_mean=float(np.mean([n for _, _, n in serving_spans])),
        graph_extend_s={n.lstrip("_"): v for n, v in graph_s.items()},
        batch_ms_mean={k: float(np.mean(v)) if v else None
                       for k, v in batch_ms.items()},
        batches={k: len(v) for k, v in batch_ms.items()},
        pre_insert_recall=pre_recall,
        request_recall=float(np.mean(list(req_recall.values()))),
        post_stream_recall=post_recall, default_plan_recall=dp_recall,
        hot_rows_in_oracle=hot_in_oracle, snapshots=len(by_snap),
        hot_calls=hot["calls"], hot_fp32_launches=hot["fp32"],
        hot_view_transfers_insert_only=transfers, per_tenant=rep.tenants)
    log(f"  mixed pass: {rep.describe()}")
    log(f"  mixed pass: stream {out['stream_s']:.2f} s of {wall:.2f} s; "
        f"p99/p50 {out['p99_over_p50']:.2f}; requests by epoch "
        f"{out['requests_by_epoch']}; epoch executors built "
        f"{out['executor_builds']}; {len(done)} compactions, seconds by "
        f"step (mean) " + ", ".join(
            f"{k} {np.mean([c['seconds_by_step'].get(k, 0.0) for c in done]):.3f}"
            for k in steps)
        + f"; batches {out['batches']} of mean ms {out['batch_ms_mean']} "
        f"(a warm batch of {MIXED_BATCH} alone: {warm_batch_s * 1e3:.1f} ms)"
        f"; graph extension's steps over all compactions (s) "
        f"{out['graph_extend_s']}"
        + f"; idle gaps max {out['max_idle_gap_ms']:.1f} ms, {violations} "
        f"over {PAUSE_SLACK} s (reported); recall pre {pre_recall:.4f}, per "
        f"request {out['request_recall']:.4f} over {len(by_snap)} snapshots "
        f"({hot_in_oracle} oracle slots hot), post {post_recall:.4f}, "
        f"default_plan {dp_recall:.4f}; hot views scored {hot['calls']}x "
        f"({hot['fp32']} fp32 launches); insert-only transfers {transfers}")
    return out


def tiered_phase(ttable, graphs, fit_wl, stream_wl, device, smi: str
                 ) -> dict:
    """Phase 9: fit on the tenant table, bind tenants, then the cache pass,
    phase 11 (d) (the mixed stream over a mesh of four ranks, on this
    instance) and the mixed ingest pass. The launch counts cover the
    serving runs only (``count_launches`` around each), the compaction
    warm-up's apart; the oracle and ``default_plan`` comparisons fall
    outside them."""
    from repro_torch.core.boomhq import BoomHQ

    bq = BoomHQ(ttable, smoke_config(), graphs=graphs)
    t = time.perf_counter()
    metrics = bq.fit(fit_wl)
    fit_s = time.perf_counter() - t
    bq.bind_tenants("tenant")
    log(f"phase 9: fit on {ttable.n_rows} rows x {ttable.schema.n_scalar} "
        f"scalars in {fit_s:.1f} s; tenants bound")
    launches = {name: {"fp32": 0, "int8": 0} for name in ("serving",
                                                            "prewarm")}
    cache = cache_pass(bq, ttable, device, launches)
    # phase 11 (d): this instance's stream over the mesh (its own counts)
    mesh_tiers = mesh_tiered(bq, stream_wl, device, smi)
    mixed = mixed_pass(bq, ttable, stream_wl, device, launches)
    log(f"  phase 9 launches: serving {launches['serving']}, compaction "
        f"warm-up {launches['prewarm']}")
    return dict(fit=metrics, fit_s=fit_s, cache=cache, mixed=mixed,
                launches=launches["serving"],
                prewarm_launches=launches["prewarm"], mesh_tiered=mesh_tiers)


# ---------------------------------------------------------------------------
# phase 10: logical shards
# ---------------------------------------------------------------------------

def _query_fields(table, queries):
    """(queries (tuple of (Q, d_i)), weights (Q, N), predicate fields) of a
    query list, as ``gather_score_topk`` takes them."""
    from repro_torch.kernels import gather_score as gs
    from repro_torch.vectordb import predicates

    dev = table.device
    qs = tuple(torch.stack([q.query_vectors[i] for q in queries])
               for i in range(table.schema.n_vec))
    w = torch.as_tensor(np.asarray([q.weights for q in queries], np.float32),
                        device=dev)
    fields = gs._pred_fields(predicates.stack([q.predicates for q in queries]),
                             len(queries), table.schema.n_scalar, dev)
    return qs, w, fields


def check_served(table, queries, results, label: str) -> float:
    """Every served result: ids distinct and in range, each live row
    satisfying its query's predicate and scored as the plain formula scores
    it (``ref.gather_scores_ref``, within the phase-3 tolerance), each -1
    slot at NEG. -> max |score error| over live slots."""
    from repro_torch.kernels.ref import gather_scores_ref
    from repro_torch.kernels.shapes import NEG

    dev = table.device
    ids = torch.as_tensor(np.stack([np.asarray(r[0]) for r in results]),
                          device=dev).to(torch.int32)
    sc = torch.as_tensor(np.stack([np.asarray(r[1], np.float32)
                                   for r in results]), device=dev)
    if bool((ids >= table.n_rows).any()) or bool((ids < -1).any()):
        raise AssertionError(f"{label}: a served id is out of range")
    srt = ids.sort(dim=1).values
    if bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()):
        raise AssertionError(f"{label}: a row is served twice")
    qs, w, fields = _query_fields(table, queries)
    redo = gather_scores_ref(ids, tuple(table.vectors), qs, w, table.scalars,
                             *fields, metric=table.schema.metric)[0]
    live = ids >= 0
    if bool((live & (redo <= NEG / 2)).any()):
        raise AssertionError(f"{label}: a served row fails its predicate")
    if bool((~live & (sc > NEG / 2)).any()):
        raise AssertionError(f"{label}: an empty slot carries a score")
    err = (sc - redo).abs()
    if bool((live & (err > ATOL + RTOL * redo.abs())).any()):
        raise AssertionError(f"{label}: a served score is not its row's")
    return float(err[live].max()) if bool(live.any()) else 0.0


def check_exact(table, queries, results, label: str) -> int:
    """Each result equals its query's exact filtered top-k
    (``flat.ground_truth``) under ``_held_to_plain``: scores within the
    phase-3 tolerance, ids equal except between ties. -> id swaps."""
    from repro_torch.vectordb import flat

    base = [flat.ground_truth(table, list(q.query_vectors), list(q.weights),
                              q.predicates, q.k) for q in queries]
    return check_tied(table, queries, results, base, label)


def check_tied(table, queries, results, base, label: str) -> int:
    """Each result equals its ``base`` result (ids, scores) under
    ``_held_to_plain``: scores within the phase-3 tolerance, ids equal
    except between ties. -> id swaps."""
    from repro_torch.kernels.ref import gather_scores_ref

    dev = table.device
    swaps = 0
    for q, (ids, scores), (gt_i, gt_s) in zip(queries, results, base):
        gt_i = torch.as_tensor(gt_i, device=dev)
        gt_s = torch.as_tensor(gt_s, device=dev)
        qs, w, fields = _query_fields(table, [q])

        def rescore(got, qs=qs, w=w, fields=fields):
            return gather_scores_ref(got.to(torch.int32), tuple(table.vectors),
                                     qs, w, table.scalars, *fields,
                                     metric=table.schema.metric)[0]

        swaps += _held_to_plain(
            label, torch.as_tensor(np.asarray(scores, np.float32),
                                   device=dev)[None],
            torch.as_tensor(np.asarray(ids), device=dev)[None],
            gt_s[None], gt_i[None], rescore)[1]
    return swaps


def check_same_results(results, base, label: str) -> None:
    """``results`` equal ``base`` bit for bit, ids and scores."""
    if len(results) != len(base):
        raise AssertionError(f"{label}: {len(results)} results, "
                             f"{len(base)} expected")
    for j, ((i1, s1), (i0, s0)) in enumerate(zip(results, base)):
        if not (np.array_equal(i1, i0) and np.array_equal(s1, s0)):
            raise AssertionError(f"{label}: query {j} differs from the "
                                 f"unsharded pass")


def check_shard_launches(chunks, label: str) -> None:
    """Each per-shard probing chunk launched the fp32 gather kernel once per
    probed column and once for its rerank, whatever its shard count, and
    never the int8 stage."""
    for c in chunks:
        if c["fp32"] != c["cols"] + 1 or c["int8"]:
            raise AssertionError(
                f"{label}: a chunk of {c['cols']} probed columns over "
                f"{c['shards']} shards launched {c['fp32']} fp32 and "
                f"{c['int8']} int8 gathers, expected {c['cols'] + 1} and 0")


def fixed_plan(n_vec: int, engine):
    """``default_plan`` without iterative re-expansion (per-shard probing
    has none): k_i = 4k, nprobe 16, max_scan 131,072 before the split."""
    from repro_torch.core.query import default_plan

    plan = default_plan(n_vec, engine)
    return dataclasses.replace(plan, subqueries=tuple(
        dataclasses.replace(sp, iterative=False) for sp in plan.subqueries))


@contextlib.contextmanager
def sharded_records():
    """Record, while the block runs, what the executor's sharded routes do.
    -> a dict of lists: ``chunks`` (one dict per per-shard probing chunk:
    its shard count, probed columns, queries, escalated queries and gather
    launches), ``exact`` (the ``id()`` of every query on the exact route),
    ``probes`` (each probing search's gathered per-shard ``fill`` and
    ``boundary``: on a mesh, the order the shards came in) and ``calls``
    (each ``execute_batch_sharded`` call: its queries, plans, dense
    matrices, results, escalated positions and probes)."""
    from repro_torch.kernels import gather_score as gs
    from repro_torch.serve.batch import BatchedHybridExecutor as BX

    rec = dict(chunks=[], exact=set(), probes=[], calls=[])
    orig = (BX._run_chunk_sharded_ivf, BX._run_chunk_sharded, BX._sivf_fn,
            BX.execute_batch_sharded)

    def counted_probe(self, key, qs, part, out, *, bucket_cap):
        before, kept = dict(gs.LAUNCHES), set(self.escalated)
        self.escalated.clear()
        orig[0](self, key, qs, part, out, bucket_cap=bucket_cap)
        rec["chunks"].append(dict(
            shards=self.n_shards, cols=len(key[3]), queries=len(qs),
            escalated=len(self.escalated),
            **{k: gs.LAUNCHES[k] - before[k] for k in gs.LAUNCHES}))
        self.escalated |= kept

    def counted_exact(self, qs, part, out, **kw):
        rec["exact"].update(id(q) for q in qs)
        return orig[1](self, qs, part, out, **kw)

    def recorded_search(self, key, act):
        fn = orig[2](self, key, act)

        def run(*args):
            res = fn(*args)
            rec["probes"].append((res[2].clone(), res[3].clone()))
            return res

        return run

    def captured_call(self, queries, plans=None, *, scores_b=None):
        kept, p0 = set(self.escalated), len(rec["probes"])
        self.escalated.clear()
        res = orig[3](self, queries, plans, scores_b=scores_b)
        rec["calls"].append(dict(
            queries=list(queries), plans=plans, scores_b=scores_b,
            results=res, escalated=set(self.escalated),
            probes=rec["probes"][p0:]))
        self.escalated |= kept
        return res

    (BX._run_chunk_sharded_ivf, BX._run_chunk_sharded, BX._sivf_fn,
     BX.execute_batch_sharded) = (counted_probe, counted_exact,
                                  recorded_search, captured_call)
    try:
        yield rec
    finally:
        (BX._run_chunk_sharded_ivf, BX._run_chunk_sharded, BX._sivf_fn,
         BX.execute_batch_sharded) = orig


def _clear(rec: dict) -> None:
    for v in rec.values():
        v.clear()


def fixed_batches(bx, queries, plans, rec: dict) -> tuple:
    """``queries`` through ``bx.execute_batch_sharded`` batch by batch
    after one warm-up batch (``rec`` cleared after it).
    -> (results, escalated query positions, seconds)."""
    from repro_torch.common.device import synchronize

    bx.execute_batch_sharded(queries[:BATCH], plans[:BATCH])
    bx.dispatcher.take()
    _clear(rec)
    synchronize(bx.table.device)
    t = time.perf_counter()
    results, escalated = [], []
    for b0 in range(0, len(queries), BATCH):
        bx.escalated.clear()
        results.extend(bx.execute_batch_sharded(queries[b0: b0 + BATCH],
                                                plans[b0: b0 + BATCH]))
        escalated.extend(b0 + j for j in bx.escalated)
    return results, escalated, time.perf_counter() - t


def _host_probes(probes) -> list:
    return [(f.cpu().numpy(), b.cpu().numpy()) for f, b in probes]


def fixed_plan_pass(bq, queries, gt, label: str, launches: dict, rec: dict,
                    *, force: str, **shards) -> tuple:
    """``queries`` through ``execute_batch_sharded`` of an executor over the
    instance's table and ``shards`` (``n_shards=`` logical shards or a
    ``mesh=``), every index group forced to ``force`` under ``fixed_plan``,
    batch by batch after one warm-up batch; ``rec`` is
    ``sharded_records``'. Every served id must be distinct, in range,
    satisfy its predicate and carry its row's plain score. Per-shard
    probing: every chunk must launch the fp32 kernel once per probed
    column plus once. The exact scan: every result the exact filtered
    top-k, ties aside. -> (report, dict(results, escalated, probes,
    sivf: the executor's per-shard indexes))."""
    from repro_torch.core.executor import recall_at_k
    from repro_torch.kernels import gather_score as gs
    from repro_torch.serve.batch import (
        SHARDED_LOCAL, BatchedHybridExecutor, CostModel,
    )

    bx = BatchedHybridExecutor(bq.table, bq.indexes, bq.engine,
                               hists=bq.hists, graphs=bq.graphs,
                               cost_model=CostModel(force=force), **shards)
    plans = [fixed_plan(q.n_vec, bq.engine) for q in queries]
    before = dict(gs.LAUNCHES)
    results, escalated, seconds = fixed_batches(bx, queries, plans, rec)
    lc = {k: gs.LAUNCHES[k] - before[k] for k in gs.LAUNCHES}
    for k in launches:
        launches[k] += lc[k]
    counts = bx.dispatcher.take()[0]
    _check_results(results, label)
    err = check_served(bq.table, queries, results, label)
    swaps = 0
    if force == SHARDED_LOCAL:
        if not rec["chunks"]:
            raise AssertionError(f"{label}: no per-shard probing chunk ran")
        check_shard_launches(rec["chunks"], label)
    else:
        swaps = check_exact(bq.table, queries, results, label)
    recall = float(np.mean([recall_at_k(ids, g)
                            for (ids, _), g in zip(results, gt)]))
    per_chunk = sorted({(c["cols"], c["fp32"]) for c in rec["chunks"]})
    out = dict(shards=bx.n_shards, mesh=bx.mesh is not None,
               route=f"fixed plan, forced {force}",
               qps=len(queries) / seconds, seconds=seconds,
               mean_recall=recall, path_counts=counts, launches=lc,
               probe_chunks=len(rec["chunks"]),
               probe_fp32_launches=sum(c["fp32"] for c in rec["chunks"]),
               launches_per_probe_chunk=per_chunk,
               escalated=len(escalated), exact_tie_swaps=swaps,
               max_abs_err=err)
    log(f"  serve[{label}]: {len(queries)} queries in {seconds:.2f}s "
        f"({out['qps']:.1f} QPS, mean recall {recall:.4f}), paths {counts}, "
        f"launches {lc}; {len(rec['chunks'])} probing chunks ((cols, fp32 "
        f"launches) {per_chunk}), {len(escalated)} escalated; max|err| "
        f"{err:.3g}")
    return out, dict(results=results, escalated=set(escalated),
                     probes=_host_probes(rec["probes"]), sivf=dict(bx._sivf))


def shard_pass(bq, queries, gt, label: str, launches: dict,
               rec: dict) -> tuple:
    """``queries`` through ``ServingEngine(batch_size=BATCH)`` on the
    instance's bound shard config after a warm-up (``rec`` cleared after
    it), with phase 10's checks: every served id distinct, in range,
    satisfying its predicate and carrying its row's plain score; every
    query on an exact route its exact filtered top-k, ties aside; every
    probing chunk launching the fp32 kernel once per probed column plus
    once. -> (results, the pass's report)."""
    from repro_torch.kernels import gather_score as gs
    from repro_torch.serve.batch import ServingEngine

    before = dict(gs.LAUNCHES)
    engine = ServingEngine(bq, batch_size=BATCH)
    engine.warmup(queries)
    _clear(rec)
    results, rep = engine.serve(queries, gt_ids=gt)
    lc = {k: gs.LAUNCHES[k] - before[k] for k in gs.LAUNCHES}
    for k in launches:
        launches[k] += lc[k]
    _check_results(results, label)
    err = check_served(bq.table, queries, results, label)
    exact = [j for j, q in enumerate(queries) if id(q) in rec["exact"]]
    swaps = check_exact(bq.table, [queries[j] for j in exact],
                        [results[j] for j in exact], label)
    chunks = rec["chunks"]
    check_shard_launches(chunks, label)
    per_chunk = sorted({(c["cols"], c["fp32"]) for c in chunks})
    out = dict(qps=rep.qps, seconds=rep.seconds, mean_recall=rep.mean_recall,
               path_counts=rep.path_counts, launches=lc,
               probe_chunks=len(chunks),
               probe_fp32_launches=sum(c["fp32"] for c in chunks),
               launches_per_probe_chunk=per_chunk,
               escalated=sum(c["escalated"] for c in chunks),
               exact_route_queries=len(exact), exact_tie_swaps=swaps,
               max_abs_err=err)
    log(f"  serve[{label}]: {rep.describe()}; launches {lc}; {len(chunks)} "
        f"probing chunks ((cols, fp32 launches) {per_chunk}), "
        f"{out['escalated']} escalated; {len(exact)} queries on the exact "
        f"route ({swaps} tie swaps); max|err| {err:.3g}")
    return results, out


SHARD_ROUTES = ("default", "sharded_local", "dense", "single_device")


def shard_cost_model(route: str):
    """Phase 10's cost model of a route: the default one, or every group
    forced (``candidate_local`` routes index groups ``sharded_local``)."""
    from repro_torch.serve.batch import (
        CANDIDATE_LOCAL, DENSE, SINGLE_DEVICE, CostModel,
    )

    force = {"default": None, "sharded_local": CANDIDATE_LOCAL,
             "dense": DENSE, "single_device": SINGLE_DEVICE}[route]
    return None if force is None else CostModel(force=force)


def shard_phase(bq, queries, gt, unsharded, device) -> tuple:
    """Phase 10: the fitted instance bound to S ∈ ``SHARD_COUNTS`` logical
    shards, serving ``queries`` at batch ``BATCH`` under the default cost
    model and forced to per-shard probing, to the exact sharded scan and to
    no fan-out (``SHARD_ROUTES``), then the fixed-plan pass per S.
    ``unsharded``: phase 4's forced candidate-local (results, report).
    ``bind_shards()`` restores the instance. -> (the passes' report and
    launches, the fixed-plan passes' results by S for phase 11)."""
    from repro_torch.core.executor import recall_at_k
    from repro_torch.serve.batch import (
        CANDIDATE_LOCAL, SHARDED_LOCAL, BatchedHybridExecutor, CostModel,
    )
    from repro_torch.vectordb import distributed

    launches = {"fp32": 0, "int8": 0}
    out = dict(build_s={}, passes={}, launches=launches,
               unsharded_candidate_local_recall=unsharded[1].mean_recall)
    # the fixed plan on one device, candidate-local: the one-shard probing
    # pass must equal it wherever it did not escalate
    base_fixed = BatchedHybridExecutor(
        bq.table, bq.indexes, bq.engine, hists=bq.hists, graphs=bq.graphs,
        cost_model=CostModel(force=CANDIDATE_LOCAL)).execute_batch(
        queries, [fixed_plan(q.n_vec, bq.engine) for q in queries])
    base_recall = float(np.mean([recall_at_k(ids, g)
                                 for (ids, _), g in zip(base_fixed, gt)]))
    fixed = {}
    with sharded_records() as rec:
        try:
            for s in SHARD_COUNTS:
                if s > 1:
                    # the per-shard indexes the probing route builds on its
                    # first chunk, timed alone
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    for c, idx in enumerate(bq.indexes):
                        distributed.build_sharded_ivf(
                            bq.table.vectors[c], s,
                            n_clusters=idx.n_clusters, seed=c,
                            metric=bq.table.schema.metric)
                    torch.cuda.synchronize()
                    out["build_s"][s] = time.perf_counter() - t
                    log(f"  S={s}: ShardedIVFs of {bq.table.schema.n_vec} "
                        f"columns built in {out['build_s'][s]:.3f} s")
                for name in SHARD_ROUTES:
                    label = f"S={s} {name}"
                    bq.bind_shards(s).bind_cost_model(shard_cost_model(name))
                    results, p = shard_pass(bq, queries, gt, label, launches,
                                            rec)
                    if s == 1 and name == "sharded_local":
                        check_same_results(results, unsharded[0], label)
                    if s > 1 and name == "sharded_local" and \
                            p["launches"]["fp32"] <= 0:
                        raise AssertionError(f"{label}: the pass never "
                                             f"launched the fp32 kernel")
                    out["passes"][label] = dict(shards=s, route=name, **p)
                bq.bind_shards().bind_cost_model()
                label = f"S={s} fixed plan"
                p, fixed[s] = fixed_plan_pass(
                    bq, queries, gt, label, launches, rec,
                    force=SHARDED_LOCAL, n_shards=s)
                p["one_device_recall"] = base_recall
                if s == 1:
                    kept = [j for j in range(len(queries))
                            if j not in fixed[s]["escalated"]]
                    check_same_results([fixed[s]["results"][j] for j in kept],
                                       [base_fixed[j] for j in kept], label)
                out["passes"][label] = p
        finally:
            bq.bind_shards().bind_cost_model()
    return out, fixed


def shard_profiles(bq, queries, passes: dict) -> None:
    """One profiled batch per phase-10 configuration (S, route), each after
    one warm batch; into its pass's ``batch_wall_ms`` /
    ``batch_device_ms``. Phase 6 runs it: once ``torch.profiler`` has run,
    host-bound serving in the process reads slower."""
    try:
        for s in SHARD_COUNTS:
            for name in SHARD_ROUTES:
                bq.bind_shards(s).bind_cost_model(shard_cost_model(name))
                bq.execute_batch(queries[:BATCH])
                log(f"  profile S={s} {name}:")
                prof = profile_batch(
                    lambda: bq.execute_batch(queries[:BATCH]), top=0)
                passes[f"S={s} {name}"].update(
                    batch_wall_ms=prof["wall_ms"],
                    batch_device_ms=prof["device_ms"])
    finally:
        bq.bind_shards().bind_cost_model()


# ---------------------------------------------------------------------------
# phase 11: the mesh (torch.distributed)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def process_group(backend: str, store: str, *, rank: int = 0,
                  world: int = 1):
    """A ``torch.distributed`` world over a ``file://`` store, with a finite
    timeout (a rank that diverges fails instead of hanging), destroyed on
    exit."""
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        yield
    finally:
        dist.destroy_process_group()


def check_mesh_pass(got: dict, want: dict, label: str, *,
                    atol: float = MESH_ATOL) -> None:
    """A mesh pass equals the logical shards' pass: every query's ids equal
    and scores within ``atol``, the same escalated queries, and every
    probing search's gathered per-shard ``fill`` equal and ``boundary``
    within ``atol``: the shards came in shard order with global ids."""
    if len(got["results"]) != len(want["results"]):
        raise AssertionError(f"{label}: {len(got['results'])} results, "
                             f"{len(want['results'])} expected")
    for j, ((gi, gs_), (wi, ws)) in enumerate(zip(got["results"],
                                                   want["results"])):
        if not np.array_equal(gi, wi):
            raise AssertionError(f"{label}: query {j}'s ids differ from the "
                                 f"logical shards'")
        if not np.allclose(gs_, ws, atol=atol, rtol=0):
            raise AssertionError(f"{label}: query {j}'s scores differ from "
                                 f"the logical shards' beyond {atol}")
    if set(got["escalated"]) != set(want["escalated"]):
        raise AssertionError(f"{label}: escalated {sorted(got['escalated'])},"
                             f" the logical shards {sorted(want['escalated'])}")
    if len(got["probes"]) != len(want["probes"]):
        raise AssertionError(f"{label}: {len(got['probes'])} probing "
                             f"searches, {len(want['probes'])} expected")
    for (gf, gb), (wf, wb) in zip(got["probes"], want["probes"]):
        # host arrays only: np.array_equal reads a CUDA tensor as unequal
        gf, gb, wf, wb = (np.asarray(x) for x in (gf, gb, wf, wb))
        if not np.array_equal(gf, wf):
            raise AssertionError(f"{label}: a probing search's per-shard "
                                 f"fill differs (shard order)")
        if not np.allclose(gb, wb, atol=atol, rtol=0):
            raise AssertionError(f"{label}: a probing search's per-shard "
                                 f"boundary differs")


def replay_logical(bq, calls: list, cost_model, rec: dict) -> list:
    """Each captured ``execute_batch_sharded`` call again on the logical
    one-shard executor with the same cost model, plans and dense matrices.
    -> one dict(results, escalated, probes) per call."""
    from repro_torch.serve.batch import BatchedHybridExecutor

    lx = BatchedHybridExecutor(bq.table, bq.indexes, bq.engine, n_shards=1,
                               hists=bq.hists, graphs=bq.graphs,
                               cost_model=cost_model)
    out = []
    for c in calls:
        p0 = len(rec["probes"])
        lx.escalated.clear()
        res = lx.execute_batch_sharded(c["queries"], c["plans"],
                                       scores_b=c["scores_b"])
        out.append(dict(results=res, escalated=set(lx.escalated),
                        probes=_host_probes(rec["probes"][p0:])))
    return out


def mesh_one_rank(bq, queries, gt, fixed1: dict, launches: dict) -> dict:
    """Phase 11 (a): a one-rank NCCL mesh in this process.
    ``bind_shards(mesh=)`` serves ``queries`` through ``ServingEngine`` under
    the default cost model, forced per-shard probing and forced dense, each
    pass with phase 10's checks, and every ``execute_batch_sharded`` call of
    it must equal the logical one-shard executor's on the same plans and
    dense matrices: the probing route's queries bit for bit, with the same
    escalated queries and probes; the exact route's ties aside. Then the
    fixed-plan pass on a mesh executor, bit for bit phase 10's S=1 one
    (``fixed1``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.serve.batch import SHARDED_LOCAL

    out = {}
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as d, \
            process_group("nccl", f"{d}/store"), sharded_records() as rec:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        try:
            for name in SHARD_ROUTES[:3]:
                label = f"mesh 1 rank {name}"
                cm = shard_cost_model(name)
                bq.bind_shards(mesh=mesh).bind_cost_model(cm)
                if bq._batched_executor().mesh is not mesh:
                    raise AssertionError(f"{label}: no mesh executor")
                results, p = shard_pass(bq, queries, gt, label, launches, rec)
                calls = list(rec["calls"])
                exact = set(rec["exact"])
                swaps = 0
                for c, want in zip(calls, replay_logical(bq, calls, cm, rec)):
                    routed = [id(q) in exact for q in c["queries"]]
                    pick = [j for j, e in enumerate(routed) if not e]
                    check_mesh_pass(
                        dict(c, results=[c["results"][j] for j in pick],
                             probes=_host_probes(c["probes"])),
                        dict(want, results=[want["results"][j]
                                            for j in pick]),
                        label, atol=0.0)
                    tied = [j for j, e in enumerate(routed) if e]
                    swaps += check_tied(
                        bq.table, [c["queries"][j] for j in tied],
                        [c["results"][j] for j in tied],
                        [want["results"][j] for j in tied], label)
                p.update(mesh_calls=len(calls), mesh_vs_logical_tie_swaps=swaps)
                out[label] = p
                log(f"  {label}: {len(calls)} execute_batch_sharded calls "
                    f"equal the logical one-shard executor's ({swaps} tie "
                    f"swaps on the exact route)")
            bq.bind_shards().bind_cost_model()
            label = "mesh 1 rank fixed plan"
            p, got = fixed_plan_pass(bq, queries, gt, label, launches, rec,
                                     force=SHARDED_LOCAL, mesh=mesh)
            check_mesh_pass(got, fixed1, label, atol=0.0)
            out[label] = p
        finally:
            bq.bind_shards().bind_cost_model()
    return out


def _on(q, device):
    """An MHQ with its tensors on ``device``."""
    p = q.predicates
    return dataclasses.replace(
        q, query_vectors=tuple(v.to(device) for v in q.query_vectors),
        predicates=dataclasses.replace(p, **{
            f.name: getattr(p, f.name).to(device)
            for f in dataclasses.fields(p)}))


def mesh_rank(rank: int, store: str, payload: dict, out_path: str) -> None:
    """One rank of phase 11 (b), in its own process on the shared card.
    The rank's table holds its own rows and NaN in every other row, so a
    sharded route that read another rank's rows would fail. It runs the
    fixed-plan pass (per-shard probing, its shard of phase 10's S=4
    indexes) and the same plans forced dense through
    ``BatchedHybridExecutor(mesh=)``, and saves the results, escalated
    queries, probes, chunks, launches and seconds of each."""
    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import gather_score as gs
    from repro_torch.serve.batch import (
        DENSE, SHARDED_LOCAL, BatchedHybridExecutor, CostModel,
    )
    from repro_torch.vectordb.distributed import shard_rows
    from repro_torch.vectordb.table import Table

    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    r0, r1 = payload["rows"]

    def table_shaped(own):
        x = torch.full((payload["n_rows"],) + tuple(own.shape[1:]),
                       float("nan"), device=dev)
        x[r0:r1] = own
        return x

    table = Table(payload["schema"],
                  [table_shaped(v) for v in payload["vectors"]],
                  table_shaped(payload["scalars"]))
    queries = [_on(q, dev) for q in payload["queries"]]
    plans = payload["plans"]
    out = {}
    with process_group("gloo", store, rank=rank, world=MESH_RANKS), \
            sharded_records() as rec:
        mesh = init_device_mesh("cpu", (MESH_RANKS,),
                                mesh_dim_names=("data",))
        if (r0, r1) != shard_rows(payload["n_rows"], mesh):
            raise AssertionError(f"rank {rank}: rows {(r0, r1)} are not its "
                                 f"shard's")
        for name, force in (("fixed", SHARDED_LOCAL), ("dense", DENSE)):
            bx = BatchedHybridExecutor(table, payload["indexes"],
                                       payload["engine"], mesh=mesh,
                                       cost_model=CostModel(force=force))
            bx._sivf.update(payload["sivf"])
            before = dict(gs.LAUNCHES)
            results, escalated, seconds = fixed_batches(bx, queries, plans,
                                                        rec)
            out[name] = dict(
                results=[(np.asarray(i), np.asarray(s)) for i, s in results],
                escalated=set(escalated), probes=_host_probes(rec["probes"]),
                chunks=list(rec["chunks"]), seconds=seconds,
                launches={k: gs.LAUNCHES[k] - before[k] for k in gs.LAUNCHES})
    torch.save(out, out_path)


def mesh_four_ranks(bq, queries, gt, fixed4: dict, launches: dict) -> dict:
    """Phase 11 (b): ``MESH_RANKS`` gloo ranks in their own processes on the
    one card (a check of correctness: gloo moves the gathered candidates
    through host memory, and four ranks share one card). Each rank gets
    only its rows and its shard of phase 10's S=4 indexes (``fixed4``'s
    executor's) and runs ``mesh_rank``. Every rank's fixed-plan pass must
    equal phase 10's logical S=4 fixed-plan pass, and its dense pass the
    logical S=4 executor's on the same plans (run here): ids equal, scores
    within ``MESH_ATOL``, the same escalated queries and probes in shard
    order. Every rank must launch the fp32 kernel on its probing chunks,
    once per probed column plus once a chunk."""
    from repro_torch.serve.batch import DENSE
    from repro_torch.vectordb import distributed

    with sharded_records() as rec:
        p_dense, dense4 = fixed_plan_pass(
            bq, queries, gt, "S=4 fixed plan, forced dense", launches, rec,
            force=DENSE, n_shards=MESH_RANKS)
    t = bq.table
    per = t.n_rows // MESH_RANKS
    ctx = torch.multiprocessing.get_context("spawn")
    report = dict(logical_dense=p_dense, ranks={})
    with tempfile.TemporaryDirectory() as d:
        procs = []
        for r in range(MESH_RANKS):
            rows = slice(r * per, (r + 1) * per)
            payload = dict(
                rows=(rows.start, rows.stop), n_rows=t.n_rows,
                schema=t.schema,
                vectors=[v[rows].clone() for v in t.vectors],
                scalars=t.scalars[rows].clone(), indexes=list(bq.indexes),
                engine=bq.engine,
                sivf={c: distributed.ShardedIVF(
                    *(x.clone() for x in (s.centroids[r: r + 1],
                                          s.sorted_rows[r: r + 1],
                                          s.offsets[r: r + 1])), s.metric)
                      for c, s in fixed4["sivf"].items()},
                queries=[_on(q, "cpu") for q in queries],
                plans=[fixed_plan(q.n_vec, bq.engine) for q in queries])
            procs.append(ctx.Process(target=mesh_rank, args=(
                r, f"{d}/store", payload, f"{d}/rank{r}.pt")))
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=3 * MESH_TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
        wall = time.perf_counter() - t0
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise AssertionError(f"phase 11 (b): rank exit codes {codes}")
        got = [torch.load(f"{d}/rank{r}.pt", weights_only=False)
               for r in range(MESH_RANKS)]
    for r, g in enumerate(got):
        for name, want in (("fixed", fixed4), ("dense", dense4)):
            label = f"mesh {MESH_RANKS} ranks, rank {r}, {name}"
            check_mesh_pass(g[name], want, label)
        check_shard_launches(g["fixed"]["chunks"], f"rank {r}")
        if g["fixed"]["launches"]["fp32"] <= 0:
            raise AssertionError(f"rank {r} never launched the fp32 kernel")
        report["ranks"][r] = {name: dict(
            qps=len(queries) / g[name]["seconds"],
            seconds=g[name]["seconds"], launches=g[name]["launches"],
            escalated=len(g[name]["escalated"]),
            probe_chunks=len(g[name]["chunks"])) for name in g}
        for k in launches:
            launches[k] += sum(g[name]["launches"][k] for name in g)
    check_served(t, queries, got[0]["fixed"]["results"], "mesh 4 ranks")
    report["wall_s"] = wall
    log(f"  mesh {MESH_RANKS} gloo ranks on one card: {wall:.1f} s with "
        f"their start; every rank equals the logical S=4 passes; "
        + "; ".join(f"rank {r} fixed {v['fixed']['qps']:.1f} / dense "
                    f"{v['dense']['qps']:.1f} QPS, launches "
                    f"{v['fixed']['launches']}"
                    for r, v in report["ranks"].items()))
    return report


FRONT_MAX_WAIT = 0.002  # phase 9 (a)'s engines'
FRONT_HELD = 128  # the held sessions' queries (the first of the 256)
# phase 11 (c)'s engine sessions: (name, stream, batch size, a semantic
# cache, requests one at a time (else all at once through serve_stream),
# the cost model's forced route (None: the default cost model))
FRONT_SESSIONS = (("warm-up", "pool", 8, False, True, None),
                  ("trace", "trace", 8, True, True, None),
                  ("held", "held", BATCH, True, False, None),
                  ("held, per-shard probing", "held", BATCH, True, False,
                   "sharded_local"))


def _pair(res) -> tuple:
    """(ids, scores) on the host."""
    return tuple(x.cpu().numpy() if isinstance(x, torch.Tensor)
                 else np.asarray(x) for x in res)


def front_binder(bq, sivf: dict, **shards):
    """-> ``bind(force)``: ``bq`` bound to ``shards`` (``n_shards=`` or
    ``mesh=``) under the default cost model (``force`` None) or
    ``CostModel(force=force)``, with the per-shard indexes ``sivf`` in its
    executor."""
    from repro_torch.serve.batch import CostModel

    def bind(force):
        bq.bind_shards(**shards).bind_cost_model(
            None if force is None else CostModel(force=force))
        bq._batched_executor()._sivf.update(sivf)

    return bind


def front_end_sessions(bq, streams: dict, bind) -> dict:
    """Phase 11 (c)'s ``FRONT_SESSIONS`` through ``AsyncServingEngine`` on
    ``bq`` (``max_wait`` 0.002 s), one engine a session, each after
    ``bind(its forced route)``. -> by session: each request (seq, status,
    cache hit, ids, scores) by seq (seq i is the stream's query i), each
    executed batch's seqs, QPS, p50/p99 ms, hits, timed-out count,
    batches and wall seconds."""
    from repro_torch.serve.queue import AsyncServingEngine, serve_stream
    from repro_torch.serve.semcache import SemanticCache

    async def one_by_one(eng, qs):
        async with eng:
            return [await eng.submit(q) for q in qs]

    out = {}
    for name, stream, batch, cache, seq, force in FRONT_SESSIONS:
        bind(force)
        eng = AsyncServingEngine(
            bq, batch_size=batch, max_wait=FRONT_MAX_WAIT,
            semcache=SemanticCache(eps=0.0) if cache else None)
        t = time.perf_counter()
        reqs = asyncio.run((one_by_one if seq else serve_stream)(
            eng, streams[stream]))
        wall = time.perf_counter() - t
        rep = eng.report()
        out[name] = dict(
            requests=[(r.seq, r.status, r.cache_hit, *_pair(r.result))
                      for r in reqs],
            batch_seqs=[list(b) for b in eng.batch_seqs], qps=rep.qps,
            p50_ms=rep.p50_ms, p99_ms=rep.p99_ms, hits=rep.n_cache_hits,
            timed_out=rep.n_timed_out, n_batches=rep.n_batches, wall_s=wall)
    return out


def mesh_front_rank(rank: int, store: str, payload: dict,
                    out_path: str) -> None:
    """One rank of phase 11 (c), in its own process on the shared card: the
    fitted instance (its tensors the parent's, through CUDA IPC) bound to
    a four-rank ``(data,)`` mesh, its shard of phase 10's S=4 indexes in
    the executor. The first rank runs ``front_end_sessions``; the others
    ``serve_follower`` once a session, bound alike first.
    Saves what each served, the gather launches (set to 0 just before the
    sessions, read just after), the plan broadcasts and the channel's
    messages."""
    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import gather_score as gs
    from repro_torch.serve.queue import serve_follower
    from repro_torch.vectordb import distributed

    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    bq = payload["bq"]
    plan_broadcasts = []
    broadcast = distributed.broadcast_from_first

    def counted(obj, mesh):
        plan_broadcasts.append(1)
        return broadcast(obj, mesh)

    distributed.broadcast_from_first = counted
    sent = []
    send = distributed.BatchChannel._broadcast

    def counted_send(self, msg):
        sent.append(msg is not None)
        return send(self, msg)

    distributed.BatchChannel._broadcast = counted_send
    out = {}
    with process_group("gloo", store, rank=rank, world=MESH_RANKS):
        mesh = init_device_mesh("cpu", (MESH_RANKS,),
                                mesh_dim_names=("data",))
        shard = distributed.mesh_shard(mesh)[1]
        bind = front_binder(bq, {c: s.shard(shard)
                                 for c, s in payload["sivf"].items()},
                            mesh=mesh)
        gs.reset_launches()
        t = time.perf_counter()
        if rank == 0:
            out["sessions"] = front_end_sessions(
                bq, {k: [_on(q, dev) for q in v]
                     for k, v in payload["streams"].items()}, bind)
        else:
            out["followed"] = []
            for *_, force in FRONT_SESSIONS:
                bind(force)
                served = serve_follower(bq)
                out["followed"].append(dict(
                    results=[None if res is None else [_pair(x) for x in res]
                             for res in served.results],
                    errors={b: repr(e) for b, e in served.errors.items()}))
        torch.cuda.synchronize()
        out.update(seconds=time.perf_counter() - t,
                   launches=dict(gs.LAUNCHES),
                   plan_broadcasts=len(plan_broadcasts),
                   channel_messages=sum(sent))
    torch.save(out, out_path)


def _replay_batches(bq, streams: dict, front: dict, bind,
                    rec: dict) -> dict:
    """Each batch the first rank executed, again through ``bq`` in this
    process after ``bind(its session's forced route)`` (logical shards),
    held to what the first rank served: ids equal and scores within
    ``MESH_ATOL``, where the replay ran a query on an exact route
    ``check_tied``'s rule. -> (batches, tie swaps)."""
    n, swaps = 0, 0
    for name, stream, *_, force in FRONT_SESSIONS:
        bind(force)
        reqs = {r[0]: r for r in front[name]["requests"]}
        for seqs in front[name]["batch_seqs"]:
            qs = [streams[stream][i] for i in seqs]
            _clear(rec)
            got = [_pair(x) for x in bq.execute_batch(qs)]
            want = [reqs[i][3:] for i in seqs]
            label = f"phase 11 (c) replay of {name} batch {seqs}"
            exact = [id(q) in rec["exact"] for q in qs]
            check_mesh_pass(
                dict(results=[w for w, e in zip(want, exact) if not e],
                     escalated=(), probes=()),
                dict(results=[g for g, e in zip(got, exact) if not e],
                     escalated=(), probes=()), label)
            swaps += check_tied(
                bq.table, [q for q, e in zip(qs, exact) if e],
                [w for w, e in zip(want, exact) if e],
                [g for g, e in zip(got, exact) if e], label)
            n += 1
    return dict(batches=n, exact_tie_swaps=swaps)


def _check_hits(session: dict, stream: list, label: str) -> None:
    """Every cache hit's result equals the result of the miss that filled
    it: the first request of the same query."""
    filled = {}
    for seq, status, hit, ids, scores in session["requests"]:
        if status != "ok":
            raise AssertionError(f"{label}: request {seq} {status}")
        key = id(stream[seq])
        if not hit:
            filled.setdefault(key, (ids, scores))
        elif key not in filled or not (
                np.array_equal(ids, filled[key][0])
                and np.array_equal(scores, filled[key][1])):
            raise AssertionError(f"{label}: hit {seq} is not its miss")


def mesh_front_end(bq, queries, fixed4: dict, launches: dict,
                   smi: str) -> dict:
    """Phase 11 (c): the serving front end over ``MESH_RANKS`` gloo ranks on
    the one card. Every rank holds phase 4's fitted instance (the parent's
    tensors, shared through CUDA IPC) and its shard of phase 10's S=4
    indexes, on a four-rank mesh; the first rank serves
    ``front_end_sessions`` (under the default cost model the pool once as
    a warm-up, phase 9 (a)'s ``semcache_draws`` trace over a pool from
    this instance one request at a time, then the first ``FRONT_HELD``
    of ``queries`` at once with batch 32; those once more with every
    index group forced to
    per-shard probing, since at this size the default routes every group
    to the exact sharded scan, which launches no gather; all but the
    warm-up with ``SemanticCache(eps=0)``) and the others
    ``serve_follower``. Fails unless every rank exits 0; every follower
    ran as many batches as the first rank, each equal bit for bit; each of
    the first rank's batches replayed here through the instance bound to
    logical ``bind_shards(4)`` (the same indexes and cost model) gives the
    same ids and scores within ``MESH_ATOL`` (exact-route ties by
    ``check_tied``); every hit equals its miss; the hits equal the
    one-process engine's on the same sessions over logical S=4;
    ``check_served`` holds for the first rank's results; every rank
    launched the fp32 gather kernel (the ranks' launches add to
    ``launches``)."""
    from repro_torch.bench import queries as qgen

    _, trace, _ = semcache_draws(bq.table.n_rows)
    pool = qgen.gen_workload(bq.table, CACHE_UNIQUE, n_vec_used=2, k=10,
                             seed=100)
    streams = {"pool": pool, "trace": [pool[i] for i in trace],
               "held": list(queries[:FRONT_HELD])}
    bq.bind_shards()  # no executor travels with the instance
    payload = dict(bq=bq, sivf=fixed4["sivf"],
                   streams={k: [_on(q, "cpu") for q in v]
                            for k, v in streams.items()})
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=mesh_front_rank, args=(
            r, f"{d}/store", payload, f"{d}/rank{r}.pt"))
            for r in range(MESH_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=3 * MESH_TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
        wall = time.perf_counter() - t0
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise AssertionError(f"phase 11 (c): rank exit codes {codes}")
        got = [torch.load(f"{d}/rank{r}.pt", weights_only=False)
               for r in range(MESH_RANKS)]
    front = got[0]["sessions"]
    n_batches = sum(front[n]["n_batches"] for n, *_ in FRONT_SESSIONS)
    for r, g in enumerate(got):
        if g["launches"]["fp32"] <= 0:
            raise AssertionError(f"phase 11 (c): rank {r} never launched "
                                 f"the fp32 kernel")
        for k in launches:
            launches[k] += g["launches"][k]
        if r == 0:
            continue
        for (name, *_), followed in zip(FRONT_SESSIONS, g["followed"]):
            label = f"phase 11 (c) rank {r} {name}"
            reqs = {q[0]: q for q in front[name]["requests"]}
            if followed["errors"] or len(followed["results"]) != \
                    len(front[name]["batch_seqs"]):
                raise AssertionError(
                    f"{label}: {len(followed['results'])} batches, errors "
                    f"{followed['errors']}; the first rank ran "
                    f"{len(front[name]['batch_seqs'])}")
            for seqs, res in zip(front[name]["batch_seqs"],
                                 followed["results"]):
                check_same_results(res, [reqs[i][3:] for i in seqs], label)
    for name, stream, *_ in FRONT_SESSIONS:
        label = f"phase 11 (c) {name}"
        _check_hits(front[name], streams[stream], label)
        check_served(bq.table, streams[stream],
                     [q[3:] for q in front[name]["requests"]], label)
    # the same sessions through the one-process engine over logical S=4,
    # then every batch of the first rank replayed on it
    bind = front_binder(bq, fixed4["sivf"], n_shards=MESH_RANKS)
    try:
        one = front_end_sessions(bq, streams, bind)
        with sharded_records() as rec:
            replay = _replay_batches(bq, streams, front, bind, rec)
    finally:
        bq.bind_shards().bind_cost_model()
    if one["trace"]["hits"] != front["trace"]["hits"]:
        raise AssertionError(f"phase 11 (c): {front['trace']['hits']} hits "
                             f"on the mesh, {one['trace']['hits']} in one "
                             f"process")
    rows = {}
    for who, sessions in (("mesh", front), ("one process", one)):
        for name, *_ in FRONT_SESSIONS[1:]:
            x = sessions[name]
            rows[f"{who} {name}"] = {k: x[k] for k in (
                "qps", "p50_ms", "p99_ms", "hits", "timed_out", "n_batches",
                "wall_s")}
            log(f"  front end [{who}, {name}, {smi}]: {x['qps']:.1f} QPS, "
                f"p50 {x['p50_ms']:.2f} / p99 {x['p99_ms']:.2f} ms, "
                f"{x['hits']} hits, {x['timed_out']} timed out, "
                f"{x['n_batches']} batches, {x['wall_s']:.2f} s")
    first = got[0]
    out = dict(
        sessions=rows, wall_s=wall, batches=n_batches, replay=replay,
        rank_seconds=[g["seconds"] for g in got],
        rank_launches=[g["launches"] for g in got],
        channel_messages_per_batch=first["channel_messages"] / n_batches,
        plan_broadcasts_per_batch=first["plan_broadcasts"] / n_batches)
    log(f"  front end over {MESH_RANKS} gloo ranks on one card: {wall:.1f} s "
        f"with their start; {n_batches} batches on every rank, each "
        f"follower equal to the first rank; {replay['batches']} batches "
        f"replayed on logical S=4 ({replay['exact_tie_swaps']} exact-route "
        f"tie swaps); broadcasts a batch: "
        f"{out['channel_messages_per_batch']:.2f} on the batch channel "
        f"(the batch, and one stop a session), "
        f"{out['plan_broadcasts_per_batch']:.2f} of plans; launches by rank "
        f"{out['rank_launches']}")
    return out


def mesh_phase(bq, queries, gt, fixed: dict, smi: str) -> dict:
    """Phase 11: (a) a one-rank NCCL mesh in this process, (b) four gloo
    ranks on the one card, (c) the serving front end over four gloo ranks.
    -> the report and its gather launches."""
    launches = {"fp32": 0, "int8": 0}
    one = mesh_one_rank(bq, queries, gt, fixed[1], launches)
    four = mesh_four_ranks(bq, queries, gt, fixed[MESH_RANKS], launches)
    front = mesh_front_end(bq, queries, fixed[MESH_RANKS], launches, smi)
    return dict(one_rank=one, four_ranks=four, front_end=front,
                launches=launches)


# ---------------------------------------------------------------------------
# phase 11 (d): tiered ingest over the mesh (run inside phase 9)
# ---------------------------------------------------------------------------

def compaction_records(bq, times: dict) -> list:
    """Wrap ``bq.tiered.compact`` (the instance's: the scheduler and an
    inline compaction both call it) so that each compaction that ran
    appends one record: its epoch, rows ``[a, b)``, seconds by step (timed
    on the compacting thread to the end of their device work, as phase 9
    (b) times them; ``times`` holds the step patches' thread-local), the
    wall-clock instant it published and the cold-state digest of the epoch
    it published. -> the record list."""
    from repro_torch.vectordb.tiered import cold_digest

    records, inner = [], bq.tiered.compact

    def recorded():
        times["local"].secs = secs = {}
        try:
            out = inner()
        finally:
            times["local"].secs = None
        if out["compacted"]:
            published = time.time()
            cold = bq.tiered.snapshot().cold
            records.append(dict(
                epoch=out["epoch"], a=cold.table.n_rows - out["compacted"],
                b=cold.table.n_rows, seconds=out["seconds"],
                seconds_by_step=secs, published=published,
                digest=cold_digest(cold)))
        return out

    bq.tiered.compact = recorded
    return records


@contextlib.contextmanager
def compaction_steps(bq):
    """Time the compaction steps (append, IVF, histograms, graphs, the
    encoder and the rest of ``_on_compaction``) on the thread
    ``compaction_records`` marks. -> the shared dict it reads."""
    from repro_torch.core.data_encoder import DataEncoder
    from repro_torch.vectordb import graph as graphmod
    from repro_torch.vectordb import histogram, ivf
    from repro_torch.vectordb.table import Table

    times = {"local": threading.local()}
    patches = [(Table, "append", "append"), (ivf, "extend", "ivf"),
               (ivf, "build", "ivf"), (histogram, "update", "histograms"),
               (graphmod, "extend", "graphs"),
               (DataEncoder, "update", "encoder")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]

    def timed(fn, step):
        def wrapper(*a, **kw):
            secs = getattr(times["local"], "secs", None)
            if secs is None:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            secs[step] = secs.get(step, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    for (obj, attr, step), (_, _, fn) in zip(patches, saved):
        setattr(obj, attr, timed(fn, step))
    try:
        yield times
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)


def counted_hot_views() -> dict:
    """Count, from here on in this process, the hot views scored and the
    fp32 gather launches they took (``tiered._hot_topk``)."""
    from repro_torch.kernels import gather_score as gs
    from repro_torch.vectordb import tiered

    hot, inner = {"calls": 0, "fp32": 0}, tiered._hot_topk

    def counted(*a, **kw):
        before = gs.LAUNCHES["fp32"]
        out = inner(*a, **kw)
        hot["calls"] += 1
        hot["fp32"] += gs.LAUNCHES["fp32"] - before
        return out

    tiered._hot_topk = counted
    return hot


def stream_request(stream_wl, i: int):
    """Request ``i`` of phase 9 (b)'s tenanted stream."""
    return dataclasses.replace(stream_wl[i % len(stream_wl)],
                               tenant_id=i % TENANTS, recall_target=0.9)


def tiered_stream(bq, stream_wl, chunks, lam: float, record) -> tuple:
    """Phase 9 (b)'s stream on ``bq`` through one ``AsyncServingEngine``
    session (batch 16, ``max_wait`` 0.02 s): request ``i`` of the stream
    at seed ``UPDATE_SEED + 17``'s Poisson gaps of rate ``lam`` while the
    ``chunks`` go in through ``bq.insert``, until the ingest has ended and
    nothing compacts, then ``MIXED_TAIL`` more. ``record(eng, reqs)``
    reads the session after ``stop``. -> (requests, wall seconds of the
    stream)."""
    from repro_torch.serve.queue import AsyncServingEngine

    arrivals = np.random.default_rng(UPDATE_SEED + 17)
    eng = AsyncServingEngine(bq, batch_size=MIXED_BATCH, max_wait=MIXED_WAIT,
                             clock=time.perf_counter)

    def compacting():
        c = eng._compactor
        return bq.tiered.needs_compaction() or (
            c is not None and c._inflight is not None
            and not c._inflight.done())

    async def drive():
        loop = asyncio.get_running_loop()

        async def ingest():
            for vecs, scal in chunks:
                await loop.run_in_executor(None, bq.insert, vecs, scal)
                await asyncio.sleep(MIXED_REQUESTS / lam / MIXED_CHUNKS / 2)

        async with eng:
            t0 = time.perf_counter()
            ing = asyncio.ensure_future(ingest())
            tasks, end = [], MIXED_MAX
            for i in range(MIXED_MAX):
                if i >= end:
                    break
                if i > 0:
                    await asyncio.sleep(arrivals.exponential(1.0 / lam))
                tasks.append(asyncio.ensure_future(eng.submit(
                    stream_request(stream_wl, i))))
                if end == MIXED_MAX and ing.done() and not compacting():
                    end = max(MIXED_REQUESTS, i + 1 + MIXED_TAIL)
            reqs = await asyncio.gather(*tasks)
            wall = time.perf_counter() - t0
            await ing
        return reqs, wall

    reqs, wall = asyncio.run(drive())
    record(eng, reqs)
    return reqs, wall


def _latency(reqs, wall: float) -> dict:
    lats = np.asarray([r.latency for r in reqs if r.status == "ok"])
    return dict(requests=len(reqs), qps=len(lats) / wall,
                p50_ms=float(np.percentile(lats, 50) * 1e3),
                p99_ms=float(np.percentile(lats, 99) * 1e3))


def _batch_log(eng, reqs: list, index=lambda seq: seq) -> list:
    """Each batch an engine executed: its requests' indices into the
    stream (``index(seq)``), its snapshot's stamp and hot-view layout, and
    each request's status and (ids, scores)."""
    by_seq = {r.seq: r for r in reqs}
    out = []
    for seqs in eng.batch_seqs:
        snap = by_seq[seqs[0]].snapshot
        out.append(dict(
            seqs=[index(s) for s in seqs], stamp=snap.stamp,
            views=[(v.id_offset, v.count) for v in snap.hot_views],
            status=[by_seq[s].status for s in seqs],
            results=[_pair(by_seq[s].result) if by_seq[s].result is not None
                     else None for s in seqs]))
    return out


def mesh_tiered_front(bq, payload: dict, out: dict) -> None:
    """Phase 11 (d)'s first rank: a warm session (the stream's first
    ``MIXED_BATCH`` requests at once, twice: the second batch's wall time
    is the mesh's warm batch-16 time), then the stream at 60% of that rate
    while the ``chunks`` go in. Its channel's messages and pickled bytes
    are counted."""
    from repro_torch.serve.queue import AsyncServingEngine
    from repro_torch.vectordb import distributed

    dev = torch.device("cuda")
    stream_wl = [_on(q, dev) for q in payload["stream_wl"]]
    chunks = payload["chunks"]
    channel = {"messages": 0, "bytes": 0}
    send = distributed.BatchChannel._broadcast

    def counted_send(self, msg):
        channel["messages"] += 1
        channel["bytes"] += len(pickle.dumps(msg))
        return send(self, msg)

    distributed.BatchChannel._broadcast = counted_send
    eng = AsyncServingEngine(bq, batch_size=MIXED_BATCH, max_wait=1.0,
                             clock=time.perf_counter)

    async def warm():
        got = []
        async with eng:
            for _ in range(2):
                t = time.perf_counter()
                got += await asyncio.gather(*(
                    eng.submit(stream_request(stream_wl, i))
                    for i in range(MIXED_BATCH)))
                dt = time.perf_counter() - t
        return got, dt

    got, warm_s = asyncio.run(warm())
    out["warm"] = _batch_log(eng, got, lambda seq: seq % MIXED_BATCH)
    lam = MIXED_UTILIZATION * MIXED_BATCH / warm_s

    def record(eng_s, reqs):
        out["batches"] = _batch_log(eng_s, reqs)
        out["report"] = dict(n_batches=eng_s.report().n_batches,
                             epoch=eng_s.report().epoch,
                             n_compactions=eng_s.report().n_compactions)

    reqs, wall = tiered_stream(bq, stream_wl, chunks, lam, record)
    out.update(warm_batch_s=warm_s, lam=lam, stream=_latency(reqs, wall),
               channel=channel,
               requests=[(r.seq, r.status) for r in reqs])


def mesh_tiered_rank(rank: int, store: str, payload: dict,
                     out_path: str) -> None:
    """One rank of phase 11 (d), in its own process on the shared card:
    phase 9's fitted tenant instance (its tensors the parent's, through
    CUDA IPC) bound to a four-rank ``(data,)`` mesh and
    ``bind_tiered(hot_capacity=2048)``. The first rank runs
    ``mesh_tiered_front`` (two engine sessions); the others
    ``serve_follower`` twice. Saves what each served and on which stamps,
    its compactions (epoch, rows, steps, publish instant, digest), the
    gather launches (set to 0 just before the sessions, read just after),
    the hot views scored, its final stamp and its peak device memory."""
    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import gather_score as gs
    from repro_torch.serve.queue import serve_follower

    torch.cuda.set_device(0)
    bq = payload["bq"]
    hot = counted_hot_views()
    out = {}
    with process_group("gloo", store, rank=rank, world=MESH_RANKS), \
            compaction_steps(bq) as times:
        mesh = init_device_mesh("cpu", (MESH_RANKS,),
                                mesh_dim_names=("data",))
        bq.bind_shards(mesh=mesh).bind_tiered(HOT_CAPACITY)
        records = compaction_records(bq, times)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gs.reset_launches()
        t = time.perf_counter()
        if rank == 0:
            mesh_tiered_front(bq, payload, out)
        else:
            out["followed"] = []
            for _ in range(2):  # the warm session, the stream
                served = serve_follower(bq)
                out["followed"].append(dict(
                    results=[None if res is None else [_pair(x) for x in res]
                             for res in served.results],
                    errors={b: repr(e) for b, e in served.errors.items()},
                    stamps=list(served.stamps), final=served.final.stamp))
        torch.cuda.synchronize()
        out.update(seconds=time.perf_counter() - t,
                   launches=dict(gs.LAUNCHES), hot=dict(hot),
                   compactions=records, final=bq.tiered.snapshot().stamp,
                   peak_allocated=torch.cuda.max_memory_allocated(),
                   peak_reserved=torch.cuda.max_memory_reserved())
    torch.save(out, out_path)


def check_tiered_followers(front: dict, followed: list, label: str) -> int:
    """Every follower ran the first rank's batches of both sessions, in
    order, each on the stamp the first rank cut it on, with results equal
    bit for bit, and ended on the first rank's final stamp. ``front``:
    the first rank's ``warm`` and ``batches`` logs and its ``final``
    stamp; ``followed``: a follower's two sessions. -> batches."""
    want = front["warm"] + front["batches"]
    got_res = [b for s in followed for b in s["results"]]
    got_st = [tuple(x) for s in followed for x in s["stamps"]]
    errors = [s["errors"] for s in followed if s["errors"]]
    if errors or len(got_res) != len(want) or len(got_st) != len(want):
        raise AssertionError(f"{label}: {len(got_res)} batches on "
                             f"{len(got_st)} stamps, errors {errors}; the "
                             f"first rank ran {len(want)}")
    for j, (res, st, w) in enumerate(zip(got_res, got_st, want)):
        if st != tuple(w["stamp"]):
            raise AssertionError(f"{label}: batch {j} ran on the stamp {st},"
                                 f" the first rank cut it on {w['stamp']}")
        check_same_results(res, w["results"], f"{label} batch {j}")
    if tuple(followed[-1]["final"]) != tuple(front["final"]):
        raise AssertionError(f"{label}: ended on {followed[-1]['final']}, "
                             f"the first rank on {front['final']}")
    return len(want)


def check_digests(records: list, label: str) -> int:
    """Every rank published the same epochs, each on the same rows with an
    equal cold-state digest. ``records``: each rank's compaction records.
    -> epochs."""
    keys = [[(c["epoch"], c["a"], c["b"]) for c in r] for r in records]
    for r, k in enumerate(keys):
        if k != keys[0]:
            raise AssertionError(f"{label}: rank {r} published {k}, the "
                                 f"first rank {keys[0]}")
    for r, rec in enumerate(records):
        for c, c0 in zip(rec, records[0]):
            if c["digest"] != c0["digest"]:
                raise AssertionError(
                    f"{label}: rank {r}'s cold state at epoch {c['epoch']} "
                    f"differs from the first rank's (digest)")
    return len(keys[0])


def replay_snapshot(tiered, stamp, views, rows: tuple, first_row: int):
    """A tiered snapshot at ``stamp`` on ``tiered`` (which holds that
    epoch): its cold state and hot views of the global ``rows`` (host
    arrays from global row ``first_row``) laid out as ``views``."""
    from repro_torch.vectordb.tiered import HotView, TieredSnapshot

    if tiered.epoch != stamp[0]:
        raise AssertionError(f"replay at epoch {tiered.epoch}, stamp "
                             f"{stamp}")
    vecs, scal = rows
    hot = []
    for off, count in views:
        lo = off - first_row
        bufs = [np.zeros((HOT_CAPACITY, v.shape[1]), np.float32)
                for v in vecs]
        sbuf = np.zeros((HOT_CAPACITY, scal.shape[1]), np.float32)
        for b, v in zip(bufs, vecs):
            b[:count] = v[lo: lo + count]
        sbuf[:count] = scal[lo: lo + count]
        hot.append(HotView(tuple(bufs), sbuf, count, off,
                           tiered.snapshot().cold.table.device))
    snap = TieredSnapshot(epoch=stamp[0], cold=tiered.snapshot().cold,
                          hot_views=tuple(hot))
    if snap.stamp != tuple(stamp):
        raise AssertionError(f"replay snapshot {snap.stamp}, stamp {stamp}")
    return snap


def check_replayed(got, want, label: str) -> int:
    """A replayed batch against the mesh's: scores within ``MESH_ATOL``
    and ids equal, except between slots whose scores tie within it (the
    exact route's shard merge may order a tie differently). -> id swaps."""
    swaps = 0
    for j, ((gi, gs_), (wi, ws)) in enumerate(zip(got, want)):
        gi, gs_, wi, ws = (np.asarray(x) for x in (gi, gs_, wi, ws))
        if not np.allclose(gs_, ws, atol=MESH_ATOL, rtol=0):
            raise AssertionError(f"{label}: query {j}'s scores differ from "
                                 f"the mesh's beyond {MESH_ATOL}")
        for p in np.flatnonzero(gi != wi):
            near = np.abs(ws - ws[p]) <= MESH_ATOL
            if near.sum() < 2 and p != len(wi) - 1:
                raise AssertionError(f"{label}: query {j}'s id at slot {p} "
                                     f"differs from the mesh's, untied")
            swaps += 1
    return swaps


def check_hot_rows(snap, queries, results, label: str) -> int:
    """No result misses a hot row (global id at or past the snapshot's
    cold rows) that the exact top-k over the snapshot's cold ∪ hot rows
    holds, float ties aside (``missed_hot_rows``). ``queries`` resolved.
    -> hot rows in the oracle's top-k."""
    o_ids, o_s = snapshot_topk(snap, queries)
    first_hot = snap.cold.table.n_rows
    missed, ranked = [], 0
    for (ids, scores), oi, os_ in zip(results, o_ids, o_s):
        ranked += int(np.sum(oi >= first_hot))
        missed += missed_hot_rows(ids, scores, oi, os_, first_hot)
    if missed:
        raise AssertionError(f"{label}: served results miss {len(missed)} "
                             f"hot rows their snapshot's oracle ranks in "
                             f"the top-k: {missed[:8]}")
    return ranked


def replay_tiered(rep, stream_wl, log: list, compactions: list, rows: tuple,
                  first_row: int) -> dict:
    """Every batch of the mesh's first rank (``log``) again through ``rep``
    (tiered over logical ``bind_shards(4)``) on a snapshot at its stamp,
    each compaction driven where the first rank's ran (the logged rows
    inserted, then ``tiered.compact()``), held to the mesh's results
    (``check_replayed``) and to the snapshot's cold ∪ hot oracle
    (``check_hot_rows``). -> counts."""
    vecs, scal = rows
    have, swaps, ranked, batches, epochs = first_row, 0, 0, 0, set()
    for b in log:
        stamp = tuple(b["stamp"])
        while rep.tiered.epoch < stamp[0]:
            c = compactions[rep.tiered.epoch]
            if c["a"] != rep.tiered.snapshot().cold.table.n_rows:
                raise AssertionError(f"replay: compaction {c['epoch']} of "
                                     f"rows from {c['a']}")
            rep.tiered.insert([v[have - first_row: c["b"] - first_row]
                               for v in vecs],
                              scal[have - first_row: c["b"] - first_row])
            have = c["b"]
            out = rep.tiered.compact()
            if (out["epoch"], out["compacted"]) != \
                    (c["epoch"], c["b"] - c["a"]):
                raise AssertionError(f"replay: compaction {out}, logged "
                                     f"{c}")
        snap = replay_snapshot(rep.tiered, stamp, b["views"], rows, first_row)
        qs = [stream_request(stream_wl, s) for s in b["seqs"]]
        ok = [j for j, st in enumerate(b["status"]) if st == "ok"]
        qs = [qs[j] for j in ok]
        got = [_pair(x) for x in rep.execute_batch(qs, snapshot=snap)]
        want = [b["results"][j] for j in ok]
        label = f"phase 11 (d) replay of batch {batches}"
        swaps += check_replayed(got, want, label)
        ranked += check_hot_rows(snap, [rep.resolve_tenant(q) for q in qs],
                                 want, label)
        epochs.add(stamp[0])
        batches += 1
    return dict(batches=batches, tie_swaps=swaps, hot_rows_in_oracle=ranked,
                epochs=sorted(epochs))


def _tiered_copy(bq):
    """A serving copy of ``bq`` whose tiers, shards and caches are its own
    (the tensors are shared, and every update makes new ones)."""
    import collections

    rep = copy.copy(bq)
    rep._older_qencs = collections.deque(maxlen=2)
    rep._recent = collections.deque(maxlen=64)
    rep._digested = set()
    rep._batched = None
    return rep


def mesh_tiered(bq, stream_wl, device, smi: str) -> dict:
    """Phase 11 (d): phase 9 (b)'s tiered stream over ``MESH_RANKS`` gloo
    ranks on the one card. Each rank holds phase 9's fitted tenant
    instance ``bq`` (the parent's tensors, through CUDA IPC) on a
    four-rank mesh with ``bind_tiered(hot_capacity=2048)``; the first rank
    serves the stream through ``AsyncServingEngine`` at 60% of the mesh's
    own warm batch-16 rate while +20,000 ``tenant_skewed_insert`` rows go
    in (8 chunks) and compact in the background, the others
    ``serve_follower``. Fails unless every rank exits 0; every follower
    ran every batch on its stamp with results equal bit for bit and ended
    on the first rank's final stamp; every rank published the same epochs
    with equal digests; the stamps span two epochs or more; every rank
    scored the hot views with the fp32 kernel, as often as the others;
    every batch replayed here on logical ``bind_shards(4)`` at its stamp
    equals the mesh's and holds to its snapshot's oracle with no hot row
    missed. Then the same stream through one process over logical S=4 at
    the same rate, for its QPS and p50/p99."""
    n0 = bq.table.n_rows
    n_insert = int(ROWS * MIXED_INSERT_RATIO)
    per = -(-n_insert // MIXED_CHUNKS)
    host = dataclasses.replace(bq.table, vectors=[v.cpu() for v in
                                                  bq.table.vectors],
                               scalars=bq.table.scalars.cpu())
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        chunks = list(pool.map(
            lambda d: tenant_skewed_insert(host, min(per, n_insert - d),
                                           UPDATE_SEED + 31 + d),
            range(0, n_insert, per)))
    del host
    rows = ([np.concatenate([c[0][i] for c in chunks])
             for i in range(len(chunks[0][0]))],
            np.concatenate([c[1] for c in chunks]))
    bq.unbind_tiered().bind_shards()  # neither travels with the instance
    payloads = [dict(bq=bq)] * MESH_RANKS
    payloads[0] = dict(bq=bq, stream_wl=[_on(q, "cpu") for q in stream_wl],
                       chunks=chunks)  # the ingest is the first rank's
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=mesh_tiered_rank, args=(
            r, f"{d}/store", payloads[r], f"{d}/rank{r}.pt"))
            for r in range(MESH_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=6 * MESH_TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
        wall = time.perf_counter() - t0
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise AssertionError(f"phase 11 (d): rank exit codes {codes}")
        got = [torch.load(f"{d}/rank{r}.pt", weights_only=False)
               for r in range(MESH_RANKS)]
    front = got[0]
    n_batches = 0
    for r in range(1, MESH_RANKS):
        n_batches = check_tiered_followers(front, got[r]["followed"],
                                           f"phase 11 (d) rank {r}")
    n_epochs = check_digests([g["compactions"] for g in got], "phase 11 (d)")
    stamps = [tuple(b["stamp"]) for b in front["warm"] + front["batches"]]
    check_epochs_served([s[0] for s in stamps], front["final"][0],
                        "phase 11 (d)")
    hot = [g["hot"] for g in got]
    if hot[0]["fp32"] <= 0 or any(h != hot[0] for h in hot):
        raise AssertionError(f"phase 11 (d): hot views scored by rank "
                             f"{hot}: each rank must launch the fp32 kernel "
                             f"on them, as often as the others")
    if any(st != "ok" for _, st in front["requests"]):
        raise AssertionError("phase 11 (d): a request did not resolve ok")
    # every batch again in this process, on logical S=4, at its stamp
    rep = _tiered_copy(bq)
    rep.bind_tiered(HOT_CAPACITY).bind_shards(MESH_RANKS)
    t = time.perf_counter()
    replay = replay_tiered(rep, stream_wl, front["warm"] + front["batches"],
                           got[0]["compactions"], rows, n0)
    replay["seconds"] = time.perf_counter() - t
    del rep
    # the same stream through one process over logical S=4, same rate
    one = _tiered_copy(bq)
    one.bind_tiered(HOT_CAPACITY).bind_shards(MESH_RANKS)
    one_log = {}
    one_reqs, one_wall = tiered_stream(
        one, stream_wl, chunks, front["lam"],
        lambda eng, reqs: one_log.update(n_compactions=one.tiered.epoch))
    one_stats = _latency(one_reqs, one_wall)
    del one
    first = got[0]["compactions"]
    lag = {r: [c["published"] - c0["published"]
               for c, c0 in zip(got[r]["compactions"], first)]
           for r in range(1, MESH_RANKS)}
    steps = sorted({k for g in got for c in g["compactions"]
                    for k in c["seconds_by_step"]})
    out = dict(
        wall_s=wall, batches=n_batches, epochs=n_epochs, stamps=len(stamps),
        rank_seconds=[g["seconds"] for g in got],
        rank_launches=[g["launches"] for g in got], hot_views=hot,
        warm_batch_s=front["warm_batch_s"], lam=front["lam"],
        mesh=front["stream"], one_process=dict(
            one_stats, n_compactions=one_log["n_compactions"]),
        compaction_seconds_by_step={
            r: {k: float(np.mean([c["seconds_by_step"].get(k, 0.0)
                                  for c in g["compactions"]]))
                for k in steps}
            for r, g in enumerate(got)},
        compaction_seconds=[[c["seconds"] for c in g["compactions"]]
                            for g in got],
        publish_lag_s=lag,
        channel=dict(front["channel"],
                     bytes_per_batch=front["channel"]["bytes"] / n_batches,
                     messages_per_batch=front["channel"]["messages"]
                     / n_batches),
        peak_allocated=[g["peak_allocated"] for g in got],
        peak_reserved=[g["peak_reserved"] for g in got], replay=replay,
        final=front["final"],
        launches={k: sum(g["launches"][k] for g in got)
                  for k in got[0]["launches"]})
    log(f"  tiered over {MESH_RANKS} gloo ranks [{smi}]: {wall:.1f} s with "
        f"their start; {n_batches} batches on every rank on their stamps, "
        f"each follower equal to the first rank; {n_epochs} epochs, digests "
        f"equal; hot views scored {hot[0]['calls']}x, {hot[0]['fp32']} fp32 "
        f"launches a rank; replayed {replay['batches']} batches on logical "
        f"S=4 ({replay['tie_swaps']} tie swaps, "
        f"{replay['hot_rows_in_oracle']} oracle slots hot, none missed) in "
        f"{replay['seconds']:.1f} s")
    for who, x in (("mesh", out["mesh"]), ("one process S=4",
                                            out["one_process"])):
        log(f"  tiered stream [{who}, {smi}]: {x['requests']} requests, "
            f"{x['qps']:.1f} QPS, p50 {x['p50_ms']:.2f} / p99 "
            f"{x['p99_ms']:.2f} ms")
    log(f"  tiered over the mesh: warm batch of {MIXED_BATCH} "
        f"{front['warm_batch_s'] * 1e3:.1f} ms; compaction seconds by step "
        f"(mean, by rank) {out['compaction_seconds_by_step']}; followers' "
        f"publish lag (s, by epoch) "
        + "; ".join(f"rank {r} " + ", ".join(f"{x:.3f}" for x in v)
                    for r, v in lag.items())
        + f"; channel {out['channel']['messages_per_batch']:.3f} messages, "
        f"{out['channel']['bytes_per_batch']:.0f} bytes a batch "
        f"({front['channel']['bytes']} in all); peak allocated by rank "
        f"{[round(x / 2**30, 3) for x in out['peak_allocated']]} GiB")
    return out


# ---------------------------------------------------------------------------
# phase 12: the static checks (boomlint) on this build
# ---------------------------------------------------------------------------

def card_envelope():
    """``analysis.config.CardEnvelope`` with the limits this card reports
    (``torch.cuda.get_device_properties``) in place of the defaults.
    -> (envelope, the fields read from the card, the defaults kept)."""
    from repro_torch.analysis.config import CardEnvelope

    props = torch.cuda.get_device_properties(0)
    names = dict(smem_optin="shared_memory_per_block_optin",
                 smem_per_sm="shared_memory_per_multiprocessor",
                 regs_per_sm="regs_per_multiprocessor",
                 threads_per_sm="max_threads_per_multi_processor")
    own = {k: int(getattr(props, a)) for k, a in names.items()
           if getattr(props, a, None)}
    kept = sorted(set(names) - set(own))
    return dataclasses.replace(CardEnvelope(), **own), sorted(own), kept


def lint_phase() -> dict:
    """Phase 12 (a): boomlint over ``src/repro_torch`` with level 2, on the
    ptxas reports of this build and the card's own limits. Any finding
    beyond ``boomlint_torch.baseline.json`` fails. -> the kernels'
    resources, the serving functions' host reads and every finding,
    suppressed and baselined included (phase 12 (c) reads them)."""
    from repro_torch.analysis.config import LintConfig
    from repro_torch.analysis.runner import run_paths
    from repro_torch.analysis.suppressions import Baseline

    card, read, kept = card_envelope()
    log(f"phase 12 (a): boomlint with level 2; the limits "
        f"{dataclasses.asdict(card)}: {read} read from the card, "
        f"{kept or 'none'} left at CardEnvelope's defaults")
    res = run_paths(["src/repro_torch"], LintConfig(card=card))
    active = Baseline.load(ROOT / "boomlint_torch.baseline.json").filter(
        res["active"])
    if active:
        raise AssertionError("boomlint on the shipped tree: "
                             + "; ".join(f.render() for f in active))
    kernels = res["runtime"]["kernels"]
    for r in kernels:
        print(f"    {r['kernel']:40s} {r['registers']:3d} registers, "
              f"{r['smem_static']} B static smem, "
              f"{r['smem_dynamic_envelope']} B dynamic at the envelope "
              f"(at most {r['smem_dynamic_max']}), spills "
              f"{r['spill_stores']}/{r['spill_loads']} B, stack "
              f"{r['stack']} B, {r['threads']} threads, "
              f"{r['resident_ctas']} resident CTAs a SM")
    reads = {k: v["host_reads"] for k, v in
             res["runtime"]["functions"].items()}
    log(f"  host reads by function (CM001 fixture): {reads}; "
        f"{len(res['active'])} baselined, {len(res['suppressed'])} "
        f"suppressed, 0 new")
    return dict(card=dataclasses.asdict(card), card_fields_read=read,
                card_fields_default=kept, kernels=kernels,
                functions=res["runtime"]["functions"],
                findings=[f.to_dict() for f in
                          res["active"] + res["suppressed"]])


ENV_ROWS = 200_000  # the scans' n, and the gather table's rows
ENV_SLOTS = 8192  # the gather kernels' S at the envelope


def envelope_table(device):
    """A table at the declared envelope (``kernels/shapes.py``):
    ``MAX_VEC_COLS`` columns of ``MAX_COL_DIM``, ``MAX_SCALARS`` uniform
    scalars, ``ENV_ROWS`` rows, drawn on the card from a seed."""
    from repro_torch.kernels.shapes import (
        MAX_COL_DIM, MAX_SCALARS, MAX_VEC_COLS,
    )
    from repro_torch.vectordb.table import (
        ScalarCol, Table, TableSchema, VectorCol,
    )

    gen = torch.Generator(device=device).manual_seed(12)
    schema = TableSchema(
        tuple(VectorCol(f"v{i}", MAX_COL_DIM) for i in range(MAX_VEC_COLS)),
        tuple(ScalarCol(f"s{j}", "num") for j in range(MAX_SCALARS)))
    return Table(schema, [torch.randn((ENV_ROWS, MAX_COL_DIM), generator=gen,
                                      device=device)
                          for _ in range(MAX_VEC_COLS)],
                 torch.rand((ENV_ROWS, MAX_SCALARS), generator=gen,
                            device=device))


def envelope_phase(device) -> dict:
    """Phase 12 (b): each of the four kernels at the declared envelope, held
    to its plain version with phase 3's tolerance and tie rule and timed as
    phase 3 times: both gather kernels at B=32, S=8,192 random rows (the
    last 5% of each query's slots empty), every column weighted, a
    4-clause DNF over the 16 scalars, k=128; both scans over the 200,000
    rows of column 0 under a conjunction of all 16 columns (each its
    central 86.6%, ≈10% of the rows), k=128. -> rows and the launches."""
    from repro_torch.kernels import gather_score as gs
    from repro_torch.kernels import masked_topk as mt
    from repro_torch.kernels.shapes import (
        MAX_COL_DIM, MAX_SCALARS, MAX_TOPK, MAX_VEC_COLS,
    )
    from repro_torch.vectordb.predicates import Predicates

    table = envelope_table(device)
    scal_np = table.scalars.cpu().numpy()
    rng = np.random.default_rng(12)
    gen = torch.Generator(device=device).manual_seed(13)
    b = BATCH
    cand = torch.randint(0, ENV_ROWS, (b, ENV_SLOTS), generator=gen,
                         device=device, dtype=torch.int32)
    cand[:, -ENV_SLOTS // 20:] = -1
    qs = tuple(torch.randn((b, MAX_COL_DIM), generator=gen, device=device)
               for _ in range(MAX_VEC_COLS))
    w = torch.rand((b, MAX_VEC_COLS), generator=gen, device=device) + 0.2
    pred = _random_dnf(MAX_SCALARS, 4, b, scal_np, rng, device)
    quant = [table.quantized(i) for i in range(MAX_VEC_COLS)]
    label = (f"envelope S={ENV_SLOTS} {MAX_VEC_COLS}x{MAX_COL_DIM} "
             f"M={MAX_SCALARS} C=4 k={MAX_TOPK}")
    cases = [(label, "fp32", dict(cand=cand, vectors=tuple(table.vectors),
                                  qs=qs, w=w, pred=pred, k=MAX_TOPK,
                                  metric="dot", scales=None)),
             (label, "int8", dict(cand=cand,
                                  vectors=tuple(v for v, _ in quant), qs=qs,
                                  w=w, pred=pred, k=MAX_TOPK, metric="dot",
                                  scales=tuple(sc for _, sc in quant)))]
    before = dict(gs.LAUNCHES), dict(mt.LAUNCHES)
    log(f"phase 12 (b): the four kernels at the declared envelope")
    gather = check_kernels(table, cases, device)
    every = Predicates.from_conditions(MAX_SCALARS, {
        c: tuple(float(x) for x in np.quantile(scal_np[:, c],
                                               [0.067, 0.933]))
        for c in range(MAX_SCALARS)}, device=device)
    scans = check_scans(table, qs[0][0], device, preds=[every],
                        ks=(MAX_TOPK,), variants=("dot", "int8"))
    launches = {f"gather_score_{v}": gs.LAUNCHES[v] - before[0][v]
                for v in ("fp32", "int8")}
    launches["masked_topk_fp32"] = mt.LAUNCHES["fp32"] - before[1]["fp32"]
    launches["int8_scan"] = mt.LAUNCHES["int8"] - before[1]["int8"]
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched at the envelope")
    log(f"  envelope launches {launches}")
    return dict(gather=gather, scans=scans, launches=launches)


def _stmt_spans(tree) -> list:
    """(first, last) lines of every simple statement and of every compound
    statement's header."""
    spans = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.stmt):
            continue
        body = getattr(node, "body", None)
        if isinstance(body, list) and body:
            spans.append((node.lineno, body[0].lineno - 1))
        else:
            spans.append((node.lineno, node.end_lineno))
    return spans


def sync_sites(run) -> dict:
    """{stack: syncs} of one call of ``run`` under
    ``torch.cuda.set_sync_debug_mode("warn")``: each warning is keyed on
    the frames of ``src/repro_torch`` on the stack when it is raised,
    innermost first, as ((path, line, function name), ...); () when no
    frame of the port is on it."""
    import traceback
    import warnings

    port = str(ROOT / "src" / "repro_torch")
    sites: dict = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = tuple(
            (os.path.relpath(fr.filename, ROOT).replace(os.sep, "/"),
             fr.lineno, fr.name)
            for fr in reversed(traceback.extract_stack())
            if fr.filename.startswith(port))
        sites[stack] = sites.get(stack, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


# Syncs that a hot function reaches through a helper outside the hot
# registry, where HS001 (which reads one function at a time) cannot see
# them: (the helper's path, its name, the hot function that reaches it)
# -> what the helper reads. Phase 12 (c) accepts a sync raised in a helper
# only when the hot function's call line is a static finding or the
# helper is listed here for that hot function.
HELPER_SYNCS = {
    ("src/repro_torch/core/boomhq.py", "_features_batch",
     "BoomHQ.optimize_batch"): "H2D of the batch's weights, log k and "
                               "recall targets; three a batch, no loop",
    ("src/repro_torch/core/boomhq.py", "_retry_underfilled",
     "BoomHQ.execute_batch"): "H2D of the underfilled queries' index; one "
                              "a batch, when any query underfills",
    ("src/repro_torch/vectordb/predicates.py", "take",
     "BatchedHybridExecutor._batched_subquery"):
        "H2D of the re-expansion's selection; one a round, beside the "
        "round's suppressed n_qual read",
}


def sync_phase(bq, queries, lint: dict) -> dict:
    """Phase 12 (c): the synchronizing calls of one served batch (32 of the
    serving queries on phase 4's instance, the default and the forced
    candidate-local pass, each after a warm batch), by file:line. A sync
    is checked at the innermost frame that lies inside a hot function of
    ``analysis.config``: where that frame raised it, the line must be one
    of (a)'s findings (suppressed or baselined) or share its statement
    with one; where it called a helper that raised it, the call line must
    be a finding or the helper one of ``HELPER_SYNCS``. A sync that passes
    neither is an idiom the static rule misses, and fails the phase."""
    from repro_torch.analysis.astpass import ModuleLint
    from repro_torch.analysis.config import LintConfig
    from repro_torch.serve.batch import CANDIDATE_LOCAL, CostModel

    found: dict = {}
    for f in lint["findings"]:
        found.setdefault(f["path"], set()).add(f["line"])
    parsed: dict = {}

    def where(path, line):
        """-> (the hot function the line lies in or None, accounted?)."""
        if path not in parsed:
            src = (ROOT / path).read_text()
            lint_ = ModuleLint(path, src, LintConfig(runtime=False),
                               relpath=path)
            parsed[path] = (lint_.hot_spans(), _stmt_spans(lint_.tree))
        hot, spans = parsed[path]
        fn = next((qn for a, z, qn in hot if a <= line <= z), None)
        span = min((sp for sp in spans if sp[0] <= line <= sp[1]),
                   key=lambda sp: sp[1] - sp[0], default=(line, line))
        lines = found.get(path, set())
        return fn, any(span[0] <= x <= span[1] for x in lines)

    def check(stack):
        """-> (site, hot function, the hot call line or None, verdict)."""
        if not stack:
            return "?", None, None, "outside the port"
        site = f"{stack[0][0]}:{stack[0][1]}"
        for i, (path, line, _) in enumerate(stack):
            fn, ok = where(path, line)
            if fn is None:
                continue
            if i == 0:
                return site, fn, None, "a finding" if ok else None
            via = f"{path}:{line}"
            if ok:
                return site, fn, via, "a finding"
            reason = HELPER_SYNCS.get((stack[0][0], stack[0][2], fn))
            return site, fn, via, reason and f"listed: {reason}"
        return site, None, None, "outside the hot functions"

    batch = queries[:BATCH]
    out, missed = {}, []
    for label, cm in (("default", None),
                      ("candidate_local", CostModel(force=CANDIDATE_LOCAL))):
        bq.bind_cost_model(cm)
        bq.execute_batch(batch)  # builds the executor, warms its buckets
        torch.cuda.synchronize()
        rows: dict = {}
        for stack, n in sync_sites(lambda: bq.execute_batch(batch)).items():
            key = check(stack)
            rows[key] = rows.get(key, 0) + n
        total = sum(rows.values())
        log(f"phase 12 (c): {label} batch of {len(batch)}: {total} "
            f"synchronizing calls at {len({k[0] for k in rows})} lines")
        out_rows = []
        for (site, fn, via, verdict), n in sorted(
                rows.items(), key=lambda kv: tuple(map(str, kv[0]))):
            out_rows.append(dict(
                site=site, syncs=n, hot_function=fn, via=via,
                finding=verdict == "a finding",
                verdict=verdict or "NOT A FINDING"))
            if verdict is None:
                missed.append(f"{label}: {site} in {fn}"
                              + (f" (called from {via})" if via else ""))
            print(f"    {site:45s} {n:4d}  "
                  + (f"hot {fn}" + (f" via {via}" if via else "") + ", "
                     if fn else "") + (verdict or "NOT A FINDING"))
        out[label] = dict(syncs=total, sites=out_rows)
    bq.bind_cost_model()
    if missed:
        raise AssertionError("syncs inside hot functions that no static "
                             "finding or listed helper covers (a sync "
                             "idiom the rule misses): " + "; ".join(missed))
    return out


# ---------------------------------------------------------------------------
# phase 13: the dense language models
# ---------------------------------------------------------------------------

LM_ARCH = "stablelm-1.6b"  # the §4 embedder's default architecture
LM_PARITY_ARCHS = ("stablelm-1.6b", "qwen3-14b")  # (a): smoke configs
LM_BATCH = 8
LM_PROMPT = 512
LM_STEPS = 64  # (c)'s greedy steps
LM_CHECK_STEPS = 4  # (b)'s decode steps held to the full forward
LM_EMBED_ROWS = 20_000
LM_EMBED_DIM = 768
LM_EMBED_SEQ = 16
LM_EMBED_BATCH = 256
LM_ATOL = LM_RTOL = 1e-4  # (a): the card against the CPU, f32
# (b): tests/test_models.py's decode-vs-forward tolerance
DECODE_ATOL, DECODE_RTOL = 2e-2, 2e-3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak


def _lm_tokens(cfg, b: int, s: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)),
                           dtype=torch.int32, device=device)


def _held(got, want, atol: float, rtol: float, label: str) -> float:
    """Max |got - want| (on the host), failing outside atol + rtol·|want|."""
    got, want = got.float().cpu(), want.float().cpu()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=atol, rtol=rtol):
        raise AssertionError(f"phase {label}: max abs err {err} outside "
                             f"atol {atol}, rtol {rtol}")
    return err


def lm_parity(arch: str, device, *, phase: str = "13", b: int = 2,
              prompt: int = 32, steps: int = 4) -> dict:
    """(a) One smoke config in f32 on the card and on the CPU with the same
    parameters: ``hidden`` and the prefill's and every decode step's logits
    within LM_ATOL/LM_RTOL, ``greedy_generate``'s tokens equal."""
    import copy

    from repro_torch import configs
    from repro_torch.models import lm, lm_serving

    cfg = configs.get_config(arch, smoke=True)
    if cfg.dtype != "float32":
        raise AssertionError(f"{cfg.name} is not an f32 config")
    cpu = lm.init(cfg, seed=0, device="cpu")
    card = copy.deepcopy(cpu).to(device)
    toks = _lm_tokens(cfg, b, prompt + steps, 13, "cpu")
    runs = {}
    for name, model in (("cpu", cpu), ("card", card)):
        t = toks.to(model.device)
        batch = {"tokens": t[:, :prompt]}
        h = lm.hidden(model, batch)
        logits, cache = lm.prefill(model, batch, prompt + steps + 1)
        outs = [logits]
        for i in range(steps):
            logits, cache = lm.decode_step(model, {"token": t[:, prompt + i]},
                                           prompt + i, cache)
            outs.append(logits)
        gen = lm_serving.greedy_generate(model, batch, steps=2 * steps,
                                         max_len=prompt + 2 * steps + 1)
        runs[name] = (h, torch.stack(outs, 1), gen)
    (h_c, l_c, g_c), (h_d, l_d, g_d) = runs["cpu"], runs["card"]
    if h_d.device.type != device.type:
        raise AssertionError(f"phase {phase} (a): hidden ran on {h_d.device}")
    out = dict(arch=cfg.name,
               hidden_max_abs_err=_held(h_d, h_c, LM_ATOL, LM_RTOL,
                                        f"{phase} (a) {cfg.name} hidden"),
               logits_max_abs_err=_held(l_d, l_c, LM_ATOL, LM_RTOL,
                                        f"{phase} (a) {cfg.name} logits"))
    if not torch.equal(g_d.cpu(), g_c):
        raise AssertionError(f"phase {phase} (a) {cfg.name}: greedy tokens "
                             f"differ, card {g_d.tolist()} cpu {g_c.tolist()}")
    log(f"phase {phase} (a) {cfg.name} f32, card against CPU: hidden max abs "
        f"err {out['hidden_max_abs_err']:.3e}, prefill + {steps} decode "
        f"logits {out['logits_max_abs_err']:.3e} (atol {LM_ATOL}, rtol "
        f"{LM_RTOL}); {2 * steps} greedy tokens equal")
    return out


def _block_params(model) -> int:
    return sum(t.numel() for t in model.blocks.parameters())


def param_count_gap(model) -> dict:
    """What the model holds beyond ``cfg.n_params()``, leaf by leaf: the
    padded vocab's rows of the embedding (and of an untied head), and the
    LayerNorm biases that ``n_params()`` leaves out ("bias ignored for
    estimate"); and, negative, what ``n_params()`` counts of the MTP block
    beyond what it holds (``n_params()`` gives it the last layer's FFN, a
    MoE one in the moe family, where ``lm.init`` gives it a dense FFN of
    width ``dense_d_ff``)."""
    cfg = model.cfg
    pad = (cfg.vocab_padded - cfg.vocab) * cfg.d_model
    gap = {}
    for name, p in model.named_parameters():
        if name in ("embed.table", "lm_head.w") and pad:
            gap[name] = pad
        elif name.endswith(".bias"):
            gap[name] = p.numel()
    if cfg.mtp_depth:
        d = cfg.d_model
        counted = cfg.mtp_depth * (
            cfg._attn_params() + cfg._ffn_params(cfg.n_layers - 1)
            + 2 * d * cfg.d_model + 4 * d)
        gap["mtp"] = sum(p.numel() for p in model.mtp.parameters()) - counted
    return gap


def lm_decode_matches_forward(device, *, arch: str = LM_ARCH,
                              phase: str = "13 (b)", smoke: bool = False,
                              b: int = LM_BATCH, prompt: int = LM_PROMPT,
                              total: int | None = None,
                              steps: int = LM_CHECK_STEPS) -> dict:
    """(b) ``arch`` at full width in f32, initialized on the card from a
    seeded ``torch.Generator("cuda")``: its parameter count against
    ``cfg.n_params()`` with each difference named leaf by leaf
    (``param_count_gap``), then a prefill of ``prompt`` tokens and
    ``steps`` decode steps against the logits of the full forward over
    ``total`` positions (``prompt + steps`` unless given) at the same
    positions (TF32 is off)."""
    from repro_torch import configs
    from repro_torch.common.device import synchronize
    from repro_torch.models import lm

    cfg = dataclasses.replace(configs.get_config(arch, smoke=smoke),
                              dtype="float32")
    total = total or prompt + steps
    t = time.perf_counter()
    model = lm.init(cfg, seed=0, device=device)
    synchronize(device)
    init_s = time.perf_counter() - t
    n = sum(p.numel() for p in model.parameters())
    gap = param_count_gap(model)
    if n != cfg.n_params() + sum(gap.values()):
        raise AssertionError(f"phase {phase} {cfg.name}: {n} parameters "
                             f"against n_params() {cfg.n_params()} + {gap}")
    toks = _lm_tokens(cfg, b, total, 17, device)
    h = lm.hidden(model, {"tokens": toks})
    with torch.no_grad():
        full = lm.unembed(model, h[:, prompt - 1: prompt + steps])
    del h
    logits, cache = lm.prefill(model, {"tokens": toks[:, :prompt]},
                               prompt + steps)
    got = [logits]
    for i in range(steps):
        logits, cache = lm.decode_step(model, {"token": toks[:, prompt + i]},
                                       prompt + i, cache)
        got.append(logits)
    got = torch.stack(got, 1)
    if not bool(torch.isfinite(got[..., : cfg.vocab]).all()):
        raise AssertionError(f"phase {phase} {cfg.name}: logits not finite")
    err = _held(got, full, DECODE_ATOL, DECODE_RTOL,
                f"{phase} {cfg.name} decode against the full forward")
    out = dict(config=cfg.name, params=n, n_params=cfg.n_params(),
               beyond_n_params=gap, init_s=init_s, device=str(model.device),
               batch=b, prompt=prompt, forward_len=total, steps=steps,
               max_abs_err=err)
    log(f"phase {phase} {cfg.name} f32 on {model.device}: {n:,} parameters "
        f"(n_params() {cfg.n_params():,} + {sum(gap.values()):,}: "
        f"{gap or 'nothing'}), drawn in {init_s:.2f} s; B={b} x {prompt} "
        f"prefill + {steps} decode steps against the full forward over "
        f"{total} positions: max abs err {err:.3e} (atol {DECODE_ATOL}, "
        f"rtol {DECODE_RTOL})")
    return out


def timed_generation(cfg, device, *, b: int, prompt: int, steps: int,
                     phase: str) -> tuple:
    """The model of ``cfg`` in its own compute dtype, drawn on ``device``
    from seed 0: ``greedy_generate`` once (warm), then its loop again with
    a CUDA event after the prefill and after each step, read only after
    the loop (each block cast to the compute dtype at its use, as
    ``greedy_generate`` does); the tokens must equal ``greedy_generate``'s;
    the peak memory of both runs, the model included. The device's own time of a prefill
    and of a step (replayed from a CUDA graph, so without the host's
    enqueue) gives the step's idle share; one profile of each. -> (model,
    timings)."""
    from repro_torch.common.device import synchronize
    from repro_torch.models import lm, lm_serving

    synchronize(device)
    # the earlier phases' tensors stay resident: the peak is read above them
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    model = lm.init(cfg, seed=0, device=device)
    batch = {"tokens": _lm_tokens(cfg, b, prompt, 19, device)}
    max_len = prompt + steps + 1
    ref = lm_serving.greedy_generate(model, batch, steps=steps,
                                     max_len=max_len)
    prefill = lm_serving.make_prefill_step(model, max_len)
    decode = lm_serving.make_decode_step(model)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 2)]
    ev[0].record()
    logits, cache = prefill(batch)
    ev[1].record()
    tok, outs = lm_serving.greedy_token(cfg, logits), []
    for i in range(steps):
        outs.append(tok)
        logits, cache = decode(lm_serving.next_inputs(cfg, tok), prompt + i,
                               cache)
        tok = lm_serving.greedy_token(cfg, logits)
        ev[i + 2].record()
    synchronize(device)
    got = torch.stack(outs, dim=1)
    if not torch.equal(got, ref):
        raise AssertionError(f"phase {phase}: the timed loop's tokens differ "
                             f"from greedy_generate's")
    peak = (torch.cuda.max_memory_allocated() - resident
            if device.type == "cuda" else 0)
    prefill_ms = ev[0].elapsed_time(ev[1])
    step_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(steps)]
    last = lm_serving.next_inputs(cfg, tok)
    step_dev_ms = graph_time_ms(lambda: decode(last, prompt + steps, cache),
                                iters=10)
    prefill_dev_ms = graph_time_ms(lambda: prefill(batch), iters=2)
    log(f"phase {phase} {cfg.name}: one decode step, then one prefill, "
        f"profiled:")
    profiles = dict(
        decode_step=profile_batch(lambda: decode(last, prompt + steps, cache)),
        prefill=profile_batch(lambda: prefill(batch)))
    median = float(np.median(step_ms))
    return model, dict(
        config=cfg.name, dtype=cfg.dtype, batch=b, prompt=prompt, steps=steps,
        prefill_ms=prefill_ms, decode_step_ms_median=median,
        decode_step_ms_min=min(step_ms), decode_step_ms_max=max(step_ms),
        prefill_device_ms=prefill_dev_ms, decode_step_device_ms=step_dev_ms,
        decode_step_idle_share=1.0 - step_dev_ms / median,
        decode_tokens_per_s=b * 1e3 / median,
        tokens_per_s=b * steps * 1e3 / (prefill_ms + sum(step_ms)),
        peak_memory_bytes=peak, profiles=profiles)


def lm_generate_timed(device, *, smoke: bool = False, b: int = LM_BATCH,
                      prompt: int = LM_PROMPT, steps: int = LM_STEPS) -> dict:
    """(c) ``timed_generation`` of ``stablelm-1.6b`` in bf16 (its config),
    each time against its bound: the prefill's block products at the bf16
    peak; a decode step's bytes (bf16 block weights and the f32 tied
    table; separately with the cache rows up to the step's position) at
    the HBM rate."""
    from repro_torch import configs

    cfg = configs.get_config(LM_ARCH, smoke=smoke)
    model, out = timed_generation(cfg, device, b=b, prompt=prompt,
                                  steps=steps, phase="13 (c)")
    p_blocks = _block_params(model)
    table_bytes = 4 * cfg.vocab_padded * cfg.d_model
    weight_bytes = 2 * p_blocks + table_bytes
    mid = prompt + steps // 2
    cache_bytes = (2 * cfg.n_layers * b * (mid + 1) * cfg.n_kv_heads
                   * cfg.head_dim * 2)
    out.update(
        prefill_bound_ms=2 * p_blocks * b * prompt / BF16_FLOPS * 1e3,
        decode_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
        decode_bound_with_cache_ms=(weight_bytes + cache_bytes)
        / HBM_BYTES_PER_S * 1e3,
        block_params=p_blocks)
    log(f"phase 13 (c) {cfg.name} {cfg.dtype} greedy_generate B={b}, "
        f"{prompt}-token prompt, {steps} steps (CUDA events): prefill "
        f"{out['prefill_ms']:.3f} ms, device {out['prefill_device_ms']:.3f} "
        f"ms (bound {out['prefill_bound_ms']:.3f} ms: "
        f"2 x {p_blocks:,} x {b * prompt} flops at 989 TFLOP/s); decode "
        f"step median {out['decode_step_ms_median']:.3f} ms (min "
        f"{out['decode_step_ms_min']:.3f}, max {out['decode_step_ms_max']:.3f};"
        f" device {out['decode_step_device_ms']:.3f} ms, idle share "
        f"{out['decode_step_idle_share']:.3f}; bound "
        f"{out['decode_bound_ms']:.3f} ms: {weight_bytes / 1e9:.3f} GB"
        f" of bf16 block weights and the f32 table at 3.35 TB/s, "
        f"{out['decode_bound_with_cache_ms']:.3f} ms with the cache rows to "
        f"position {mid}); {out['decode_tokens_per_s']:.1f} tokens/s a step, "
        f"{out['tokens_per_s']:.1f} tokens/s with the prefill; peak memory "
        f"{out['peak_memory_bytes'] / 2**30:.2f} GiB above the earlier "
        f"phases' (the model's f32 weights, one block's bf16 cast at a "
        f"time, the cache, the activations)")
    return out


LM_F32_ARCH = "qwen3-14b"  # (f): f32 parameters near the card's size


def lm_generate_f32_params(device, *, smoke: bool = False, b: int = LM_BATCH,
                           prompt: int = LM_PROMPT, steps: int = LM_STEPS
                           ) -> dict:
    """(f) ``greedy_generate`` of ``qwen3-14b`` at full width (bf16 compute
    on its f32 parameters, each block cast at its use): its tokens in the
    vocab, its seconds and its peak memory beside the parameters' bytes and
    the bf16 copy of every block that the serving steps once held beside
    them (which, with the f32 parameters, passed the card's memory)."""
    from repro_torch import configs
    from repro_torch.common.device import synchronize
    from repro_torch.models import lm, lm_serving

    cfg = configs.get_config(LM_F32_ARCH, smoke=smoke)
    if smoke:  # the full config's compute dtype on the f32 smoke one
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
    synchronize(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    model = lm.init(cfg, seed=0, device=device)
    params_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    cast = lm.compute_dtype(cfg)
    copy_bytes = sum(p.numel() * torch.finfo(cast).bits // 8
                     for name in lm._stacks(model)
                     for p in getattr(model, name).parameters())
    toks = _lm_tokens(cfg, b, prompt, 19, device)
    synchronize(device)
    t = time.perf_counter()
    out = lm_serving.greedy_generate(model, {"tokens": toks}, steps=steps,
                                     max_len=prompt + steps + 1)
    synchronize(device)
    seconds = time.perf_counter() - t
    peak = (torch.cuda.max_memory_allocated() - resident
            if device.type == "cuda" else 0)
    if tuple(out.shape) != (b, steps) or not bool(
            ((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"phase 13 (f) {cfg.name}: tokens "
                             f"{tuple(out.shape)} outside the vocab")
    res = dict(config=cfg.name, dtype=cfg.dtype,
               param_dtype=cfg.param_dtype, batch=b, prompt=prompt,
               steps=steps, seconds=seconds, params_bytes=params_bytes,
               whole_copy_bytes=copy_bytes, peak_memory_bytes=peak)
    log(f"phase 13 (f) {cfg.name} {cfg.dtype} on {cfg.param_dtype} "
        f"parameters: greedy_generate B={b}, {prompt}-token prompt, {steps} "
        f"steps in {seconds:.2f} s with the first call; peak memory "
        f"{peak / 2**30:.2f} GiB ({params_bytes / 2**30:.2f} GiB of "
        f"parameters; a whole-model {cfg.dtype} copy of the blocks would "
        f"add {copy_bytes / 2**30:.2f} GiB)")
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return res


def lm_embed_phase(device, *, smoke: bool = False, rows: int = LM_EMBED_ROWS,
                   dim: int = LM_EMBED_DIM, seq: int = LM_EMBED_SEQ,
                   batch: int = LM_EMBED_BATCH) -> dict:
    """(d) ``lm_embed`` of ``rows`` rows of ``datasets._scalar_table`` at
    full width: once initializing its own model, once with a carried model
    of the same seed; shape, finite, unit norms, both runs equal bit for
    bit; rows/s of the second against the bound of its block products."""
    from repro_torch import configs
    from repro_torch.bench import augment, datasets
    from repro_torch.common.device import synchronize
    from repro_torch.models import lm

    scalars, _ = datasets._scalar_table(rows, 0)
    kw = dict(arch=LM_ARCH, smoke=smoke, seed=0, seq=seq, batch=batch)
    t = time.perf_counter()
    first = augment.lm_embed(scalars, dim, device=device, **kw)
    first_s = time.perf_counter() - t
    model = lm.init(configs.get_config(LM_ARCH, smoke=smoke), seed=0,
                    device=device)
    synchronize(device)
    t = time.perf_counter()
    second = augment.lm_embed(scalars, dim, model=model, **kw)
    second_s = time.perf_counter() - t
    norms = np.linalg.norm(second, axis=1)
    if second.shape != (rows, dim) or not np.isfinite(second).all():
        raise AssertionError(f"phase 13 (d): shape {second.shape}, finite "
                             f"{bool(np.isfinite(second).all())}")
    if np.abs(norms - 1.0).max() > 1e-3:
        raise AssertionError(f"phase 13 (d): norms off 1 by "
                             f"{np.abs(norms - 1.0).max()}")
    if not np.array_equal(first, second):
        raise AssertionError("phase 13 (d): two runs differ")
    p_blocks = _block_params(model)
    bound_s = 2 * p_blocks * rows * seq / BF16_FLOPS
    toks = torch.as_tensor(augment.lm_tokens(
        scalars[:batch], seq, model.cfg.vocab, model.cfg.vocab_padded),
        device=device)
    blocks = lm.cast_blocks(model)
    batch_dev_ms = graph_time_ms(
        lambda: lm.hidden(model, {"tokens": toks}, blocks=blocks), iters=2)
    device_s = batch_dev_ms * 1e-3 * -(-rows // batch)
    out = dict(rows=rows, dim=dim, seq=seq, batch=batch,
               first_s_with_init=first_s, seconds=second_s,
               batch_device_ms=batch_dev_ms, device_s=device_s,
               rows_per_s=rows / second_s, bound_s=bound_s,
               max_norm_err=float(np.abs(norms - 1.0).max()))
    log(f"phase 13 (d) lm_embed {rows:,} rows x {seq} tokens -> {dim}-d on "
        f"{model.cfg.name}: {second_s:.3f} s, {out['rows_per_s']:.1f} rows/s;"
        f" device {device_s:.3f} s ({batch_dev_ms:.3f} ms a batch of {batch}"
        f" from a CUDA graph) "
        f"(bound {bound_s:.3f} s: 2 x {p_blocks:,} x {rows * seq:,} flops at "
        f"989 TFLOP/s; {first_s:.3f} s with its own init); unit norms to "
        f"{out['max_norm_err']:.1e}; two runs equal bit for bit")
    return out


def lm_serve_cli(device, *, smoke: bool = False, arch: str = LM_ARCH,
                 phase: str = "13 (e)") -> dict:
    """``launch.serve.main`` at ``arch``'s full width returns its tokens on
    the card."""
    from repro_torch import configs
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--batch", "4", "--prompt-len", "32",
            "--steps", "16"] + (["--smoke"] if smoke else [])
    t = time.perf_counter()
    toks = serve.main(argv)
    seconds = time.perf_counter() - t
    vocab = configs.get_config(arch, smoke=smoke).vocab
    if (toks.device.type != device.type or tuple(toks.shape) != (4, 16)
            or not bool(((toks >= 0) & (toks < vocab)).all())):
        raise AssertionError(f"phase {phase}: tokens {tuple(toks.shape)} on "
                             f"{toks.device}")
    log(f"phase {phase} launch.serve.main {' '.join(argv)}: tokens "
        f"{tuple(toks.shape)} on {toks.device} in {seconds:.2f} s with the "
        f"init")
    return dict(argv=argv, shape=list(toks.shape), device=str(toks.device),
                seconds=seconds)


def lm_phase(device, *, smoke: bool = False) -> dict:
    """Phase 13: (a) card against CPU on smoke configs, (b) decode against
    the full forward at full width in f32, (c) timed greedy generation in
    bf16, (d) ``lm_embed`` at full width, (e) the serving CLI. ``smoke``
    runs (b)-(e) on the smoke config at small sizes (a CPU rehearsal)."""
    t = time.perf_counter()
    small = dict(b=2, prompt=24) if smoke else {}
    out = dict(
        parity=[lm_parity(a, device) for a in LM_PARITY_ARCHS],
        decode_vs_forward=lm_decode_matches_forward(device, smoke=smoke,
                                                    **small),
        generate=lm_generate_timed(device, smoke=smoke,
                                   **(dict(small, steps=6) if smoke else {})),
        embed=lm_embed_phase(device, smoke=smoke,
                             **(dict(rows=300, dim=32) if smoke else {})),
        serve=lm_serve_cli(device, smoke=smoke))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t
    log(f"phase 13 done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 14: the SSM and hybrid language models
# ---------------------------------------------------------------------------

SSM_ARCHS = ("mamba2-370m", "zamba2-2.7b")
# (b): the prefill's length must be a multiple of the SSD chunk (256 and
# 128; the scan pads nothing), the full forward's too
SSM_CHECK_PROMPT = 256
SSM_CHECK_LEN = 512
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores


def _tree_sum(tree, fn) -> int:
    if isinstance(tree, dict):
        return sum(_tree_sum(v, fn) for v in tree.values())
    return fn(tree)


def _nbytes(tree) -> int:
    return _tree_sum(tree, lambda t: t.numel() * t.element_size())


def ssm_bounds(model, b: int, prompt: int, steps: int) -> dict:
    """The least times of (c)'s work on the card (3.35 TB/s; 989 TFLOP/s
    bf16, 67 TFLOP/s f32), from the shapes the code runs.

    A decode step moves, each once: the block weights as cast (bf16 but
    the f32 ``A_log``/``D``/``dt_bias``; the hybrid's shared block at each
    of its uses), the f32 head, every layer's conv windows and SSM state
    read and written, and the hybrid's k/v rows up to the step's position.
    The prefill computes the block products in bf16 (the shared block at
    each use; the attention's probabilities times v too) and, in f32, the
    SSD scan's contractions (the masked L x L products in full, as the code
    does them) and the attention's scores; its bound is the largest of
    those two times and its weight bytes."""
    from repro_torch.models import lm, mamba2

    cfg = model.cfg
    cast = lm.cast_blocks(model)
    hybrid = cfg.family == "hybrid"
    uses = cfg.n_layers // cfg.hybrid_attn_every if hybrid else 0
    shared = cast.get("shared_attn", {})
    head = model.embed.table if cfg.tie_embeddings else model.lm_head.w
    weight_bytes = (sum(_nbytes(p) for p in cast["blocks"])
                    + uses * _nbytes(shared) + _nbytes(head))
    dt = lm.compute_dtype(cfg)
    state_bytes = 2 * cfg.n_layers * _nbytes(
        mamba2.mamba_make_cache(cfg, b, dt, "meta"))
    mid = prompt + steps // 2
    row = b * cfg.n_kv_heads * cfg.head_dim * torch.finfo(dt).bits // 8
    # k and v: the mid + 1 rows read, the new one written
    kv_bytes = uses * 2 * row * (mid + 2)
    decode_bytes = weight_bytes + state_bytes + kv_bytes
    matrices = (sum(_tree_sum(p, torch.Tensor.numel) for p in cast["blocks"])
                + uses * _tree_sum(shared, torch.Tensor.numel))
    L = min(cfg.ssm_chunk, prompt)
    h, n, p_dim = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    scan_flops = cfg.n_layers * (prompt // L) * 2 * b * h * (
        L * L * n + L * L * p_dim + 2 * L * n * p_dim)
    attn_flops = uses * 2 * b * cfg.n_heads * prompt * prompt * cfg.head_dim
    bf16_flops = 2 * matrices * b * prompt + attn_flops  # + probs @ v
    f32_flops = scan_flops + attn_flops  # + the scores
    prefill = dict(bf16_ms=bf16_flops / BF16_FLOPS * 1e3,
                   f32_ms=f32_flops / F32_FLOPS * 1e3,
                   bytes_ms=weight_bytes / HBM_BYTES_PER_S * 1e3)
    return dict(decode_bound_ms=decode_bytes / HBM_BYTES_PER_S * 1e3,
                decode_bytes=dict(weights=weight_bytes, state=state_bytes,
                                  kv=kv_bytes),
                prefill_bound_ms=max(prefill.values()),
                prefill_bound_by=max(prefill, key=prefill.get),
                prefill_bound_parts_ms=prefill,
                prefill_flops=dict(bf16=bf16_flops, f32=f32_flops,
                                   scan=scan_flops),
                block_params=matrices)


def ssm_generate_timed(arch: str, device, *, smoke: bool = False,
                       b: int = LM_BATCH, prompt: int = LM_PROMPT,
                       steps: int = LM_STEPS) -> dict:
    """(c) ``timed_generation`` of ``arch`` in bf16 (its config), each time
    beside ``ssm_bounds``."""
    from repro_torch import configs

    cfg = configs.get_config(arch, smoke=smoke)
    model, out = timed_generation(cfg, device, b=b, prompt=prompt,
                                  steps=steps, phase="14 (c)")
    out.update(ssm_bounds(model, b, prompt, steps))
    parts = out["prefill_bound_parts_ms"]
    gb = {k: v / 1e9 for k, v in out["decode_bytes"].items()}
    log(f"phase 14 (c) {cfg.name} {cfg.dtype} greedy_generate B={b}, "
        f"{prompt}-token prompt, {steps} steps (CUDA events): prefill "
        f"{out['prefill_ms']:.3f} ms, device {out['prefill_device_ms']:.3f} "
        f"ms (bound {out['prefill_bound_ms']:.3f} ms by "
        f"{out['prefill_bound_by']}: bf16 products {parts['bf16_ms']:.3f} "
        f"ms at 989 TFLOP/s, f32 scan and scores {parts['f32_ms']:.3f} ms at "
        f"67 TFLOP/s, weights {parts['bytes_ms']:.3f} ms); decode step "
        f"median {out['decode_step_ms_median']:.3f} ms (min "
        f"{out['decode_step_ms_min']:.3f}, max {out['decode_step_ms_max']:.3f};"
        f" device {out['decode_step_device_ms']:.3f} ms, idle share "
        f"{out['decode_step_idle_share']:.3f}; bound "
        f"{out['decode_bound_ms']:.3f} ms: weights {gb['weights']:.3f} GB, "
        f"state {gb['state']:.3f} GB, k/v {gb['kv']:.3f} GB at 3.35 TB/s); "
        f"{out['decode_tokens_per_s']:.1f} tokens/s a step, "
        f"{out['tokens_per_s']:.1f} tokens/s with the prefill; peak memory "
        f"{out['peak_memory_bytes'] / 2**30:.2f} GiB above the earlier "
        f"phases'")
    return out


def ssm_phase(device, *, smoke: bool = False) -> dict:
    """Phase 14: (a) card against CPU on the ``mamba2`` and ``zamba2``
    smoke configs, (b) decode against the full forward at full width in
    f32, (c) timed greedy generation in bf16, (d) the serving CLI, each for
    both archs. ``smoke`` runs (b)-(d) on the smoke configs at small sizes
    (a CPU rehearsal)."""
    t = time.perf_counter()
    check = (dict(b=2, prompt=16, total=32) if smoke else
             dict(prompt=SSM_CHECK_PROMPT, total=SSM_CHECK_LEN))
    gen = dict(b=2, prompt=32, steps=6) if smoke else {}
    out = dict(
        parity=[lm_parity(a, device, phase="14") for a in SSM_ARCHS],
        decode_vs_forward=[lm_decode_matches_forward(
            device, arch=a, phase="14 (b)", smoke=smoke, **check)
            for a in SSM_ARCHS],
        generate=[ssm_generate_timed(a, device, smoke=smoke, **gen)
                  for a in SSM_ARCHS],
        serve=[lm_serve_cli(device, smoke=smoke, arch=a, phase="14 (d)")
               for a in SSM_ARCHS])
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t
    log(f"phase 14 done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: the moe family (deepseek-v3 with MLA and MTP, kimi-k2)
# ---------------------------------------------------------------------------

MOE_ARCHS = ("deepseek-v3-671b", "kimi-k2-1t-a32b")
# (a): tests/test_models.py's setting; at the smoke size (8 experts, top 2)
# C = S·k/E·8 >= S, so nothing can drop
MOE_CHECK_CF = 8.0
MOE_CHECK_B, MOE_CHECK_PROMPT = 2, 128  # (b): beside 63.2 GB of f32 weights
MOE_MESH = (2, 2)  # (a): the (data, model) grid of the sharded MoE
MOE_SHARD_B, MOE_SHARD_S = 4, 16


def moe_depth_cut(cfg):
    """Full width, the depth cut to the dense prefix and one MoE block."""
    return dataclasses.replace(cfg, n_layers=cfg.first_k_dense + 1)


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _held_tree(got, want, label: str) -> float:
    """``_held`` leaf by leaf (every layer of a stacked cache at once)."""
    if isinstance(want, dict):
        return max(_held_tree(got[k], want[k], f"{label} {k}") for k in want)
    return _held(got, want, LM_ATOL, LM_RTOL, label)


def moe_parity(arch: str, device, *, b: int = 2, prompt: int = 32,
               steps: int = 4) -> dict:
    """(a) One moe smoke config in f32 (its own capacity factor, 1.25, so
    the prefill drops) on the card and on the CPU with the same
    parameters: ``hidden`` and its aux, the prefill's and every decode
    step's logits, every layer's cache after the prefill and after the
    steps, within LM_ATOL/LM_RTOL; ``greedy_generate``'s tokens equal."""
    from repro_torch import configs
    from repro_torch.models import lm, lm_serving

    cfg = configs.get_config(arch, smoke=True)
    if cfg.dtype != "float32" or cfg.family != "moe":
        raise AssertionError(f"{cfg.name} is not an f32 moe config")
    cpu = lm.init(cfg, seed=0, device="cpu")
    card = copy.deepcopy(cpu).to(device)
    toks = _lm_tokens(cfg, b, prompt + steps, 23, "cpu")
    runs = {}
    for name, model in (("cpu", cpu), ("card", card)):
        t = toks.to(model.device)
        batch = {"tokens": t[:, :prompt]}
        h, aux = lm.hidden(model, batch, with_aux=True)
        logits, cache = lm.prefill(model, batch, prompt + steps + 1)
        caches, outs = [_clone_tree(cache)], [logits]
        for i in range(steps):
            logits, cache = lm.decode_step(model, {"token": t[:, prompt + i]},
                                           prompt + i, cache)
            outs.append(logits)
        caches.append(cache)
        gen = lm_serving.greedy_generate(model, batch, steps=2 * steps,
                                         max_len=prompt + 2 * steps + 1)
        runs[name] = (h, aux, torch.stack(outs, 1), caches, gen)
    (h_c, a_c, l_c, c_c, g_c), (h_d, a_d, l_d, c_d, g_d) = (runs["cpu"],
                                                            runs["card"])
    if h_d.device.type != device.type:
        raise AssertionError(f"phase 15 (a): hidden ran on {h_d.device}")
    label = f"15 (a) {cfg.name}"
    out = dict(
        arch=cfg.name,
        hidden_max_abs_err=_held(h_d, h_c, LM_ATOL, LM_RTOL,
                                 f"{label} hidden"),
        aux_max_abs_err=_held_tree(a_d, a_c, f"{label} aux"),
        logits_max_abs_err=_held(l_d, l_c, LM_ATOL, LM_RTOL,
                                 f"{label} logits"),
        cache_max_abs_err=max(_held_tree(d, c, f"{label} cache")
                              for d, c in zip(c_d, c_c)),
        aux={k: float(v) for k, v in a_c.items()})
    if out["aux"]["moe_drop_frac"] <= 0:
        raise AssertionError(f"phase {label}: the prompt dropped nothing")
    if not torch.equal(g_d.cpu(), g_c):
        raise AssertionError(f"phase {label}: greedy tokens differ, card "
                             f"{g_d.tolist()} cpu {g_c.tolist()}")
    log(f"phase {label} f32, card against CPU: hidden max abs err "
        f"{out['hidden_max_abs_err']:.3e}, aux {out['aux_max_abs_err']:.3e} "
        f"(drop frac {out['aux']['moe_drop_frac']:.4f} summed over the MoE "
        f"blocks), prefill + {steps} decode logits "
        f"{out['logits_max_abs_err']:.3e}, every layer's cache "
        f"{out['cache_max_abs_err']:.3e} (atol {LM_ATOL}, rtol {LM_RTOL}); "
        f"{2 * steps} greedy tokens equal")
    return out


def _shard_x(d_model: int) -> torch.Tensor:
    """(a)'s input: B x S tokens from one seed, every token of the first
    data shard the same, so its two experts' queues overflow at 1.25 (and
    the reported ``moe_drop_frac``, data shard 0's, is not 0)."""
    x = np.random.default_rng(29).normal(
        size=(MOE_SHARD_B, MOE_SHARD_S, d_model)).astype(np.float32)
    x[: MOE_SHARD_B // MOE_MESH[0]] = x[0, 0]
    return torch.from_numpy(x)


def moe_rank(rank: int, store: str, payload: dict, out_path: str) -> None:
    """One rank of phase 15 (a)'s sharded MoE, in its own process on the
    shared card (``payload["device"]``): ``moe_apply_sharded`` on its
    share of the layer over the (data, model) mesh, at each capacity
    factor there, and at 1.25 on the CPU too (the same ranks, the same
    group)."""
    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import moe_sharded as ms
    from repro_torch.vectordb.distributed import shard_rows

    card = payload["device"]
    if card == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    with process_group("gloo", store, rank=rank,
                       world=MOE_MESH[0] * MOE_MESH[1]):
        mesh = init_device_mesh("cpu", MOE_MESH,
                                mesh_dim_names=("data", "model"))
        r0, r1 = shard_rows(payload["x"].shape[0], mesh)
        for cf in (MOE_CHECK_CF, payload["cfg"].capacity_factor):
            cfg = dataclasses.replace(payload["cfg"], capacity_factor=cf)
            for dev in (card, "cpu") if cf != MOE_CHECK_CF else (card,):
                share = ms.mesh_share(_tree_to(payload["p"], dev), cfg, mesh)
                y, aux = ms.moe_apply_sharded(
                    share, cfg, payload["x"][r0:r1].to(dev), mesh)
                if y.device.type != dev:
                    raise AssertionError(f"rank {rank}: y on {y.device}")
                out[(cf, dev)] = (y.cpu(), {k: v.cpu()
                                            for k, v in aux.items()})
    torch.save(dict(rows=(r0, r1), out=out), out_path)


def moe_sharded_check(device) -> dict:
    """(a) ``moe_apply_sharded`` of the deepseek smoke config's MoE layer
    (8 experts, a shared one) over four ``gloo`` ranks sharing the card
    (``MOE_MESH``): at ``capacity_factor=8`` every rank's y equals one-
    process ``moe_apply``'s rows of its data shard and the aux its aux
    (nothing drops); at the config's 1.25 (one group per data shard, the
    first shard overflowing) each rank's card run equals its CPU run, y
    and aux. Within LM_ATOL/LM_RTOL."""
    from repro_torch import configs
    from repro_torch.models import lm, moe

    cfg = configs.get_config("deepseek-v3-671b", smoke=True)
    layer = moe.MoE(cfg, generator=torch.Generator().manual_seed(31))
    p = _clone_tree(lm.param_tree(layer))
    x = _shard_x(cfg.d_model)
    world = MOE_MESH[0] * MOE_MESH[1]
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        payload = dict(cfg=cfg, p=p, x=x, device=device.type)
        procs = [ctx.Process(target=moe_rank, args=(
            r, f"{d}/store", payload, f"{d}/rank{r}.pt"))
            for r in range(world)]
        t0 = time.perf_counter()
        for pr in procs:
            pr.start()
        try:
            for pr in procs:
                pr.join(timeout=3 * MESH_TIMEOUT_S)
        finally:
            for pr in procs:
                if pr.is_alive():
                    pr.terminate()
                    pr.join()
        wall = time.perf_counter() - t0
        codes = [pr.exitcode for pr in procs]
        if any(c != 0 for c in codes):
            raise AssertionError(f"phase 15 (a): rank exit codes {codes}")
        got = [torch.load(f"{d}/rank{r}.pt", weights_only=False)
               for r in range(world)]
    check = dataclasses.replace(cfg, capacity_factor=MOE_CHECK_CF)
    with torch.no_grad():
        y1, aux1 = moe.moe_apply(_tree_to(p, device), check, x.to(device))
    errs = dict(no_drop=0.0, card_cpu=0.0)
    for r, g in enumerate(got):
        r0, r1 = g["rows"]
        y, aux = g["out"][(MOE_CHECK_CF, device.type)]
        label = f"15 (a) sharded MoE rank {r}"
        errs["no_drop"] = max(
            errs["no_drop"],
            _held(y, y1[r0:r1], LM_ATOL, LM_RTOL, f"{label} cf 8 y"),
            *(_held(aux[k], aux1[k], LM_ATOL, LM_RTOL, f"{label} cf 8 {k}")
              for k in ("moe_lb_loss", "moe_z_loss")))
        if float(aux["moe_drop_frac"]) != 0.0:
            raise AssertionError(f"phase {label}: dropped at cf 8")
        yd, ad = g["out"][(cfg.capacity_factor, device.type)]
        yc, ac = g["out"][(cfg.capacity_factor, "cpu")]
        errs["card_cpu"] = max(errs["card_cpu"],
                               _held(yd, yc, LM_ATOL, LM_RTOL,
                                     f"{label} cf {cfg.capacity_factor} y"),
                               _held_tree(ad, ac, f"{label} aux"))
    drop = float(got[0]["out"][(cfg.capacity_factor, device.type)][1][
        "moe_drop_frac"])
    if drop <= 0:
        raise AssertionError("phase 15 (a): nothing dropped at 1.25")
    log(f"phase 15 (a) moe_apply_sharded over {world} gloo ranks on one card "
        f"({MOE_MESH[0]} data x {MOE_MESH[1]} model, {cfg.n_experts} experts,"
        f" x {tuple(x.shape)}), {wall:.1f} s with their start: cf "
        f"{MOE_CHECK_CF} against one-process moe_apply max abs err "
        f"{errs['no_drop']:.3e}; cf {cfg.capacity_factor} (drop frac "
        f"{drop:.4f}, data shard 0's) card against CPU {errs['card_cpu']:.3e}"
        f" (atol {LM_ATOL}, rtol {LM_RTOL})")
    return dict(ranks=world, mesh=list(MOE_MESH), wall_s=wall,
                no_drop_max_abs_err=errs["no_drop"],
                card_cpu_max_abs_err=errs["card_cpu"], drop_frac=drop)


def moe_decode_matches_forward(device, *, smoke: bool = False,
                               b: int = MOE_CHECK_B,
                               prompt: int = MOE_CHECK_PROMPT,
                               steps: int = LM_CHECK_STEPS) -> dict:
    """(b) ``deepseek-v3-671b`` at full width, its depth cut to
    ``moe_depth_cut``, in f32 (TF32 off), drawn on the card: the
    parameters it holds beside ``cfg.n_params()`` with each difference
    named (``param_count_gap``: the MTP block's MoE FFN that
    ``n_params()`` counts); a prefill of ``prompt`` tokens and ``steps``
    decode steps against the full forward over ``prompt + steps``
    positions; the first layer's MLA, absorbed decode against the
    expanded form on the same normed inputs.

    A decode step routes one token a group (capacity 1, nothing drops),
    so the forward must drop nothing either: at ``capacity_factor`` E / k
    (32) an expert's capacity is a whole row, the least at which no
    routing can drop. At ``MOE_CHECK_CF`` (8) the same forward drops,
    the randomly drawn router sending more than a quarter of a row's
    tokens to one expert; its dropped share is reported."""
    from repro_torch import configs
    from repro_torch.common.device import synchronize
    from repro_torch.models import attention, lm

    cfg = moe_depth_cut(configs.get_config(MOE_ARCHS[0], smoke=smoke))
    cfg = dataclasses.replace(
        cfg, dtype="float32",
        capacity_factor=cfg.n_experts / cfg.n_experts_per_tok)
    total = prompt + steps
    synchronize(device)
    t = time.perf_counter()
    model = lm.init(cfg, seed=0, device=device)
    synchronize(device)
    init_s = time.perf_counter() - t
    n = sum(p.numel() for p in model.parameters())
    gap = param_count_gap(model)
    if n != cfg.n_params() + sum(gap.values()):
        raise AssertionError(f"phase 15 (b) {cfg.name}: {n} parameters "
                             f"against n_params() {cfg.n_params()} + {gap}")
    toks = _lm_tokens(cfg, b, total, 17, device)
    model.cfg = dataclasses.replace(cfg, capacity_factor=MOE_CHECK_CF)
    _, aux = lm.hidden(model, {"tokens": toks}, with_aux=True)
    drop_at_check_cf = float(aux["moe_drop_frac"])
    model.cfg = cfg
    h, aux = lm.hidden(model, {"tokens": toks}, with_aux=True)
    if float(aux["moe_drop_frac"]) != 0.0:
        raise AssertionError(f"phase 15 (b): the forward dropped at cf "
                             f"{cfg.capacity_factor}")
    with torch.no_grad():
        full = lm.unembed(model, h[:, prompt - 1: total])
    del h
    logits, cache = lm.prefill(model, {"tokens": toks[:, :prompt]}, total)
    got = [logits]
    for i in range(steps):
        logits, cache = lm.decode_step(model, {"token": toks[:, prompt + i]},
                                       prompt + i, cache)
        got.append(logits)
    got = torch.stack(got, 1)
    del cache
    if not bool(torch.isfinite(got[..., : cfg.vocab]).all()):
        raise AssertionError(f"phase 15 (b) {cfg.name}: logits not finite")
    err = _held(got, full, DECODE_ATOL, DECODE_RTOL,
                f"15 (b) {cfg.name} decode against the full forward")
    with torch.no_grad():
        blk = lm.param_tree(model.dense_blocks[0])
        x, pos = lm.embed_inputs(model, {"tokens": toks})
        xn = lm.norm_apply(cfg, blk["norm1"], x)
        expanded = attention.mla_apply(blk["attn"], cfg, xn, pos)
        mcache = attention.mla_make_cache(cfg, b, total, torch.float32,
                                          device)
        attention.mla_prefill(blk["attn"], cfg, xn[:, :prompt],
                              pos[:, :prompt], mcache)
        absorbed = torch.cat([attention.mla_decode(
            blk["attn"], cfg, xn[:, prompt + i: prompt + i + 1], prompt + i,
            mcache)[0] for i in range(steps)], dim=1)
    mla_err = _held(absorbed, expanded[:, prompt:], DECODE_ATOL, DECODE_RTOL,
                    f"15 (b) {cfg.name} MLA absorbed decode against the "
                    f"expanded form")
    out = dict(config=cfg.name, n_layers=cfg.n_layers, params=n,
               n_params=cfg.n_params(), beyond_n_params=gap, init_s=init_s,
               device=str(model.device), batch=b, prompt=prompt,
               forward_len=total, steps=steps,
               capacity_factor=cfg.capacity_factor,
               drop_frac_at_cf_8=drop_at_check_cf, max_abs_err=err,
               mla_max_abs_err=mla_err)
    log(f"phase 15 (b) {cfg.name} cut to {cfg.n_layers} layers "
        f"({cfg.first_k_dense} dense + 1 MoE), f32 on {model.device}: "
        f"{n:,} parameters (n_params() {cfg.n_params():,} + "
        f"{sum(gap.values()):,}: {gap or 'nothing'}), drawn in "
        f"{init_s:.2f} s; B={b} x {prompt} prefill + {steps} decode steps "
        f"at capacity factor {cfg.capacity_factor:g} (nothing dropped; at "
        f"{MOE_CHECK_CF:g} the forward drops {drop_at_check_cf:.4f}) against "
        f"the full forward: max abs err {err:.3e}; the first layer's MLA, "
        f"absorbed decode against the expanded form: {mla_err:.3e} (atol "
        f"{DECODE_ATOL}, rtol {DECODE_RTOL})")
    del model, full, got
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def moe_bounds(model, b: int, prompt: int, steps: int) -> dict:
    """The least times of (c)'s work on the card (3.35 TB/s; 989 TFLOP/s
    bf16, 67 TFLOP/s f32), from the shapes the code runs.

    A decode step moves, each once: every block's weights as used (the
    GShard einsum runs every expert each step, on its one capacity slot a
    row; the router f32), the head in its stored dtype, and every layer's
    cache rows up to the step's position (MLA's compressed ``c_kv`` and
    ``k_rope``, or GQA's k/v) read, the new one written; its products (the
    experts' at one slot a row and expert) at the bf16 peak. The prefill
    computes in bf16 the blocks' dense products, every expert's FFN on its
    C slots a row (``group_capacity(prompt)``), the dispatch and combine
    einsums over (B, S, E, C) and the attention's probabilities times v,
    and in f32 the attention's scores (S x S a head, as the code writes
    them out) and the router; its bound is the largest of those two times
    and its weight bytes."""
    from repro_torch.models import lm, moe

    cfg = model.cfg
    cast = lm.cast_blocks(model)
    blocks = [blk for name in lm._stacks(model) for blk in cast[name]]
    head = model.embed.table if cfg.tie_embeddings else model.lm_head.w
    weight_bytes = sum(_nbytes(p) for p in blocks) + _nbytes(head)
    dt = lm.compute_dtype(cfg)
    elt = torch.finfo(dt).bits // 8
    mid = prompt + steps // 2
    row = (cfg.kv_lora_rank + cfg.qk_rope_head_dim if cfg.use_mla
           else 2 * cfg.n_kv_heads * cfg.head_dim) * b * elt
    cache_bytes = cfg.n_layers * row * (mid + 2)  # mid + 1 read, 1 written
    expert = 3 * cfg.d_model * cfg.moe_d_ff  # one expert's gated FFN
    n_moe = cfg.n_layers - cfg.first_k_dense
    routers = n_moe * cfg.d_model * cfg.n_experts
    dense = sum(_tree_sum(p, torch.Tensor.numel) for p in blocks) \
        - n_moe * cfg.n_experts * expert - routers
    decode_flops = 2 * b * (dense + n_moe * cfg.n_experts * expert)
    s, c = prompt, moe.group_capacity(prompt, cfg)
    if cfg.use_mla:
        qk, v = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    else:
        qk = v = cfg.head_dim
    scores = cfg.n_layers * 2 * b * cfg.n_heads * s * s * qk
    bf16_flops = (2 * b * s * dense
                  + n_moe * 2 * b * cfg.n_experts * c * expert
                  + n_moe * 2 * 2 * b * s * cfg.n_experts * c * cfg.d_model
                  + cfg.n_layers * 2 * b * cfg.n_heads * s * s * v)
    f32_flops = scores + 2 * b * s * routers
    prefill = dict(bf16_ms=bf16_flops / BF16_FLOPS * 1e3,
                   f32_ms=f32_flops / F32_FLOPS * 1e3,
                   bytes_ms=weight_bytes / HBM_BYTES_PER_S * 1e3)
    decode = dict(bytes_ms=(weight_bytes + cache_bytes)
                  / HBM_BYTES_PER_S * 1e3,
                  bf16_ms=decode_flops / BF16_FLOPS * 1e3)
    return dict(decode_bound_ms=max(decode.values()),
                decode_bound_by=max(decode, key=decode.get),
                decode_bytes=dict(weights=weight_bytes, cache=cache_bytes),
                prefill_bound_ms=max(prefill.values()),
                prefill_bound_by=max(prefill, key=prefill.get),
                prefill_bound_parts_ms=prefill,
                prefill_flops=dict(bf16=bf16_flops, f32=f32_flops),
                capacity=c, block_params=dense + n_moe * (
                    cfg.n_experts * expert) + routers)


def moe_generate_timed(arch: str, device, *, smoke: bool = False,
                       b: int = LM_BATCH, prompt: int = LM_PROMPT,
                       steps: int = LM_STEPS) -> dict:
    """(c) ``timed_generation`` of ``arch`` cut to ``moe_depth_cut``, in
    bf16 on bf16 parameters (``param_dtype="bfloat16"``; the router f32)
    at its own capacity factor, beside ``moe_bounds``; the prompt's
    ``moe_drop_frac`` from ``hidden``'s aux."""
    from repro_torch import configs
    from repro_torch.models import lm

    cfg = dataclasses.replace(
        moe_depth_cut(configs.get_config(arch, smoke=smoke)),
        param_dtype="bfloat16", dtype="bfloat16")
    model, out = timed_generation(cfg, device, b=b, prompt=prompt,
                                  steps=steps, phase="15 (c)")
    _, aux = lm.hidden(model, {"tokens": _lm_tokens(cfg, b, prompt, 19,
                                                    device)}, with_aux=True)
    out.update(moe_bounds(model, b, prompt, steps),
               n_layers=cfg.n_layers, param_dtype=cfg.param_dtype,
               capacity_factor=cfg.capacity_factor,
               params=sum(p.numel() for p in model.parameters()),
               moe_drop_frac=float(aux["moe_drop_frac"]),
               decode_kernels=out["profiles"]["decode_step"].get("launches"))
    parts = out["prefill_bound_parts_ms"]
    gb = {k: v / 1e9 for k, v in out["decode_bytes"].items()}
    log(f"phase 15 (c) {cfg.name} cut to {cfg.n_layers} layers, {cfg.dtype} "
        f"on {cfg.param_dtype} parameters ({out['params']:,}), capacity "
        f"factor {cfg.capacity_factor} (C={out['capacity']} a row in the "
        f"prefill; drop frac {out['moe_drop_frac']:.4f}), greedy_generate "
        f"B={b}, {prompt}-token prompt, {steps} steps (CUDA events): prefill "
        f"{out['prefill_ms']:.3f} ms, device {out['prefill_device_ms']:.3f} "
        f"ms (bound {out['prefill_bound_ms']:.3f} ms by "
        f"{out['prefill_bound_by']}: bf16 products {parts['bf16_ms']:.3f} ms "
        f"at 989 TFLOP/s, f32 scores and router {parts['f32_ms']:.3f} ms at "
        f"67 TFLOP/s, weights {parts['bytes_ms']:.3f} ms); decode step "
        f"median {out['decode_step_ms_median']:.3f} ms (min "
        f"{out['decode_step_ms_min']:.3f}, max {out['decode_step_ms_max']:.3f};"
        f" device {out['decode_step_device_ms']:.3f} ms, idle share "
        f"{out['decode_step_idle_share']:.3f}, {out['decode_kernels']} "
        f"kernels a step; bound {out['decode_bound_ms']:.3f} ms by "
        f"{out['decode_bound_by']}: weights {gb['weights']:.3f} GB, cache "
        f"{gb['cache']:.3f} GB at 3.35 TB/s); "
        f"{out['decode_tokens_per_s']:.1f} tokens/s a step, "
        f"{out['tokens_per_s']:.1f} tokens/s with the prefill; peak memory "
        f"{out['peak_memory_bytes'] / 2**30:.2f} GiB")
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def moe_phase(device, *, smoke: bool = False) -> dict:
    """Phase 15: (a) card against CPU on the ``deepseek-v3`` and ``kimi-k2``
    smoke configs, and the sharded MoE over four ``gloo`` ranks; (b)
    ``deepseek-v3-671b`` at full width cut to 4 layers in f32 (decode
    against the full forward, MLA's absorbed decode against its expanded
    form); (c) both archs cut to their dense prefix + 1 MoE block, timed
    greedy generation in bf16 on bf16 parameters. ``smoke`` runs (b)-(c)
    on the smoke configs at small sizes (a CPU rehearsal). Each model is
    freed before the next is drawn."""
    t = time.perf_counter()
    check = dict(b=2, prompt=16) if smoke else {}
    gen = dict(b=2, prompt=32, steps=6) if smoke else {}
    out = dict(parity=[moe_parity(a, device) for a in MOE_ARCHS],
               sharded=moe_sharded_check(device),
               decode_vs_forward=moe_decode_matches_forward(
                   device, smoke=smoke, **check),
               generate=[moe_generate_timed(a, device, smoke=smoke, **gen)
                         for a in MOE_ARCHS])
    out["seconds"] = time.perf_counter() - t
    log(f"phase 15 done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 16: LM training (the loss, remat, microbatches, the optimizers,
# checkpoints and the launcher)
# ---------------------------------------------------------------------------

TRAIN_SMOKE_ARCHS = ("stablelm-1.6b", "deepseek-v3-671b", "mamba2-370m",
                     "zamba2-2.7b")
TRAIN_SMOKE_PLANS = {  # (a): tests/test_torch_train_step.py's settings
    "adamw-f32": dict(optimizer="adamw", state_dtype="float32",
                      microbatches=1),
    "adamw-int8-mb2": dict(optimizer="adamw", state_dtype="int8",
                           microbatches=2),
    "adafactor-mb2": dict(optimizer="adafactor", microbatches=2),
}
TRAIN_SMOKE_STEPS, TRAIN_SMOKE_B, TRAIN_SMOKE_S = 3, 4, 32
TRAIN_ATOL = TRAIN_RTOL = 1e-4
# (a): Adam divides each element's moment by its own root second moment, so
# an element whose gradient sits at the float noise floor (a sum that
# cancels) moves by anything up to ±lr on either device, and an int8 code
# at a half quantum rounds either way; at most this share of a leaf may so
# differ, each element by at most the steps' summed learning rates
TRAIN_FLIP_SHARE = 1e-3
TRAIN_ARCH = "stablelm-1.6b"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 2048, 8
TRAIN_AGREE = 1e-2  # (b): the first step's loss and norm across settings
SSM_TRAIN_ARCH = "mamba2-370m"
SSM_TRAIN_B, SSM_TRAIN_S = 4, 512  # (c): a multiple of the SSD chunk 256
SSM_TRAIN_RTOL = 1e-4  # tests/test_checkpoint.py's resume tolerance


def _smoke_plan(name: str):
    from repro_torch.train.step import TrainPlan

    return TrainPlan(**TRAIN_SMOKE_PLANS[name], lr=1e-3, warmup=2,
                     total_steps=10)


def _train_batch(cfg, b: int, s: int, step: int, device) -> dict:
    from repro_torch.data.pipeline import BatchSpec, SyntheticLM
    from repro_torch.launch.train import _adapt_batch

    raw = SyntheticLM(BatchSpec(b, s, cfg.vocab), seed=0).batch_at(step)
    return _adapt_batch(cfg, raw, device)


def _held_flips(got, want, lr_sum: float, label: str) -> tuple:
    """``got`` within TRAIN_ATOL/RTOL of ``want`` (both on the host), but up
    to TRAIN_FLIP_SHARE of the elements within ``lr_sum``. -> (max abs
    err, the elements outside the tolerance)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    diff = (got - want).abs()
    off = diff > TRAIN_ATOL + TRAIN_RTOL * want.abs()
    n_off = int(off.sum())
    if n_off > TRAIN_FLIP_SHARE * max(want.numel(), 1) or (
            n_off and float(diff[off].max()) > lr_sum):
        raise AssertionError(
            f"phase {label}: {n_off} of {want.numel()} elements outside atol "
            f"{TRAIN_ATOL}, rtol {TRAIN_RTOL}, max abs err "
            f"{float(diff.max())} (learning rates {lr_sum})")
    return float(diff.max()), n_off


def train_parity(arch: str, plan_name: str, device) -> dict:
    """(a) One smoke config in f32, three ``make_train_step`` steps on the
    card and on the CPU from the same parameters and batches: every loss
    and metric within TRAIN_ATOL/RTOL, every parameter too (but the
    TRAIN_FLIP_SHARE of Adam's noise-floor elements)."""
    from repro_torch import configs
    from repro_torch.train import step as ts

    cfg = configs.get_config(arch, smoke=True)
    plan = _smoke_plan(plan_name)
    cpu, _ = ts.init_state(cfg, plan, seed=0, device="cpu")
    card = copy.deepcopy(cpu).to(device)
    ocfg, oinit, _ = ts._opt(plan)
    runs = {}
    for name, model in (("cpu", cpu), ("card", card)):
        fn = ts.make_train_step(cfg, plan)
        opt = oinit(dict(model.named_parameters()), ocfg)
        losses = []
        for i in range(TRAIN_SMOKE_STEPS):
            opt, m = fn(model, opt, _train_batch(
                cfg, TRAIN_SMOKE_B, TRAIN_SMOKE_S, i, model.device))
            losses.append({k: float(v) for k, v in m.items()})
        runs[name] = losses
    label = f"16 (a) {cfg.name} {plan_name}"
    loss_err = 0.0
    for c, d in zip(runs["cpu"], runs["card"]):
        for k in c:
            loss_err = max(loss_err, abs(d[k] - c[k]))
            if abs(d[k] - c[k]) > TRAIN_ATOL + TRAIN_RTOL * abs(c[k]):
                raise AssertionError(f"phase {label}: {k} card {d[k]} cpu "
                                     f"{c[k]}")
    sched = ocfg.lr
    lr_sum = 2 * sum(float(sched(torch.tensor(i + 1)))
                     for i in range(TRAIN_SMOKE_STEPS))
    param_err, flips = 0.0, 0
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        err, n = _held_flips(q, p, lr_sum, f"{label} {name}")
        param_err, flips = max(param_err, err), flips + n
    log(f"phase {label} f32, {TRAIN_SMOKE_STEPS} steps card against CPU: "
        f"loss and metrics max abs err {loss_err:.3e}, parameters "
        f"{param_err:.3e} ({flips} elements at Adam's noise floor)")
    return dict(arch=cfg.name, plan=plan_name, losses=runs["card"],
                loss_max_abs_err=loss_err, param_max_abs_err=param_err,
                noise_floor_elements=flips)


def train_bounds(model, b: int, s: int, *, remat: bool) -> dict:
    """The least time of one training step of ``model`` on ``b`` × ``s``
    tokens (989 TFLOP/s bf16, 67 TFLOP/s f32, 3.35 TB/s), counted as the
    code does the work: the blocks' products in bf16, 2·N·T forward, 4·N·T
    backward and with remat 2·N·T more (8·N·T), N the block parameters;
    the head's products in f32 (``unembed``), forward, the CE chunks'
    recompute and backward (8·T·D·V); the attention's scores in f32 over
    the full (S, S) square per head as the q-chunked code computes them,
    and its probabilities times v in bf16, each 2·B·H·S²·hd a pass, over
    the same passes as the blocks. Every term is linear in the batch, so
    microbatches do not change it."""
    cfg = model.cfg
    blocks = sum(p.numel() for p in model.blocks.parameters())
    t = b * s
    passes = 4 if remat else 3  # forward (+ recompute) + 2 backward
    attn = cfg.n_layers * 2 * b * cfg.n_heads * s * s * cfg.head_dim
    bf16 = 2 * passes * blocks * t + passes * attn
    head = 8 * t * cfg.d_model * cfg.vocab_padded
    f32 = head + passes * attn
    n = sum(p.numel() for p in model.parameters())
    by = dict(bf16_ms=bf16 / BF16_FLOPS * 1e3, f32_ms=f32 / F32_FLOPS * 1e3)
    return dict(bound_ms=max(by.values()), bound_by=max(by, key=by.get),
                bound_parts_ms=by, flops=dict(bf16=bf16, f32=f32, head=head,
                                              attention_pass=attn),
                block_params=blocks, params=n)


def train_full_width(device, *, smoke: bool = False, b: int = TRAIN_B,
                     s: int = TRAIN_S, steps: int = TRAIN_STEPS) -> dict:
    """(b) ``stablelm-1.6b`` at full width and depth, f32 parameters, bf16
    compute, its ``TRAIN_PLANS`` plan as ``launch.train`` assembles it
    (cosine schedule over the run): the first step's loss and gradient
    norm with remat against without (four microbatches) and one microbatch
    against four (remat), each within TRAIN_AGREE; then ``steps`` steps,
    every loss finite and the last below the first, timed with CUDA events
    and one profiled, beside ``train_bounds``; peak memory beside the
    parameters, gradients and moments."""
    from repro_torch import configs
    from repro_torch.launch.plans import TRAIN_PLANS
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as ts

    cfg = configs.get_config(TRAIN_ARCH, smoke=smoke)
    base = TRAIN_PLANS[TRAIN_ARCH]
    plan = ts.TrainPlan(microbatches=base.microbatches, remat=base.remat,
                        optimizer=base.optimizer,
                        state_dtype=base.state_dtype,
                        warmup=max(1, steps // 10), total_steps=steps)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    model, opt = ts.init_state(cfg, plan, seed=0, device=device)
    gap = param_count_gap(model)
    n_model = sum(p.numel() for p in model.parameters())
    if n_model - sum(gap.values()) != cfg.n_params():
        raise AssertionError(f"phase 16 (b): {n_model} parameters, "
                             f"n_params() {cfg.n_params()}, gap {gap}")
    batches = [_train_batch(cfg, b, s, i, device) for i in range(steps)]
    first, peaks = {}, {}
    for name, over in (("no remat, 4 microbatches", dict(remat=False)),
                       ("remat, 4 microbatches", {}),
                       ("remat, 1 microbatch", dict(microbatches=1))):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        loss, _, grads = ts.accumulate_grads(
            model, batches[0], dataclasses.replace(plan, **over))
        first[name] = dict(loss=float(loss),
                           grad_norm=float(topt.global_norm(grads)))
        del grads
        if device.type == "cuda":
            peaks[name] = torch.cuda.max_memory_allocated() - resident
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    want = first["remat, 4 microbatches"]
    for name, got in first.items():
        for k in ("loss", "grad_norm"):
            if abs(got[k] - want[k]) > TRAIN_AGREE * abs(want[k]):
                raise AssertionError(f"phase 16 (b): the first step's {k} "
                                     f"{got[k]} ({name}) against {want[k]}")
    fn = ts.make_train_step(cfg, plan)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)] \
        if device.type == "cuda" else []
    losses = []
    for i, batch in enumerate(batches):
        if ev:
            ev[i].record()
        opt, m = fn(model, opt, batch)
        if ev:
            ev[i + 1].record()
        losses.append(m["loss"])
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"phase 16 (b): losses {losses}")
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)] \
        if ev else []
    peak = (torch.cuda.max_memory_allocated() - resident
            if device.type == "cuda" else 0)
    state = dict(
        params=sum(p.numel() * p.element_size() for p in model.parameters()),
        grads_f32=4 * n_model,
        moments=_nbytes(opt["m"]) + _nbytes(opt["v"]))
    out = dict(config=cfg.name, dtype=cfg.dtype, plan=dataclasses.asdict(plan),
               batch=b, seq=s, n_params=cfg.n_params(),
               first_step=first, losses=losses, step_ms=step_ms,
               peak_memory_bytes=peak, first_step_peak_bytes=peaks,
               state_bytes=state,
               **train_bounds(model, b, s, remat=plan.remat))
    if device.type == "cuda":
        med = float(np.median(step_ms))
        out.update(step_ms_median=med, tokens_per_s=b * s * 1e3 / med)
        gb = {k: v / 1e9 for k, v in state.items()}
        parts = out["bound_parts_ms"]
        log(f"phase 16 (b) {cfg.name} f32 parameters, {cfg.dtype} compute, "
            f"B={b} x {s}, {plan.microbatches} microbatches, remat "
            f"{plan.remat}, {plan.state_dtype} first moment: {n_model} "
            f"parameters; first step loss/grad norm {first}; losses "
            f"{[round(x, 4) for x in losses]}; step (CUDA events) median "
            f"{med:.1f} ms (min {min(step_ms):.1f}, max {max(step_ms):.1f}); "
            f"bound {out['bound_ms']:.1f} ms by "
            f"{out['bound_by']} (bf16 blocks and attention "
            f"{parts['bf16_ms']:.1f} ms at 989 TFLOP/s, f32 head and scores "
            f"{parts['f32_ms']:.1f} ms at 67 TFLOP/s); "
            f"{out['tokens_per_s']:.0f} tokens/s; peak memory of the "
            f"{steps} steps {peak / 1e9:.2f} GB (first steps: "
            + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in peaks.items())
            + f" GB) beside parameters {gb['params']:.2f} GB, "
            f"f32 gradients {gb['grads_f32']:.2f} GB, moments "
            f"{gb['moments']:.2f} GB")
    return out


def ssm_train_cli(device, *, smoke: bool = False, b: int = SSM_TRAIN_B,
                  s: int = SSM_TRAIN_S) -> dict:
    """(c) ``mamba2-370m`` at full width through ``launch.train.main``
    (f32 parameters, bf16 compute): every gradient leaf of the first step
    finite (the SSD scan's mask before its exp); four steps straight
    against two, a checkpoint and two resumed, steps 3-4's losses within
    SSM_TRAIN_RTOL; the checkpoint's bytes and its save and restore
    seconds."""
    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train
    from repro_torch.launch.plans import TRAIN_PLANS
    from repro_torch.train import step as ts

    cfg = configs.get_config(SSM_TRAIN_ARCH, smoke=smoke)
    dev = str(device)
    base = ["--arch", SSM_TRAIN_ARCH, "--global-batch", str(b), "--seq-len",
            str(s), "--log-every", "1", "--device", dev] + (
        ["--smoke"] if smoke else [])
    plan = TRAIN_PLANS[SSM_TRAIN_ARCH]
    plan = ts.TrainPlan(remat=plan.remat, state_dtype=plan.state_dtype,
                        warmup=1, total_steps=4)
    model, opt = ts.init_state(cfg, plan, seed=0, device=device)
    _, _, grads = ts.accumulate_grads(model, _train_batch(cfg, b, s, 0,
                                                          device), plan)
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    if bad:
        raise AssertionError(f"phase 16 (c): non-finite gradients in {bad}")
    del grads
    timing = {}
    if device.type == "cuda":  # one step timed, warm
        fn = ts.make_train_step(cfg, plan)
        batch = _train_batch(cfg, b, s, 0, device)
        opt, _ = fn(model, opt, batch)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        opt, _ = fn(model, opt, batch)
        ev[1].record()
        torch.cuda.synchronize()
        timing = dict(step_ms=ev[0].elapsed_time(ev[1]))
    with tempfile.TemporaryDirectory() as d:
        straight = train.main(base + ["--steps", "4"])
        legs = train.main(base + ["--steps", "2", "--schedule-total", "4",
                                  "--ckpt", d, "--ckpt-every", "2"])
        resumed = train.main(base + ["--steps", "4", "--ckpt", d,
                                     "--ckpt-every", "2"])
        ck_bytes = sum(f.stat().st_size
                       for f in pathlib.Path(d, "step_00000002").iterdir())
        tree = {"params": dict(model.named_parameters()), "opt": opt}
        if device.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        ckpt.save(f"{d}/timed", 1, tree)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        _, back, _ = ckpt.restore(f"{d}/timed", like=tree)
        if device.type == "cuda":
            torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
    if not all(np.isfinite(straight)) or len(resumed) != 2:
        raise AssertionError(f"phase 16 (c): straight {straight}, resumed "
                             f"{resumed}")
    if not np.allclose(legs, straight[:2], rtol=SSM_TRAIN_RTOL, atol=0) or \
            not np.allclose(resumed, straight[2:], rtol=SSM_TRAIN_RTOL,
                            atol=0):
        raise AssertionError(f"phase 16 (c): straight {straight}, legs "
                             f"{legs} + resumed {resumed}")
    for k, v in dict(model.named_parameters()).items():
        if not torch.equal(back["params"][k], v):
            raise AssertionError(f"phase 16 (c): {k} restored unequal")
    out = dict(config=cfg.name, dtype=cfg.dtype, batch=b, seq=s,
               straight=straight, legs=legs, resumed=resumed,
               resume_max_rel_err=float(np.max(np.abs(
                   np.subtract(resumed, straight[2:]))
                   / np.abs(straight[2:]))),
               checkpoint_bytes=ck_bytes, save_s=save_s,
               restore_s=restore_s, **timing)
    log(f"phase 16 (c) {cfg.name} through launch.train.main, B={b} x {s}: "
        f"first-step gradients finite; losses straight "
        f"{[round(x, 5) for x in straight]}, resumed steps 3-4 "
        f"{[round(x, 5) for x in resumed]} (max rel err "
        f"{out['resume_max_rel_err']:.2e}, rtol {SSM_TRAIN_RTOL}); "
        f"checkpoint {ck_bytes / 1e9:.3f} GB, save {save_s:.2f} s, restore "
        f"{restore_s:.2f} s (warm page cache)"
        + (f"; a step {timing['step_ms']:.1f} ms (CUDA events)"
           if timing else ""))
    return out


def train_phase(device, *, smoke: bool = False) -> dict:
    """Phase 16: (a) card against CPU on the four smoke configs under the
    three optimizer settings, (b) ``stablelm-1.6b`` at full width, (c)
    ``mamba2-370m`` at full width through the launcher. ``smoke`` runs
    (b) and (c) on the smoke configs at small sizes (a CPU rehearsal)."""
    t = time.perf_counter()
    out = dict(parity=[train_parity(a, p, device) for a in TRAIN_SMOKE_ARCHS
                       for p in TRAIN_SMOKE_PLANS])
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["full_width"] = train_full_width(
        device, smoke=smoke, **(dict(b=4, s=32, steps=8) if smoke else {}))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["ssm_cli"] = ssm_train_cli(
        device, smoke=smoke, **(dict(b=4, s=32) if smoke else {}))
    out["seconds"] = time.perf_counter() - t
    log(f"phase 16 done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: the mesh-sharded LM step, the GPipe pipeline and the dry-run
# ---------------------------------------------------------------------------

MESH17 = (2, 2)  # (a): (data, model) over four gloo ranks sharing the card
MESH17_CASES = {  # (a): tests/test_torch_mesh_train.py's cases
    "stablelm-adamw-f32": ("stablelm-1.6b", 8, dict(
        optimizer="adamw", state_dtype="float32", microbatches=1), {}),
    "stablelm-adamw-int8-mb2": ("stablelm-1.6b", 8, dict(
        optimizer="adamw", state_dtype="int8", microbatches=2), {}),
    "deepseek-sharded": ("deepseek-v3-671b", 2, dict(
        optimizer="adamw", state_dtype="float32", microbatches=1),
        {"moe_impl": "sharded"}),
    "mamba2-adamw-f32": ("mamba2-370m", 4, dict(
        optimizer="adamw", state_dtype="float32", microbatches=1), {}),
    "zamba2-adamw-f32": ("zamba2-2.7b", 4, dict(
        optimizer="adamw", state_dtype="float32", microbatches=1), {}),
}
MESH17_STEPS, MESH17_S = 2, 32
MESH17_PLAN = dict(lr=1e-3, warmup=2, total_steps=10, remat=False)
PIPE_STAGES, PIPE_MB, PIPE_S = 4, 8, 16  # (c): one smoke block a stage
PIPE_TOL = 1e-5
FULL17_STEPS = 3  # (b): steps of the DTensor step at full width
FIRST_LOSS_RTOL = 1e-3  # (b): its first loss against 16 (b)'s
PEAK_GAP = 0.15  # (d): predicted peak within this share of the measured
DRYRUN_CELLS = (("stablelm-1.6b", "train_4k"),
                ("deepseek-v3-671b", "decode_32k"))
# (d) also runs ``launch.dryrun.WITNESS_CELLS``: the smallest cells that
# gave each error the card's torch raised in the production cells
DRYRUN_TIMEOUT_S = 600


def _mesh17(case: str):
    from repro_torch import configs
    from repro_torch.train import step as ts

    arch, b, plan, over = MESH17_CASES[case]
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True), **over)
    return cfg, ts.TrainPlan(**plan, **MESH17_PLAN), b


def mesh17_rank(rank: int, store: str, payload: dict, out_path: str) -> None:
    """One rank of phase 17 (a), in its own process (``payload["device"]``
    holds its tensors): each case's model from seed 0, placed on the
    (data, model) mesh by
    ``train.step.shard_state``, ``MESH17_STEPS`` steps of
    ``make_train_step(batch_axes=("data",))`` under ``with_act_axes``, the
    last under ``launch.dryrun.DeviceCounter`` (the collectives' count and
    bytes by kind; torch's ``CommDebugMode`` counts the same operations
    but its module tracker raises on the norm modules the functional
    model calls)."""
    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.dryrun import DeviceCounter
    from repro_torch.models import lm, sharding
    from repro_torch.train import step as ts

    card = payload["device"]
    if card == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    with process_group("gloo", store, rank=rank,
                       world=MESH17[0] * MESH17[1]):
        mesh = init_device_mesh(card, MESH17,
                                mesh_dim_names=("data", "model"))
        for case in payload["cases"]:
            cfg, plan, b = _mesh17(case)
            model, opt = ts.shard_state(lm.LM(cfg, seed=0, device=card),
                                        plan, mesh)
            fn = sharding.with_act_axes(
                ts.make_train_step(cfg, plan, batch_axes=("data",)), "data",
                mesh=mesh)
            losses, ms = [], []
            for i in range(MESH17_STEPS):
                batch = _train_batch(cfg, b, MESH17_S, i, card)
                placed = sharding.place_tree(
                    batch, sharding.batch_specs(cfg, batch), mesh)
                if card == "cuda":
                    torch.cuda.synchronize()
                t = time.perf_counter()
                if i == MESH17_STEPS - 1:
                    with DeviceCounter() as dc:
                        opt, m = fn(model, opt, placed)
                else:
                    opt, m = fn(model, opt, placed)
                if card == "cuda":
                    torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
                losses.append({k: float(v.full_tensor())
                               for k, v in m.items()})
            params = {k: v.full_tensor().detach().cpu()
                      for k, v in model.named_parameters()}
            out[case] = dict(losses=losses, ms=ms, params=params,
                             collective_bytes=dc.report()["collectives"])
    if rank == 0:
        torch.save(out, out_path)


def mesh17_one_process(cases, device) -> dict:
    """(a)'s cases in this process, no mesh: the same steps."""
    from repro_torch.models import lm
    from repro_torch.train import step as ts

    out = {}
    for case in cases:
        cfg, plan, b = _mesh17(case)
        # the ranks' draws: the host generator's, then on ``device``
        model = lm.LM(cfg, seed=0, device="cpu").to(device)
        ocfg, oinit, _ = ts._opt(plan)
        opt = oinit(dict(model.named_parameters()), ocfg)
        fn = ts.make_train_step(cfg, plan)
        losses, ms = [], []
        for i in range(MESH17_STEPS):
            batch = _train_batch(cfg, b, MESH17_S, i, device)
            if device.type == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            opt, m = fn(model, opt, batch)
            losses.append({k: float(v) for k, v in m.items()})
            ms.append((time.perf_counter() - t) * 1e3)
        out[case] = dict(losses=losses, ms=ms, params={
            k: v.detach().cpu() for k, v in model.named_parameters()})
    return out


def check_mesh17(mesh: dict, one: dict) -> dict:
    """(a)'s check: every loss and metric of every step within
    TRAIN_ATOL/RTOL of the one-process step's (the sharded MoE's
    ``moe_drop_frac`` is data shard 0's, so not held), every parameter too
    (but TRAIN_FLIP_SHARE of a leaf at Adam's noise floor within the
    steps' summed learning rates). -> max abs errs by case."""
    from repro_torch.train import step as ts

    errs = {}
    for case, got in mesh.items():
        want = one[case]
        label = f"17 (a) {case}"
        loss_err = 0.0
        for g, w in zip(got["losses"], want["losses"], strict=True):
            for k, v in w.items():
                if k == "moe_drop_frac" and "sharded" in case:
                    continue
                loss_err = max(loss_err, abs(g[k] - v))
                if abs(g[k] - v) > TRAIN_ATOL + TRAIN_RTOL * abs(v):
                    raise AssertionError(f"phase {label}: {k} mesh {g[k]} "
                                         f"one process {v}")
        _, plan, _ = _mesh17(case)
        sched = ts._opt(plan)[0].lr
        lr_sum = 2 * sum(float(sched(torch.tensor(i + 1)))
                         for i in range(MESH17_STEPS))
        param_err = 0.0
        for k, w in want["params"].items():
            err, _ = _held_flips(got["params"][k], w, lr_sum,
                                 f"{label} {k}")
            param_err = max(param_err, err)
        errs[case] = dict(loss=loss_err, params=param_err)
    return errs


def mesh17_train(device, cases=tuple(MESH17_CASES)) -> dict:
    """(a) The mesh training step over four ``gloo`` ranks (``MESH17``)
    against the same steps in this process on ``device`` (the card, TF32
    off): losses and parameters within 1e-4 (``check_mesh17``); the last
    step's collectives by kind and bytes, and its ms beside the
    one-process step's. The ranks' DTensors lie on the host: four ranks
    share the one card only over ``gloo``, and torch 2.11's functional
    collectives (DTensor's) over ``gloo`` on CUDA tensors end the process
    with a segmentation fault (a four-rank probe on the card); the
    one-rank NCCL mesh of (b) runs DTensors on the card."""
    world = MESH17[0] * MESH17[1]
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=mesh17_rank, args=(
            r, f"{d}/store", dict(device="cpu", cases=cases),
            f"{d}/mesh.pt")) for r in range(world)]
        t0 = time.perf_counter()
        for pr in procs:
            pr.start()
        try:
            one = mesh17_one_process(cases, device)
            for pr in procs:
                pr.join(timeout=5 * MESH_TIMEOUT_S)
        finally:
            for pr in procs:
                if pr.is_alive():
                    pr.terminate()
                    pr.join()
        wall = time.perf_counter() - t0
        codes = [pr.exitcode for pr in procs]
        if any(c != 0 for c in codes):
            raise AssertionError(f"phase 17 (a): rank exit codes {codes}")
        mesh = torch.load(f"{d}/mesh.pt", weights_only=False)
    errs = check_mesh17(mesh, one)
    out = {}
    for case in cases:
        got, want = mesh[case], one[case]
        coll = got["collective_bytes"]
        out[case] = dict(losses=got["losses"], mesh_ms=got["ms"],
                         one_process_ms=want["ms"], errors=errs[case],
                         collective_bytes=coll)
        log(f"phase 17 (a) {case} on a {MESH17[0]}x{MESH17[1]} mesh of "
            f"{world} gloo ranks (host tensors), against one process on "
            f"the {device.type}: "
            f"losses max abs err {errs[case]['loss']:.3e}, parameters "
            f"{errs[case]['params']:.3e}; step {MESH17_STEPS}: "
            f"{got['ms'][-1]:.1f} ms on the mesh (under the counters) "
            f"beside {want['ms'][-1]:.1f} ms in one process (first steps "
            f"{got['ms'][0]:.1f} / {want['ms'][0]:.1f} ms); collectives "
            + ", ".join(f"{k} x{coll['counts'][k]} {coll[k]} B"
                        for k in coll["counts"] if coll["counts"][k]))
    return dict(cases=out, wall_s=wall, ranks=world, mesh=list(MESH17))


def mesh17_full_width(device, *, smoke: bool = False, b: int = TRAIN_B,
                      s: int = TRAIN_S, steps: int = FULL17_STEPS) -> dict:
    """(b) 16 (b)'s step (``stablelm-1.6b``, its plan, B x S tokens of
    ``SyntheticLM(seed=0)``) as DTensors on a one-rank NCCL (1, 1) mesh
    (``gloo`` off the card): the first step's loss (held to 16 (b)'s plain
    first step by the caller), the steps' ms (CUDA events), and the peak
    memory of a warm step above what was allocated before the model
    (``max_memory_allocated``), for (d)'s prediction."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import configs
    from repro_torch.launch.plans import TRAIN_PLANS
    from repro_torch.models import sharding
    from repro_torch.train import step as ts

    cfg = configs.get_config(TRAIN_ARCH, smoke=smoke)
    base = TRAIN_PLANS[TRAIN_ARCH]
    plan = ts.TrainPlan(microbatches=base.microbatches, remat=base.remat,
                        optimizer=base.optimizer,
                        state_dtype=base.state_dtype,
                        warmup=max(1, TRAIN_STEPS // 10),
                        total_steps=TRAIN_STEPS)
    cuda = device.type == "cuda"
    with tempfile.TemporaryDirectory() as d, process_group(
            "nccl" if cuda else "gloo", f"{d}/store"):
        mesh = init_device_mesh(device.type, (1, 1),
                                mesh_dim_names=("data", "model"))
        if cuda:
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
        model, opt = ts.init_state(cfg, plan, seed=0, device=device,
                                   mesh=mesh)
        fn = sharding.with_act_axes(
            ts.make_train_step(cfg, plan, batch_axes=("data",)), "data",
            mesh=mesh)
        losses, ms, peak = [], [], 0
        for i in range(steps):
            batch = _train_batch(cfg, b, s, i, device)
            placed = sharding.place_tree(
                batch, sharding.batch_specs(cfg, batch), mesh)
            if cuda:
                torch.cuda.synchronize()
                if i == 1:
                    torch.cuda.reset_peak_memory_stats()
                ev = [torch.cuda.Event(enable_timing=True) for _ in (0, 1)]
                ev[0].record()
            opt, m = fn(model, opt, placed)
            if cuda:
                ev[1].record()
                torch.cuda.synchronize()
                ms.append(ev[0].elapsed_time(ev[1]))
                if i == 1:
                    peak = torch.cuda.max_memory_allocated() - resident
            losses.append(float(m["loss"].full_tensor()))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"phase 17 (b): losses {losses}")
    out = dict(config=cfg.name, batch=b, seq=s, plan=dataclasses.asdict(plan),
               losses=losses, step_ms=ms, warm_step_peak_bytes=peak)
    if ms:
        out["step_ms_median"] = float(np.median(ms[1:]))
    log(f"phase 17 (b) {cfg.name} as DTensors on a one-rank "
        f"{'NCCL' if cuda else 'gloo'} (1, 1) mesh, B={b} x {s}: losses "
        f"{[round(x, 4) for x in losses]}"
        + (f"; steps {[round(x, 1) for x in ms]} ms (CUDA events), median "
           f"after the first {out['step_ms_median']:.1f} ms; a warm step's "
           f"peak {peak / 1e9:.3f} GB above the card's use before the "
           f"model" if ms else ""))
    return out


def check_first_loss(mesh_loss: float, plain_loss: float) -> float:
    """(b)'s check: the mesh step's first loss within FIRST_LOSS_RTOL of
    16 (b)'s plain first step. -> the relative gap."""
    gap = abs(mesh_loss - plain_loss) / abs(plain_loss)
    if gap > FIRST_LOSS_RTOL:
        raise AssertionError(f"phase 17 (b): first loss {mesh_loss} against "
                             f"16 (b)'s {plain_loss} (rel {gap:.2e})")
    return gap


def _pipe_cfg():
    from repro_torch import configs

    return dataclasses.replace(configs.get_config(TRAIN_ARCH, smoke=True),
                               n_layers=PIPE_STAGES)


def _pipe_x(d_model: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(37).normal(
        size=(PIPE_MB, 1, PIPE_S, d_model)).astype(np.float32))


def pipe17_rank(rank: int, store: str, payload: dict, out_path: str) -> None:
    """One stage of phase 17 (c): ``distributed.pipeline.pipeline_apply``
    over a ``("stage",)`` mesh of four ``gloo`` ranks on the shared card,
    the stacked smoke blocks sharded over it; each stage's busy seconds
    (its blocks) beside the loop's."""
    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.models import lm

    card = payload["device"]
    if card == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _pipe_cfg()
    busy = [0.0]
    with process_group("gloo", store, rank=rank, world=PIPE_STAGES):
        mesh = init_device_mesh(card, (PIPE_STAGES,),
                                mesh_dim_names=("stage",))
        staged = {k: distribute_tensor(v.to(card), mesh, [Shard(0)],
                                       src_data_rank=None)
                  for k, v in payload["stacked"].items()}
        positions = torch.arange(PIPE_S, dtype=torch.int32,
                                 device=card).expand(1, PIPE_S)

        def stage_fn(p, x):
            t = time.perf_counter()
            y = lm._block_prefill(_nest(p), cfg, x, positions, None)[0]
            if card == "cuda":
                torch.cuda.synchronize()
            busy[0] += time.perf_counter() - t
            return y

        fn = pipeline_apply(mesh, "stage", stage_fn, PIPE_MB)
        t = time.perf_counter()
        with torch.no_grad():
            out = fn(staged, _pipe_x(cfg.d_model).to(card)).to_local()
        loop = time.perf_counter() - t
    torch.save(dict(out=out.cpu(), handoff=fn.handoff, busy_s=busy[0],
                    loop_s=loop), out_path)


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        node = out
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def check_pipe17(outs: list, want: torch.Tensor) -> float:
    """(c)'s check: every stage's output within PIPE_TOL of the blocks
    applied in turn. -> max abs err."""
    return max(_held(o, want, PIPE_TOL, PIPE_TOL, f"17 (c) stage {r}")
               for r, o in enumerate(outs))


def pipe17_check(device) -> dict:
    """(c) ``pipeline_apply`` over four ``gloo`` ranks on the card against
    the four blocks applied in turn: the hand-off path, the ticks, and the
    measured idle share of a stage beside ``bubble(4, 8)``."""
    from repro_torch.distributed.pipeline import bubble
    from repro_torch.models import lm

    cfg = _pipe_cfg()
    model = lm.LM(cfg, seed=0, device="cpu")
    stacked = {k: torch.stack([dict(b.named_parameters())[k].detach()
                               for b in model.blocks])
               for k, _ in model.blocks[0].named_parameters()}
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=pipe17_rank, args=(
            r, f"{d}/store", dict(device=device.type, stacked=stacked),
            f"{d}/stage{r}.pt")) for r in range(PIPE_STAGES)]
        for pr in procs:
            pr.start()
        try:
            for pr in procs:
                pr.join(timeout=3 * MESH_TIMEOUT_S)
        finally:
            for pr in procs:
                if pr.is_alive():
                    pr.terminate()
                    pr.join()
        codes = [pr.exitcode for pr in procs]
        if any(c != 0 for c in codes):
            raise AssertionError(f"phase 17 (c): stage exit codes {codes}")
        got = [torch.load(f"{d}/stage{r}.pt", weights_only=False)
               for r in range(PIPE_STAGES)]
    model = model.to(device)
    x = _pipe_x(cfg.d_model).to(device)
    positions = torch.arange(PIPE_S, dtype=torch.int32,
                             device=device).expand(1, PIPE_S)
    with torch.no_grad():
        seq = []
        for mb in x:
            y = mb
            for block in model.blocks:
                y = lm._block_prefill(lm.param_tree(block), cfg, y,
                                      positions, None)[0]
            seq.append(y)
    err = check_pipe17([g["out"] for g in got], torch.stack(seq))
    idle = [1.0 - g["busy_s"] / g["loop_s"] for g in got]
    ticks = PIPE_MB + PIPE_STAGES - 1
    out = dict(handoff=got[0]["handoff"], ticks=ticks, max_abs_err=err,
               bubble=bubble(PIPE_STAGES, PIPE_MB), idle_share=idle,
               loop_s=[g["loop_s"] for g in got])
    log(f"phase 17 (c) pipeline_apply over {PIPE_STAGES} gloo stages on "
        f"the card, {PIPE_MB} microbatches, {ticks} ticks, hand-off through "
        f"the {out['handoff']}: against the blocks in turn max abs err "
        f"{err:.3e} (tol {PIPE_TOL}); idle share of each stage's loop "
        f"{[round(v, 3) for v in idle]} beside bubble({PIPE_STAGES}, "
        f"{PIPE_MB}) = {out['bubble']:.3f} (the rest of the idle time is "
        f"the host hand-off)")
    return out


def dryrun_child(out_path: str, device_type: str = "cuda",
                 smoke: bool = False) -> None:
    """(d), in a process of its own (the fake world is its default
    process group): the ``DRYRUN_CELLS`` on 16×16, the witness cells
    (``dryrun.WITNESS_CELLS``, smoke configs on small meshes), each of
    which must give a whole record, ``dryrun_boomhq``'s C0–C2, and 16
    (b)'s step on a (1, 1) mesh; each record and its seconds, as JSON to
    ``out_path``. ``smoke``: the ``DRYRUN_CELLS``' smoke configs at a
    small size on a (2, 2) mesh (a CPU rehearsal)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun, dryrun_boomhq
    from repro_torch.launch.plans import TRAIN_PLANS

    small = dict(global_batch=16, seq_len=64) if smoke else None
    cells = []
    for arch, shape in DRYRUN_CELLS:
        t = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, device_type=device_type,
                              smoke=smoke, shape_overrides=small,
                              mesh_shape=(2, 2) if smoke else None)
        cells.append(dict(rec, seconds=time.perf_counter() - t))
    for cell in dryrun.WITNESS_CELLS:
        t = time.perf_counter()
        rec = dryrun.run_witness(cell, device_type=device_type,
                                 verbose=False)
        cells.append(dict(check_witness(rec, cell),
                          seconds=time.perf_counter() - t))
    boomhq = [dryrun_boomhq.run_variant(
        name, rows_per_dev=4096 if smoke else 1_048_576,
        device_type=device_type, **kw) for name, kw in dryrun_boomhq.VARIANTS]
    b, s = (8, 32) if smoke else (TRAIN_B, TRAIN_S)
    base = TRAIN_PLANS[TRAIN_ARCH]
    t = time.perf_counter()
    step = dryrun.run_cell(
        TRAIN_ARCH, "train_4k", mesh_shape=(1, 1), device_type=device_type,
        smoke=smoke, shape_overrides=dict(global_batch=b, seq_len=s),
        plan_overrides=dict(microbatches=base.microbatches,
                            warmup=max(1, TRAIN_STEPS // 10),
                            total_steps=TRAIN_STEPS))
    step["seconds"] = time.perf_counter() - t
    pathlib.Path(out_path).write_text(json.dumps(dict(
        cells=cells, boomhq=boomhq, train_step_1x1=step)))


def check_witness(rec: dict, cell: dict) -> dict:
    """(d)'s check of a witness cell: a whole record (the step ran: FLOPs,
    bytes and a peak above its arguments). -> the record."""
    if "skipped" in rec or not (rec.get("flops_per_dev", 0) > 0
                                and rec.get("bytes_per_dev", 0) > 0
                                and rec.get("peak_bytes_per_dev", 0)
                                >= rec.get("arg_bytes_per_dev", 1) > 0):
        raise AssertionError(f"phase 17 (d): witness {rec.get('tag')} "
                             f"(before the repair: {cell['refused']}) gave "
                             f"no whole record: {rec}")
    return rec


@contextlib.contextmanager
def dryrun_child_process(*, device_type: str = "cuda", smoke: bool = False):
    """``dryrun_child`` in a fresh Python process, started on entry (it
    needs the host only, so (a)–(c) run beside it); ``result()`` of the
    yielded handle waits for it. -> its records."""
    with tempfile.TemporaryDirectory() as d:
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "import chip_smoke; chip_smoke.dryrun_child(sys.argv[2], "
                "sys.argv[3], sys.argv[4] == '1')")
        t = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-c", code, str(ROOT),
                                 f"{d}/dryrun.json", device_type,
                                 "1" if smoke else "0"], cwd=ROOT)

        def result() -> dict:
            code = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S - (
                time.perf_counter() - t)))
            if code != 0:
                raise AssertionError(f"phase 17 (d): the dry-run exited "
                                     f"{code}")
            res = json.loads(pathlib.Path(f"{d}/dryrun.json").read_text())
            res["wall_s"] = time.perf_counter() - t
            return res

        try:
            yield result
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def check_peak(predicted: float, measured: float) -> float:
    """(d)'s memory check: the dry-run's predicted peak within PEAK_GAP of
    the card's measured one. -> the signed relative gap."""
    gap = (predicted - measured) / measured
    if abs(gap) > PEAK_GAP:
        raise AssertionError(f"phase 17 (d): predicted peak {predicted} B "
                             f"against the card's {measured} B "
                             f"({100 * gap:+.1f}%)")
    return gap


def mesh17_checks(p16: dict, p17: dict) -> dict:
    """Phase 17 (b) against 16 (b): the first loss (``check_first_loss``)
    and the step's ms; (d)'s predicted peak of that step against (b)'s
    measured one (``check_peak``), beside 16 (b)'s."""
    fw, plain = p17["full_width"], p16["full_width"]
    first = plain["first_step"]["remat, 4 microbatches"]["loss"]
    loss_gap = check_first_loss(fw["losses"][0], first)
    pred = p17["dryrun"]["train_step_1x1"]["peak_bytes_per_dev"]
    peak_gap = check_peak(pred, fw["warm_step_peak_bytes"])
    log(f"phase 17 (b) against 16 (b): first loss {fw['losses'][0]:.6f} "
        f"beside {first:.6f} (rel gap {loss_gap:.2e}, tol "
        f"{FIRST_LOSS_RTOL}); step median {fw.get('step_ms_median', 0):.1f} "
        f"ms on the (1, 1) mesh beside {plain.get('step_ms_median', 0):.1f}"
        f" ms plain; (d) predicted peak {pred / 1e9:.3f} GB beside the "
        f"card's {fw['warm_step_peak_bytes'] / 1e9:.3f} GB on the mesh "
        f"({100 * peak_gap:+.1f}%, tol ±{100 * PEAK_GAP:.0f}%) and 16 (b)'s "
        f"{plain.get('peak_memory_bytes', 0) / 1e9:.3f} GB plain")
    return dict(first_loss=fw["losses"][0], plain_first_loss=first,
                first_loss_rel_gap=loss_gap, predicted_peak_bytes=pred,
                measured_peak_bytes=fw["warm_step_peak_bytes"],
                peak_gap=peak_gap,
                mesh_step_ms_median=fw.get("step_ms_median"),
                plain_step_ms_median=plain.get("step_ms_median"))


def mesh17_phase(device, *, smoke: bool = False) -> dict:
    """Phase 17: (a) the mesh step over four ``gloo`` ranks, (b) the
    DTensor step at full width on one NCCL rank, (c) the pipeline, (d)
    the dry-run in its own process (checked against (b)'s peak by the
    caller, beside 16 (b)'s figures), started first and run beside (a)–(c)
    (it needs the host only). ``smoke`` runs (b) and (d) on the smoke
    configs (a CPU rehearsal)."""
    t = time.perf_counter()
    with dryrun_child_process(device_type=device.type,
                              smoke=smoke) as dryrun_result:
        out = dict(mesh_step=mesh17_train(device))
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out["full_width"] = mesh17_full_width(
            device, smoke=smoke, **(dict(b=8, s=32) if smoke else {}))
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out["pipeline"] = pipe17_check(device)
        out["dryrun"] = dryrun_result()
    for rec in out["dryrun"]["cells"] + [out["dryrun"]["train_step_1x1"]]:
        log(f"phase 17 (d) dry-run prediction [{rec['arch']} × "
            f"{rec['shape']} × {rec['mesh']}]: flops/dev "
            f"{rec['flops_per_dev']:.3e}, bytes/dev {rec['bytes_per_dev']:.3e}"
            f", collectives/dev {rec['collectives']['total']:.3e} B "
            f"{rec['collectives']['counts']}, peak {rec['peak_hbm_gib']:.2f} "
            f"GiB, compute {rec['compute_s'] * 1e3:.2f} ms, memory "
            f"{rec['memory_s'] * 1e3:.2f} ms, collectives "
            f"{rec['collective_s'] * 1e3:.2f} ms -> {rec['dominant']} "
            f"(H100 SXM peaks at 700 W); {rec['seconds']:.1f} s")
    out["seconds"] = time.perf_counter() - t
    log(f"phase 17 done in {out['seconds']:.1f} s")
    return out


CHILD_PHASES = {"13 (f)": "lm_generate_f32_params", "15": "moe_phase",
                "16": "train_phase", "17": "mesh17_phase"}


def child_phase(phase: str, out_path: str) -> None:
    """Run ``CHILD_PHASES[phase]`` on the card in this process (a child of
    the script's own, with nothing else of the script allocated on the
    card) and write its result as JSON to ``out_path``."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = globals()[CHILD_PHASES[phase]](torch.device("cuda"))
    pathlib.Path(out_path).write_text(json.dumps(res, default=str))


def run_child_phase(phase: str) -> dict:
    """``child_phase`` in a fresh Python process (its output on ours);
    raises if it fails. -> its result."""
    with tempfile.TemporaryDirectory() as d:
        out = f"{d}/phase.json"
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "import chip_smoke; chip_smoke.child_phase(sys.argv[2], "
                "sys.argv[3])")
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code, str(ROOT), phase,
                               out], cwd=ROOT, timeout=1500)
        if proc.returncode != 0:
            raise AssertionError(f"phase {phase} (in its own process) exited "
                                 f"{proc.returncode}")
        res = json.loads(pathlib.Path(out).read_text())
    log(f"phase {phase} in its own process: {time.perf_counter() - t:.1f} s "
        f"with its start")
    return res


def _kernel_entry(name, source, replaces, rows, main, launches,
                  envelope_launches) -> dict:
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, envelope_launches=envelope_launches,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=None)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on "
              "the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.bench import datasets
    from repro_torch.core.boomhq import BoomHQ
    from repro_torch.core.executor import recall_at_k
    from repro_torch.core.query import default_plan
    from repro_torch.kernels import gather_score as gs
    from repro_torch.serve.batch import CANDIDATE_LOCAL, CostModel
    from repro_torch.vectordb import flat

    # phase 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")
    # phases 13 (f), 15 and 16 — the largest models, each in a process of
    # its own while nothing else of this script is on the card
    big = {phase: run_child_phase(phase) for phase in CHILD_PHASES}
    big["17"]["checks"] = mesh17_checks(big["16"], big["17"])

    # phase 2
    build_s = build_kernels()
    # phase 12 (a), (b): the static checks on this build, the envelope
    lint = lint_phase()
    envelope = envelope_phase(dev)
    table = datasets.make("part", rows=ROWS, seed=0, device=dev)
    graphs, graph_s = build_graphs(table)
    fit_wl, serve_wl = smoke_workloads(table)
    log(f"table {table.n_rows} rows x {[v.shape[1] for v in table.vectors]} "
        f"+ {table.schema.n_scalar} scalars; {len(fit_wl)} fit / "
        f"{len(serve_wl)} serve queries")
    # phase 9's table (phase 2's vectors and one more scalar, the tenant)
    # and workloads; phase 3 checks the hot-view shape on it
    ttable = tenant_table(table)
    t_fit_wl, t_serve_wl = smoke_workloads(ttable)
    t_serve_wl = [dataclasses.replace(q, tenant_id=i % TENANTS)
                  for i, q in enumerate(t_serve_wl)]
    cfg = smoke_config()
    if cfg.graph_degree != GRAPH_DEGREE:
        raise AssertionError("the graphs are not at BoomHQ's default degree")
    bq = BoomHQ(table, cfg, graphs=graphs)
    torch.cuda.synchronize()
    log("IVF indexes and histograms built; graphs bound")

    # phase 3
    rows = check_kernels(table, gather_cases(table, bq.indexes[0], graphs[0],
                                             serve_wl, dev)
                         + hot_case(ttable, t_serve_wl, dev)
                         + sharded_case(table, serve_wl, dev), dev)
    scan_rows = check_scans(table, serve_wl[0].query_vectors[0], dev)

    # phase 4 — launch counts cover exactly this run
    gs.reset_launches()
    t = time.perf_counter()
    metrics = bq.fit(fit_wl)
    log(f"fit {time.perf_counter() - t:.1f} s: "
        + ", ".join(f"{k}={v:.3f}" for k, v in metrics.items()))
    gt = [flat.ground_truth(table, list(q.query_vectors), list(q.weights),
                            q.predicates, q.k)[0].cpu().numpy()
          for q in serve_wl]
    plan_mix: dict = {}
    for s in range(0, len(serve_wl), BATCH):
        for p in bq.optimize_batch(serve_wl[s: s + BATCH]):
            st = bq.executor.legalize(p).strategy
            plan_mix[st] = plan_mix.get(st, 0) + 1
    log(f"  learned plans on the serving queries: {plan_mix}")
    passes = {}
    rep_d, l_d, _ = serve_pass(bq, serve_wl, gt, "default")
    bq.bind_cost_model(CostModel(force=CANDIDATE_LOCAL))
    rep_c, l_c, res_c = serve_pass(bq, serve_wl, gt, "candidate_local")
    bq.bind_cost_model()
    gpass = graph_pass(bq, serve_wl, gt, graph_plan(table.schema.n_vec),
                       "graph plan beam 8, 4 hops")
    # the grid's largest graph knobs, for the recall the walk can reach
    gpass_max = graph_pass(bq, serve_wl, gt,
                           graph_plan(table.schema.n_vec, 16, 8, 8),
                           "graph plan beam 16, 8 hops, k_i = 8k")
    launches = dict(gs.LAUNCHES)
    # phase 12 (c) — one served batch's syncs, outside the counted window
    syncs = sync_phase(bq, serve_wl, lint)

    # phase 5 — the scan path, its own counts
    spass = scan_pass(table, serve_wl)

    # phase 10 — logical shards on phase 4's instance, before phase 6's
    # profiler and phase 7's inserts; its serving passes' counts
    shards, fixed = shard_phase(bq, serve_wl, gt, (res_c, rep_c), dev)
    # phase 11 — the mesh on the same instance, its passes' counts
    mesh = mesh_phase(bq, serve_wl, gt, fixed, smi)

    # phase 6
    bq.bind_cost_model(CostModel(force=CANDIDATE_LOCAL))
    prof = profile_batch(lambda: bq.execute_batch(serve_wl[:BATCH]))
    bq.bind_cost_model()
    gplan = graph_plan(table.schema.n_vec)
    prof_graph = profile_batch(lambda: bq._batched_executor().execute_batch(
        serve_wl[:BATCH], [gplan] * BATCH))
    shard_profiles(bq, serve_wl, shards["passes"])
    # reference: the robust one-size-fits-all plan on the same queries
    robust = bq._batched_executor().execute_batch(
        serve_wl, [default_plan(q.n_vec, bq.engine) for q in serve_wl])
    robust_recall = float(np.mean([recall_at_k(ids, g)
                                   for (ids, _), g in zip(robust, gt)]))
    log(f"  default_plan on the same queries: mean recall "
        f"{robust_recall:.4f}")
    for name, rep, lc in (("default", rep_d, l_d),
                          ("candidate_local", rep_c, l_c)):
        passes[name] = dict(qps=rep.qps, mean_recall=rep.mean_recall,
                            seconds=rep.seconds, path_counts=rep.path_counts,
                            launches=lc)
    passes["graph_plan"] = gpass
    passes["graph_plan_max"] = gpass_max
    target = serve_wl[0].recall_target
    for name, p in passes.items():
        p["meets_recall_target"] = bool(p["mean_recall"] >= target)
        log(f"  {name} pass: mean recall {p['mean_recall']:.4f} "
            + ("meets the queries' recall target" if p["meets_recall_target"]
               else "MISSES the queries' recall target: UNMET TARGET")
            + f" {target}")
    if l_c["fp32"] <= 0:
        raise AssertionError("the forced candidate-local pass never launched "
                             "the fp32 kernel")
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"kernel {name} never launched on the main "
                                 f"path")
    if gpass["graph_groups"] <= 0 or gpass["graph_groups"] != gpass["groups"]:
        raise AssertionError(f"the graph plan ran {gpass['graph_groups']} "
                             f"graph groups of {gpass['groups']}")
    # each chunk reranks with one fp32 launch; the rest are extractions
    if gpass["launches"]["fp32"] <= gpass["groups"]:
        raise AssertionError("the graph extraction never launched the fp32 "
                             "kernel")
    for name, cnt in spass["launches"].items():
        if cnt <= 0:
            raise AssertionError(f"scan kernel {name} never launched on the "
                                 f"scan path")
    for name in ("default", "candidate_local"):
        if passes[name]["mean_recall"] < robust_recall - RECALL_SPREAD:
            raise AssertionError(
                f"{name} pass mean recall {passes[name]['mean_recall']:.4f} "
                f"falls below the robust default plan's {robust_recall:.4f}")
    if abs(rep_d.mean_recall - rep_c.mean_recall) > RECALL_SPREAD:
        raise AssertionError(f"scoring paths disagree: {rep_d.mean_recall} "
                             f"vs {rep_c.mean_recall}")

    # phase 7 — updates on the served instance, the serving passes' counts
    upd = update_phase(bq, serve_wl, dev)
    # phase 8 — a vector->scalar set at d=128, its search pass's counts
    sift = sift_phase(dev)
    # phase 9 — the tiered, tenanted, cached path, its serving counts
    tier = tiered_phase(ttable, graphs, t_fit_wl, t_serve_wl, dev, smi)
    # phase 13 — the dense language models (no custom kernel on this path)
    lm_out = dict(lm_phase(dev), f32_params=big["13 (f)"])
    # phase 14 — the SSM and hybrid language models (no custom kernel)
    ssm_out = ssm_phase(dev)
    launches_by_phase = {"4": launches, "5": spass["launches"],
                         "7": upd["launches"], "8": sift["launches"],
                         "9": tier["launches"],
                         "9 compaction warm-up": tier["prewarm_launches"],
                         "10": shards["launches"], "11": mesh["launches"],
                         "11 (d)": tier["mesh_tiered"]["launches"]}

    kernels = []
    for variant in ("fp32", "int8"):
        vrows = [r for r in rows if r["variant"] == variant]
        checked = vrows + [r for r in sift["kernel_shapes"]
                           + [x for ins in upd["inserts"]
                              for x in ins["kernel_shapes"]]
                           if r["variant"] == variant]
        kernels.append(_kernel_entry(
            f"gather_score_{variant}", "src/repro_torch/csrc/gather_score.cu",
            "src/repro/kernels/gather_score.py:88", checked, vrows[0],
            launches[variant] + upd["launches"][variant]
            + sift["launches"][variant] + tier["launches"][variant]
            + shards["launches"][variant] + mesh["launches"][variant]
            + tier["mesh_tiered"]["launches"][variant],
            envelope["launches"][f"gather_score_{variant}"]))
    for name, variant, replaces in (
            ("masked_topk_fp32", "dot", "src/repro/kernels/masked_topk.py:28"),
            ("int8_scan", "int8", "src/repro/kernels/int8_scan.py:28")):
        vrows = [r for r in scan_rows if r["variant"] in
                 ((variant,) if variant == "int8" else ("dot", "l2"))]
        main_row = next(r for r in vrows if r["variant"] == variant
                        and r["k"] == 10 and r["active_cols"] == 1
                        and 0.05 < r["selectivity"] < 0.5)
        kernels.append(_kernel_entry(
            name, "src/repro_torch/csrc/masked_topk.cu", replaces, vrows,
            main_row, spass["launches"]["int8" if variant == "int8"
                                        else "fp32"],
            envelope["launches"][name]))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        device=smi, build_s=build_s, graph_build_s=graph_s,
        kernel_shapes=rows, scan_shapes=scan_rows, passes=passes,
        plan_mix=plan_mix, scan_pass=spass, fit=metrics, profile=prof,
        profile_graph=prof_graph, launches=launches,
        launches_by_phase=launches_by_phase, updates=upd["inserts"],
        sift=sift, tiered=tier, shards=shards, mesh=mesh, lm=lm_out,
        ssm=ssm_out, moe=big["15"], train=big["16"], mesh_slice=big["17"],
        static_checks=dict(lint=lint, envelope=envelope, syncs=syncs),
        default_plan_recall=robust_recall, recall_target=target,
        seconds=time.perf_counter() - T0), indent=1))
    log(f"done in {time.perf_counter() - T0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
