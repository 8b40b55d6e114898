"""Time variants of the full-table scan kernels at chip_smoke.py's shapes.

    python3 scripts/scan_variants.py      # from the repository root, on a CUDA card

Builds ``src/repro_torch/csrc/masked_topk.cu`` as it stands and variants
made from it by text substitution, each with the port's own ``nvcc`` flags
(one ``nvcc`` a variant, started together):

  * 256 threads: 256-thread CTAs instead of 512 (half the rows in flight a
    CTA, twice the passes);
  * no 2-CTA bound: ``__launch_bounds__(kThreads)`` without the minimum of
    two CTAs an SM, so the compiler may take more than 64 registers a
    thread and the 196 tiles of the 200,000-row table no longer all fit on
    the 132 SMs at once;
  * tile scales first: the int8 kernel reads its tile's scales coalesced
    into shared memory with the query (4 KB a tile) instead of each listed
    row's scale with its vector;
  * fp32 1 row in flight: ``kF32RowsInFlight = 1``;
  * int8 4 rows in flight: ``kRowsInFlight = 4``;
  * TMA bulk copies: the listed rows staged in shared memory by
    ``cp.async.bulk`` 1-D copies, one a run of consecutive listed rows, two
    48 KB stages in flight a CTA, completion on an mbarrier, then scored
    from shared memory (aligned rows only), instead of per-lane 16-byte
    loads with two rows in flight;
  * bitonic for every count: the list sorted however short it is, instead
    of ranked by counting when it holds at most one entry a thread;
  * shared-memory sort: every list sorted, every stage of the bitonic
    network on shared memory with a barrier each (the kernel's first
    design), instead of registers and warp shuffles within a warp;
  * phase stamps: the source as it stands, with thread 0 of each CTA
    stamping ``clock64()`` after each step and ``%globaltimer`` and
    ``%smid`` at its start and end; besides its time, the script reads the
    stamps of one launch a shape and prints each step's median time over
    the CTAs, the CTAs' spans, how many SMs held two tiles, and the
    kernel's span from the first CTA's start to the last one's end.

It then times the scan kernels alone, as ``chip_smoke.py`` phase 3 reads
their device time (20 launches replayed from a CUDA graph), at phase 3's
scan shapes on the 200,000-row ``part`` table (fp32 dot and l2, int8; k ∈
{10, 128}; the ≈1%, ≈10% and 100% price ranges and the all-columns
conjunction): the variants in turns, the order rotated each round, over
several rounds. Every variant's outputs must equal the unchanged source's
bit for bit. Prints each variant's registers (``-Xptxas -v``) and one line
per shape with each variant's median and spread, and writes
``chiprun_out/scan_variants.json``.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROUNDS = 5


# The TMA variant: the list's rows staged in shared memory by 1-D bulk
# copies (cp.async.bulk, completion on an mbarrier), one copy per run of
# consecutive listed rows, two 48 KB stages in flight a CTA; the rows are
# then scored from shared memory by the same lane mapping and order of
# operations as the row loops of row_dot.cuh, so the outputs stay
# bit-identical. Widths or addresses that rule out 16-byte rows keep the
# per-lane loads.
TMA_FUNCS = r"""
constexpr int kStageBytes = 48 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (long spin = 0; !done; ++spin) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (spin > (1L << 26)) __trap();  // a lost copy: fail, never hang
  }
}

// Warp 0 stages list entries [b * per, b * per + cnt) into `buf`.
template <typename T>
__device__ __forceinline__ void stage_batch(const T* vec, const int* s_id,
                                            int n_live, int d, int b, int per,
                                            unsigned char* buf, uint64_t* bar,
                                            int lane) {
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const int base = b * per;
  const int cnt = min(per, n_live - base);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (lane == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(cnt * row_bytes) : "memory");
  }
  __syncwarp();
  for (int i0 = 0; i0 < cnt; i0 += 32) {
    const int i = i0 + lane;
    const bool valid = i < cnt;
    const int gid = valid ? s_id[base + i] : 0;
    const bool start = valid && (i == i0 || s_id[base + i - 1] != gid - 1);
    const unsigned starts = __ballot_sync(0xffffffffu, start);
    if (start) {
      const unsigned later = starts & ~((2u << lane) - 1u);
      const int end = later ? i0 + __ffs(later) - 1 : min(cnt, i0 + 32);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(smem_u32(buf + static_cast<size_t>(i) * row_bytes)),
             "l"(vec + static_cast<size_t>(gid) * d),
             "r"((end - i) * row_bytes), "r"(smem_u32(bar)) : "memory");
    }
  }
}

template <typename T, bool kL2>
__device__ __forceinline__ void score_list_tma(
    const T* __restrict__ vec, const float* __restrict__ scale,
    const float* s_query, const int* s_id, float* s_score, int n_live, int d,
    int tid, unsigned char* stages, uint64_t* bars) {
  constexpr bool kInt8 = sizeof(T) == 1;
  const int warp = tid >> 5, lane = tid & 31;
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const int per = kStageBytes / row_bytes;
  const int n_batch = (n_live + per - 1) / per;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(bars + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    for (int b = 0; b < 2 && b < n_batch; ++b)
      stage_batch(vec, s_id, n_live, d, b, per, stages + b * kStageBytes,
                  bars + b, lane);
  }
  for (int b = 0; b < n_batch; ++b) {
    const int st = b & 1;
    mbar_wait(bars + st, (b >> 1) & 1);
    const unsigned char* buf = stages + st * kStageBytes;
    const int cnt = min(per, n_live - b * per);
    if constexpr (kInt8) {
      const int g = tid / kGroupLanes, l = tid % kGroupLanes;
      const int n16 = d >> 4;
      const float4* q4 = reinterpret_cast<const float4*>(s_query);
      for (int r0 = 0; r0 < cnt; r0 += kGroups) {
        const int r = r0 + g;
        const bool has = r < cnt;
        const int4* row = reinterpret_cast<const int4*>(
            buf + static_cast<size_t>(has ? r : 0) * row_bytes);
        float dot = 0.f;
        for (int e0 = 0; e0 < n16; e0 += kGroupLanes * kChunkLoads) {
          for (int u = 0; u < kChunkLoads; ++u) {
            const int e = e0 + u * kGroupLanes + l;
            if (e >= n16 || !has) continue;
            const int4 v = row[e];
            dot_word(v.x, q4[e], dot);
            dot_word(v.y, q4[n16 + e], dot);
            dot_word(v.z, q4[2 * n16 + e], dot);
            dot_word(v.w, q4[3 * n16 + e], dot);
          }
        }
        const float dsum = group_sum(dot);
        if (l == 0 && has) {
          const int idx = b * per + r;
          s_score[idx] = dsum * __ldg(scale + s_id[idx]);
        }
      }
    } else {
      const int n4 = d >> 2;
      const float4* q4 = reinterpret_cast<const float4*>(s_query);
      for (int r0 = 0; r0 < cnt; r0 += kWarps) {
        const int r = r0 + warp;
        const bool has = r < cnt;
        const float4* row = reinterpret_cast<const float4*>(
            buf + static_cast<size_t>(has ? r : 0) * row_bytes);
        float dot = 0.f, vv = 0.f;
        for (int e0 = 0; e0 < n4; e0 += 32 * kF32ChunkLoads) {
          for (int u = 0; u < kF32ChunkLoads; ++u) {
            const int e = e0 + u * 32 + lane;
            if (e >= n4) break;
            const float4 v = has ? row[e] : make_float4(0.f, 0.f, 0.f, 0.f);
            const float4 q = q4[e];
            dot = __fmaf_rn(v.x, q.x, dot);
            dot = __fmaf_rn(v.y, q.y, dot);
            dot = __fmaf_rn(v.z, q.z, dot);
            dot = __fmaf_rn(v.w, q.w, dot);
            if (kL2) {
              vv = __fmaf_rn(v.x, v.x, vv);
              vv = __fmaf_rn(v.y, v.y, vv);
              vv = __fmaf_rn(v.z, v.z, vv);
              vv = __fmaf_rn(v.w, v.w, vv);
            }
          }
        }
        const float dsum = warp_sum(dot);
        const float vsum = kL2 ? warp_sum(vv) : 0.f;
        if (lane == 0 && has)
          s_score[b * per + r] = kL2 ? 2.f * dsum - vsum : dsum;
      }
    }
    __syncthreads();  // every thread is done with this stage
    if (warp == 0 && b + 2 < n_batch)
      stage_batch(vec, s_id, n_live, d, b + 2, per,
                  stages + st * kStageBytes, bars + st, lane);
  }
}

"""


# The phase-stamp variant: thread 0 of each CTA records clock64() after each
# step's barrier, and %globaltimer and %smid at its start and end, into a
# device array that scan_read_stamps copies out. Outputs are unchanged.
STAMP_SLOTS = 12  # per CTA: clocks after steps 0-5, start/end ns, SM, count
PHASES = ("query and fields", "predicate", "compaction", "scoring",
          "selection")
STAMP_FUNCS = r"""
constexpr int kStampSlots = 12;
__device__ long long g_stamps[4096 * kStampSlots];

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int sm_id() {
  int s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}
"""
STAMP = "  if (tid == 0) g_stamps[j * kStampSlots + {}] = clock64();\n"

# The sort the kernel had before its register and shuffle stages: every
# stage of the bitonic network on shared memory, one barrier a stage.
SHARED_SORT = """  int width = 1;
  while (width < n_live) width <<= 1;
  for (int t = n_live + tid; t < width; t += kThreads) {
    s_score[t] = kNeg;
    s_id[t] = kIdSentinel;
  }
  __syncthreads();
  for (int size = 2; size <= width; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < width; i += kThreads) {
        const int p = i ^ stride;
        if (p > i) {
          const float si = s_score[i], sp = s_score[p];
          const int ii = s_id[i], ip = s_id[p];
          const bool i_first = si > sp || (si == sp && ii < ip);
          const bool want_i_first = (i & size) == 0;
          if (i_first != want_i_first) {
            s_score[i] = sp;
            s_score[p] = si;
            s_id[i] = ip;
            s_id[p] = ii;
          }
        }
      }
      __syncthreads();
    }
  }
"""


# every list sorted, however short (no rank by counting)
FORCE_SORT = ("  if (n_live <= kThreads) {\n    emit_ranked(",
              "  if (false) {\n    emit_ranked(", 1)

# name -> [(text, replacement, occurrences)]
VARIANTS = {
    "as built": [],
    "256 threads": [
        ("constexpr int kThreads = 512;", "constexpr int kThreads = 256;", 1)],
    "no 2-CTA bound": [
        ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads)", 1)],
    "tile scales first": [
        ("  __shared__ int s_warp_live[kWarps];\n",
         "  __shared__ int s_warp_live[kWarps];\n"
         "  __shared__ float s_scale[kMaxRows];\n", 1),
        ("  __syncthreads();\n\n  // 2. the predicate first",
         "  if (kInt8)\n"
         "    for (int t = tid; t < rows; t += kThreads)\n"
         "      s_scale[t] = __ldg(scale + row0 + t);\n"
         "  __syncthreads();\n\n  // 2. the predicate first", 1),
        ("sc[r] = has[r] ? __ldg(scale + gid) : 0.f;",
         "sc[r] = has[r] ? scale[gid] : 0.f;", 1),
        ("score_list(vec, scale, s_query,", "score_list(vec, s_scale - row0, s_query,",
         1)],
    "TMA bulk copies": [
        ("template <typename T, bool kL2>\n__global__ void "
         "__launch_bounds__(kThreads, 2)",
         TMA_FUNCS + "template <typename T, bool kL2>\n__global__ void "
         "__launch_bounds__(kThreads, 2)", 1),
        ("  __shared__ int s_warp_live[kWarps];\n",
         "  __shared__ int s_warp_live[kWarps];\n"
         "  __shared__ uint64_t s_bar[2];\n", 1),
        ("  // 4. score the list\n  if constexpr (kInt8) {",
         "  // 4. score the list\n  if (vec_ok) {\n"
         "    score_list_tma<T, kL2>(vec, scale, s_query, s_id, s_score, "
         "n_live, d, tid,\n"
         "        reinterpret_cast<unsigned char*>(s_query) + "
         "((d * 4 + 127) & ~127), s_bar);\n"
         "  } else if constexpr (kInt8) {", 1),
        ("  const size_t smem = static_cast<size_t>(d) * sizeof(float);\n",
         "  const size_t smem = ((static_cast<size_t>(d) * 4 + 127) & ~127) "
         "+ 2 * kStageBytes;\n"
         "  const void* kernels[] = {\n"
         "      (const void*)masked_topk_kernel<int8_t, false>,\n"
         "      (const void*)masked_topk_kernel<float, true>,\n"
         "      (const void*)masked_topk_kernel<float, false>};\n"
         "  for (const void* f : kernels) {\n"
         "    const cudaError_t err = cudaFuncSetAttribute(f, "
         "cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);\n"
         "    if (err != cudaSuccess) return static_cast<int>(err);\n"
         "  }\n", 1)],
    "phase stamps": [
        ("constexpr int kIdSentinel = 1 << 30;\n",
         "constexpr int kIdSentinel = 1 << 30;\n" + STAMP_FUNCS, 1),
        ("  const int rows = max(0, min(block_rows, n_rows - row0));\n",
         "  const int rows = max(0, min(block_rows, n_rows - row0));\n"
         "  const long long start_ns = global_ns();\n" + STAMP.format(0), 1),
        ("  // 2. the predicate first", STAMP.format(1)
         + "  // 2. the predicate first", 1),
        ("  // 3. compact", STAMP.format(2) + "  // 3. compact", 1),
        ("  // 4. score the list\n", STAMP.format(3)
         + "  // 4. score the list\n", 1),
        ("  __syncthreads();  // every score is in\n",
         "  __syncthreads();  // every score is in\n" + STAMP.format(4), 1),
        ("      oi[t] = live ? s_id[t] : -1;\n    }\n  }\n}\n",
         "      oi[t] = live ? s_id[t] : -1;\n    }\n  }\n"
         + STAMP.format(5)
         + "  if (tid == 0) {\n"
           "    long long* o = g_stamps + j * kStampSlots;\n"
           "    o[7] = start_ns;\n    o[8] = global_ns();\n"
           "    o[9] = sm_id();\n    o[10] = n_live;\n  }\n}\n", 1),
        ("  return static_cast<int>(cudaGetLastError());\n}\n",
         "  return static_cast<int>(cudaGetLastError());\n}\n\n"
         "extern \"C\" int scan_read_stamps(long long* host, int n) {\n"
         "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
         "      host, g_stamps, static_cast<size_t>(n) * sizeof(long long)));\n"
         "}\n", 1)],
    "bitonic for every count": [FORCE_SORT],
    "shared-memory sort": [
        FORCE_SORT, ("    sort_list(s_score, s_id, n_live, tid);\n",
                     SHARED_SORT, 1)],
    "fp32 1 row in flight": [
        ("constexpr int kF32RowsInFlight = 2;",
         "constexpr int kF32RowsInFlight = 1;", 1)],
    "int8 4 rows in flight": [
        ("constexpr int kRowsInFlight = 2;", "constexpr int kRowsInFlight = 4;",
         1)],
}


def build_variant(name: str, subs) -> tuple:
    """Compile the substituted source. -> (library path, ptxas lines)."""
    from repro_torch.kernels import build

    src = (build.CSRC / "masked_topk.cu").read_text()
    for old, new, count in subs:
        if src.count(old) != count:
            raise AssertionError(f"{name}: {old!r} occurs "
                                 f"{src.count(old)} times, expected {count}")
        src = src.replace(old, new)
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    tag = name.replace(" ", "_")
    cu, lib = out / f"masked_topk_{tag}.cu", out / f"libscan_{tag}.so"
    cu.write_text(src)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    regs = [line.strip() for line in log
            if "registers" in line or "spill" in line]
    return lib, regs


def build_all() -> dict:
    """Every variant built, one ``nvcc`` each, started together.
    -> {name: (library path, ptxas lines)}."""
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(zip(VARIANTS, pool.map(lambda kv: build_variant(*kv),
                                           VARIANTS.items()), strict=True))


def read_phases(lib, nb: int) -> dict:
    """The stamps of the stamped build's last launch over ``nb`` CTAs: each
    step's median time over the CTAs (clock64 cycles, converted at the
    CTAs' median %globaltimer ns per cycle), the CTAs' spans, the kernel's
    span and how many SMs held two tiles."""
    buf = (ctypes.c_longlong * (nb * STAMP_SLOTS))()
    lib.scan_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    rc = lib.scan_read_stamps(buf, nb * STAMP_SLOTS)
    if rc != 0:
        raise RuntimeError(f"reading the phase stamps failed: CUDA error {rc}")
    a = np.frombuffer(buf, dtype=np.int64).reshape(nb, STAMP_SLOTS)
    cycles = a[:, 5] - a[:, 0]
    ns = a[:, 8] - a[:, 7]
    ns_per_cycle = float(np.median(ns[cycles > 0] / cycles[cycles > 0]))
    steps = np.median(np.diff(a[:, :6], axis=1), axis=0) * ns_per_cycle
    return dict(
        phase_us={name: float(x) / 1e3
                  for name, x in zip(PHASES, steps, strict=True)},
        cta_us_median=float(np.median(ns)) / 1e3,
        cta_us_max=float(ns.max()) / 1e3,
        kernel_us=float(a[:, 8].max() - a[:, 7].min()) / 1e3,
        sms_with_two_tiles=int((np.bincount(a[:, 9]) == 2).sum()),
        ns_per_cycle=ns_per_cycle,
        listed_rows_median=float(np.median(a[:, 10])))


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device; this script times kernels on "
              "the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.bench import datasets
    from repro_torch.kernels import masked_topk as mt
    from repro_torch.kernels.shapes import SCAN_BLOCK_ROWS

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    built = build_all()
    argtypes = mt._library().masked_topk_launch.argtypes
    libs = {}
    for name, (path, regs) in built.items():
        libs[name] = ctypes.CDLL(str(path))
        libs[name].masked_topk_launch.argtypes = argtypes
        libs[name].masked_topk_launch.restype = ctypes.c_int
        print(f"{name}:", *regs, sep="\n    ")

    dev = torch.device("cuda")
    table = datasets.make("part", rows=cs.ROWS, seed=0, device=dev)
    scal_np = table.scalars.cpu().numpy()
    v0 = table.vectors[0]
    n = v0.shape[0]
    vq, sc = table.quantized(0)
    # any query vector of the table's width will do: the kernel's time
    # does not depend on its values
    q = torch.randn(v0.shape[1], generator=torch.Generator().manual_seed(3)
                    ).to(dev)
    preds = [cs._range_pred(scal_np, f, dev) for f in (0.01, 0.10, 1.0)]
    preds.append(cs._all_cols_pred(scal_np, dev))
    launch = {}
    for p in preds:
        lo, hi, act = (x.to(torch.float32).contiguous()
                       for x in (p.lo, p.hi, p.active))
        n_qual = int(torch.all(((table.scalars >= lo) & (table.scalars <= hi))
                               | (act < 0.5), dim=1).sum())
        n_act = int((act >= 0.5).sum())
        for k in (10, 128):
            for variant in ("dot", "l2", "int8"):
                int8 = variant == "int8"
                label = (f"{variant} k={k} sel={n_qual / n:.4f}"
                         + (f" {n_act} cols" if n_act > 1 else ""))

                def blocks(k=k, lo=lo, hi=hi, act=act, int8=int8,
                           metric="dot" if int8 else variant):
                    return mt.launch_blocks(
                        q, vq if int8 else v0, sc if int8 else None,
                        table.scalars, lo, hi, act, n, k=k,
                        block_rows=SCAN_BLOCK_ROWS, metric=metric)
                launch[label] = blocks

    names = list(VARIANTS)
    times = {(label, v): [] for label in launch for v in names}
    own = mt._library
    try:
        for label, blocks in launch.items():
            want = None
            for v in names:
                mt._library = lambda v=v: libs[v]
                got = blocks()
                torch.cuda.synchronize()
                if want is None:
                    want = got
                elif not all(torch.equal(x, y)
                             for x, y in zip(got, want, strict=True)):
                    raise AssertionError(f"{label}: {v} differs from the "
                                         f"unchanged source")
        for r in range(ROUNDS):
            order = names[r % len(names):] + names[:r % len(names)]
            for v in order:
                mt._library = lambda v=v: libs[v]
                for label, blocks in launch.items():
                    times[(label, v)].append(cs.graph_time_ms(blocks))
        stamped = libs["phase stamps"]
        mt._library = lambda: stamped
        nb = -(-n // SCAN_BLOCK_ROWS)
        phases = {}
        for label, blocks in launch.items():
            blocks()
            torch.cuda.synchronize()
            phases[label] = read_phases(stamped, nb)
    finally:
        mt._library = own
    rows = []
    for label in launch:
        cells = []
        for v in names:
            t = times[(label, v)]
            rows.append(dict(shape=label, variant=v, device_ms=t,
                             median_ms=statistics.median(t)))
            cells.append(f"{v} {statistics.median(t):.4f} "
                         f"[{min(t):.4f}-{max(t):.4f}]")
        print(f"{label:30s} " + "  ".join(cells), flush=True)
    print("phase stamps, one launch a shape (median over the CTAs, us):")
    for label, ph in phases.items():
        print(f"{label:30s} " + ", ".join(
            f"{name} {ph['phase_us'][name]:.2f}" for name in PHASES)
            + f"; CTA span {ph['cta_us_median']:.2f} (max "
            f"{ph['cta_us_max']:.2f}); kernel span {ph['kernel_us']:.2f}; "
            f"{ph['sms_with_two_tiles']} SMs held two tiles", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "scan_variants.json").write_text(json.dumps(dict(
        device=smi, registers={v: built[v][1] for v in names},
        rounds=ROUNDS, rows=rows, phases=phases), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
