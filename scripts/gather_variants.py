"""Time variants of the fp32 gather-score kernel at chip_smoke.py's shapes.

    python3 scripts/gather_variants.py      # from the repository root, on a CUDA card

Builds ``src/repro_torch/csrc/gather_score.cu`` as it stands and three
variants made from it by text substitution, each with the port's own
``nvcc`` flags (one ``nvcc`` a variant, started together):

  * block-major grid: ``blockIdx.x`` walks a query's 256-slot blocks and
    ``blockIdx.y`` the queries (the int8 stage's order), so the CTAs
    resident at one time hold every block of a few queries instead of the
    same blocks of every query;
  * 4 CTAs an SM: ``__launch_bounds__(256, 4)`` on the fp32 kernel, which
    caps it at 64 registers a thread;
  * 1 row in flight: ``kF32RowsInFlight = 1``.

It then times the fp32 kernel alone, as ``chip_smoke.py`` phase 3 reads its
device time (20 launches replayed from a CUDA graph), at phase 3's fp32
shapes on the 200,000-row ``part`` table: the variants in turns, the order
rotated each round, over several rounds. Every variant's outputs must
equal the unchanged source's bit for bit. Prints each variant's registers
(``-Xptxas -v``) and one line per shape with each variant's median and
spread, and writes ``chiprun_out/gather_variants.json``.
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

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROUNDS = 5

# name -> [(text, replacement, occurrences)]
VARIANTS = {
    "as built": [],
    "block-major grid": [
        ("const int b = blockIdx.x;  // query-major: see gather_score_launch\n"
         "  const int j = blockIdx.y;\n  const int nb = gridDim.y;",
         "const int j = blockIdx.x;\n  const int b = blockIdx.y;\n"
         "  const int nb = gridDim.x;", 1),
        ("l2 != 0, dim3(B, S / bs), smem", "l2 != 0, grid, smem", 1)],
    "4 CTAs an SM": [
        ("__global__ void __launch_bounds__(kThreads)\ngather_score_kernel(",
         "__global__ void __launch_bounds__(kThreads, 4)\n"
         "gather_score_kernel(", 1)],
    "1 row in flight": [
        ("constexpr int kF32RowsInFlight = 2;",
         "constexpr int kF32RowsInFlight = 1;", 1)],
}


def build_variant(name: str, subs) -> tuple:
    """Compile the substituted source. -> (library path, ptxas lines)."""
    from repro_torch.kernels import build

    src = (build.CSRC / "gather_score.cu").read_text()
    for old, new, count in subs:
        if src.count(old) != count:
            raise AssertionError(f"{name}: {old!r} occurs "
                                 f"{src.count(old)} times, expected {count}")
        src = src.replace(old, new)
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    tag = name.replace(" ", "_")
    cu, lib = out / f"gather_score_{tag}.cu", out / f"libgather_{tag}.so"
    cu.write_text(src)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    regs = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
            if "registers" in line]
    return lib, regs


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_variants: no CUDA device; this script times kernels on "
              "the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.bench import datasets, queries as qgen
    from repro_torch.core.boomhq import BoomHQ, BoomHQConfig
    from repro_torch.kernels import gather_score as gs
    from repro_torch.vectordb import graph

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda kv: build_variant(*kv),
                                            VARIANTS.items())))
    argtypes = gs._library().gather_score_launch.argtypes
    libs = {}
    for name, (path, regs) in built.items():
        libs[name] = ctypes.CDLL(str(path))
        libs[name].gather_score_launch.argtypes = argtypes
        libs[name].gather_score_launch.restype = ctypes.c_int
        print(f"{name}:", *regs, sep="\n    ")

    dev = torch.device("cuda")
    table = datasets.make("part", rows=cs.ROWS, seed=0, device=dev)
    g0 = graph.build(table.vectors[0], cs.GRAPH_DEGREE,
                     metric=table.schema.metric)
    bq = BoomHQ(table, BoomHQConfig(n_clusters=32, graph_degree=0))
    serve_wl = qgen.gen_workload(table, cs.N_SERVE // 2, n_vec_used=2,
                                 seed=3) + \
        qgen.gen_dnf_workload(table, cs.N_SERVE // 2, n_vec_used=2, seed=4)
    cases = [(label, a) for label, variant, a in cs.gather_cases(
        table, bq.indexes[0], g0, serve_wl, dev) if variant == "fp32"]
    m, b = table.schema.n_scalar, cs.BATCH
    launch = {}
    for label, a in cases:
        s_len = a["cand"].shape[1]
        bs = min(256, gs._next_pow2(max(s_len, a["k"], 8)))
        cand = torch.cat([a["cand"], torch.full(
            (b, (-s_len) % bs), -1, dtype=torch.int32, device=dev)], 1)
        fields = [f.contiguous() for f in gs._pred_fields(a["pred"], b, m,
                                                          dev)]

        def blocks(a=a, cand=cand, bs=bs, fields=fields):
            return gs.gather_score_blocks(
                cand, a["vectors"], a["qs"], a["w"], table.scalars, *fields,
                None, k=a["k"], block_s=bs, metric=a["metric"],
                apply_pred=a["pred"] is not None)
        launch[label] = blocks

    names = list(VARIANTS)
    times = {(label, n): [] for label, _ in cases for n in names}
    own = gs._library
    try:
        for label, _ in cases:
            want = None
            for n in names:
                gs._library = lambda n=n: libs[n]
                got = launch[label]()
                torch.cuda.synchronize()
                if want is None:
                    want = got
                elif not all(torch.equal(x, y) for x, y in zip(got, want)):
                    raise AssertionError(f"{label}: {n} differs from the "
                                         f"unchanged source")
        for r in range(ROUNDS):
            order = names[r % len(names):] + names[:r % len(names)]
            for n in order:
                gs._library = lambda n=n: libs[n]
                for label, _ in cases:
                    times[(label, n)].append(cs.graph_time_ms(launch[label]))
    finally:
        gs._library = own
    rows = []
    for label, _ in cases:
        cells = []
        for n in names:
            t = times[(label, n)]
            rows.append(dict(shape=label, variant=n, device_ms=t,
                             median_ms=statistics.median(t)))
            cells.append(f"{n} {statistics.median(t):.4f} "
                         f"[{min(t):.4f}-{max(t):.4f}]")
        print(f"{label:28s} " + "  ".join(cells), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "gather_variants.json").write_text(json.dumps(dict(
        device=smi, registers={n: built[n][1] for n in names},
        rounds=ROUNDS, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
