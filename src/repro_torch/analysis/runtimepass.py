"""Level-2 checks: what the port's serving functions and kernels really do.

AST rules see what the source *says*. The reference's level 2 reads the
jaxpr and HLO of its serving kernels; the port has neither, so this pass
runs the functions and reads the compiler's own report instead:

* **CM001** — the host-read and collective contract. A tiny synthetic
  fixture (256 rows, d = 16, 4 scalars, B = 4, numpy seed 0: the
  reference's) is pushed through the port's counterparts of the five
  functions the reference traces: ``gather_score_topk`` (its plain path
  and the kernel route's host code, with a plain stand-in for the
  kernel), ``filter_first_local_batch``, ``search_local_batch``,
  ``sharded_batch_topk`` on a one-rank mesh of torch's fake process group
  and ``sharded_ivf_topk`` over 2 logical shards. While each runs, a
  ``TorchFunctionMode`` counts host reads (``item``, ``tolist``,
  ``__bool__``, ``__int__``, ``__float__``, ``__index__``, ``numpy``,
  ``__array__``, ``cpu``, ``to("cpu")``) and a wrapper over
  ``torch.distributed`` counts collectives. The per-shard and
  single-device functions may issue no collective; the sharded merge
  1..``config.MAX_ALL_GATHERS`` all-gathers, nothing else, and no host read
  (the reference's zero HLO host transfers). The other functions'
  host-read counts go into the report as numbers: the reference's XLA
  functions have none, so they are the port's divergence on record. The
  mesh's rank table (``DeviceMesh.mesh``) is host metadata by design and
  is not counted.
* **PL001** — the kernels' resource envelope on Hopper, from the
  ``nvcc -Xptxas -v`` report ``kernels/build.py`` keeps beside each
  library: registers, static shared memory, spills and stack frame of
  every kernel, held to the card (no spill, no stack; registers × threads
  × the ``__launch_bounds__`` minimum CTAs within the register file;
  static plus the launcher's dynamic shared memory, at the declared
  envelope of ``kernels/shapes.py`` and at the most the launcher admits,
  within 48 KB, or within the opt-in limit where the launcher calls
  ``cudaFuncSetAttribute``, whose threshold plus the static bytes must
  still fit 48 KB). The dynamic shared memory comes from the launchers'
  own ``query_smem_bytes``; threads, launch bounds and opt-in thresholds
  from the CUDA sources. A missing report is a finding that names it.
"""
from __future__ import annotations

import collections
import contextlib
import inspect
import os
import pathlib
import re
import traceback

from repro_torch.analysis.config import MAX_ALL_GATHERS, LintConfig
from repro_torch.analysis.findings import Finding

SOURCES = ("gather_score", "masked_topk")
HOST_READS = {"item", "tolist", "__bool__", "__int__", "__float__",
              "__index__", "numpy", "__array__", "cpu"}
COLLECTIVES = ("all_gather", "all_gather_into_tensor", "all_gather_object",
               "all_reduce", "broadcast", "broadcast_object_list",
               "all_to_all", "all_to_all_single", "reduce_scatter",
               "reduce_scatter_tensor")
_PORT = str(pathlib.Path(__file__).resolve().parents[1])
_HERE = str(pathlib.Path(__file__).resolve().parent)


def _relpath(path) -> str:
    return os.path.relpath(path).replace(os.sep, "/")


def _where(fn) -> tuple:
    """(repo-relative path, def line) of a function."""
    return _relpath(inspect.getsourcefile(fn)), \
        inspect.getsourcelines(fn)[1]


# ---------------------------------------------------------------------------
# CM001: host reads and collectives
# ---------------------------------------------------------------------------

def _is_cpu(x) -> bool:
    import torch

    return (isinstance(x, str) and x == "cpu") or (
        isinstance(x, torch.device) and x.type == "cpu")


def _port_site() -> str:
    """file:line of the innermost port frame outside this package."""
    for fr in reversed(traceback.extract_stack()):
        if fr.filename.startswith(_PORT) and not fr.filename.startswith(
                _HERE):
            return f"{_relpath(fr.filename)}:{fr.lineno}"
    return "?"


def _host_read_mode(ignore: tuple):
    """A ``TorchFunctionMode`` counting host reads by port site, skipping
    reads of the tensors in ``ignore`` and of views of their storage."""
    import torch
    from torch.overrides import TorchFunctionMode

    skip = {t.untyped_storage().data_ptr() for t in ignore}

    class HostReads(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.sites = collections.Counter()

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = getattr(func, "__name__", "")
            read = name in HOST_READS or (name == "to" and (
                any(_is_cpu(a) for a in args[1:2])
                or _is_cpu(kwargs.get("device"))))
            t = args[0] if args else None
            if read and not (isinstance(t, torch.Tensor) and
                             t.untyped_storage().data_ptr() in skip):
                self.sites[_port_site()] += 1
            return func(*args, **kwargs)

    return HostReads()


@contextlib.contextmanager
def _counting_collectives():
    """Count every ``torch.distributed`` collective called in the block."""
    import torch.distributed as dist

    counts = collections.Counter()
    saved = {n: getattr(dist, n) for n in COLLECTIVES if hasattr(dist, n)}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return counted

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _observe(run, ignore=()) -> tuple:
    """-> (host reads by site, collectives by name) of one call."""
    with _counting_collectives() as coll:
        with _host_read_mode(ignore) as mode:
            run()
    return dict(mode.sites), dict(coll)


def _fixture():
    import numpy as np
    import torch

    from repro_torch.vectordb.predicates import Predicates, stack

    rng = np.random.default_rng(0)
    n, d, m, b = 256, 16, 4, 4
    vectors = torch.as_tensor(rng.normal(size=(n, d)), dtype=torch.float32)
    scalars = torch.as_tensor(rng.uniform(size=(n, m)), dtype=torch.float32)
    q_b = torch.as_tensor(rng.normal(size=(b, d)), dtype=torch.float32)
    pred_b = stack([Predicates.from_conditions(m, {0: (0.2, 0.9)},
                                               device="cpu")
                    for _ in range(b)])
    w_b = torch.ones((b, 1), dtype=torch.float32)
    return vectors, scalars, q_b, pred_b, w_b


def _plain_blocks(cand, vectors, qs, weights, scalars, lo, hi, active,
                  clause_valid, scales, *, k, block_s, metric, apply_pred):
    """``gather_score_blocks``' outputs from the plain version, block by
    block, so the kernel route's host code runs without a card."""
    from repro_torch.kernels.ref import gather_score_ref

    b, s = cand.shape
    nb = s // block_s

    def rep(t):
        return t.repeat_interleave(nb, dim=0)

    ids, sc, nq = gather_score_ref(
        cand.reshape(b * nb, block_s), vectors, tuple(rep(q) for q in qs),
        rep(weights), scalars, rep(lo), rep(hi), rep(active),
        rep(clause_valid), k=k, metric=metric, apply_pred=apply_pred,
        scales=scales)
    return sc.reshape(b, nb, k), ids.reshape(b, nb, k), nq.reshape(b, nb)


@contextlib.contextmanager
def _fake_mesh():
    """A one-rank ``(data,)`` mesh over torch's fake process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def _serving_runs(k: int) -> list:
    """(label, function, call) of the five functions on the fixture, the
    gather entry's two routes apart; the sharded merge's call takes the
    mesh."""
    import torch

    from repro_torch.kernels import gather_score as gs
    from repro_torch.vectordb import distributed, flat, ivf

    vectors, scalars, q_b, pred_b, w_b = _fixture()
    b = q_b.shape[0]
    cand = torch.arange(64, dtype=torch.int32)[None].repeat(b, 1)
    lo, hi, act, cval = gs._pred_fields(pred_b, b, scalars.shape[1], "cpu")
    index = ivf.build(vectors, 8, seed=0)
    sivf = distributed.build_sharded_ivf(vectors, 2, n_clusters=8)
    sfn = distributed.sharded_ivf_topk(2, subs=((0, 8, 16, 2, 64),), k=k,
                                       metric="dot", pad_total=64)
    w_scores = q_b @ vectors.T
    return [
        ("gather_score_ref", gs.gather_score_topk,
         lambda: gs.gather_score_topk(cand, (vectors,), (q_b,), w_b,
                                      scalars, pred_b, k=k)),
        ("gather_score_kernel", gs.kernel_route,
         lambda: gs.kernel_route(cand, (vectors,), (q_b,), w_b, scalars,
                                 lo, hi, act, cval, k=k, metric="dot",
                                 block_s=gs.GATHER_BLOCK_S, scales=None,
                                 apply_pred=True, blocks=_plain_blocks)),
        ("filter_first_local_batch", flat.filter_first_local_batch,
         lambda: flat.filter_first_local_batch(
             (vectors,), scalars, pred_b, (q_b,), w_b, k=k,
             max_candidates=64, n_vec=1)),
        ("search_local_batch", ivf.search_local_batch,
         lambda: ivf.search_local_batch(index, vectors, scalars, pred_b,
                                        q_b, nprobe=2, max_scan=64, k=k)),
        ("sharded_batch_topk", distributed.sharded_batch_topk,
         lambda mesh: distributed.sharded_batch_topk(mesh, k=k)(
             w_scores, scalars, pred_b)),
        ("sharded_ivf_topk", distributed.sharded_ivf_topk,
         lambda: sfn((sivf.centroids,), (sivf.sorted_rows,),
                     (sivf.offsets,), (vectors,), scalars, pred_b, (q_b,),
                     w_b)),
    ]


def check_host_reads() -> tuple:
    """CM001 on the five serving functions. -> (findings, {label: {
    "host_reads": n, "sites": {file:line: n}, "collectives": {...}}})."""
    findings: list = []
    report: dict = {}
    for label, fn, call in _serving_runs(k=8):
        path, line = _where(fn)
        merge = label == "sharded_batch_topk"
        if merge:
            with _fake_mesh() as mesh:
                sites, coll = _observe(lambda: call(mesh), (mesh.mesh,))
        else:
            sites, coll = _observe(call)
        n_reads = sum(sites.values())
        report[label] = {"host_reads": n_reads, "sites": sites,
                         "collectives": coll}
        gathers = coll.get("all_gather", 0) + coll.get(
            "all_gather_into_tensor", 0)
        allowed = MAX_ALL_GATHERS if merge else 0
        if gathers > allowed:
            findings.append(Finding(
                "CM001", path, line,
                f"{label}: {gathers} all-gathers — the merge contract is at "
                f"most {allowed} (scores + ids, O(shards·k))",
                context=f"runtime:{label}:all_gather"))
        for name in sorted(set(coll) - {"all_gather",
                                        "all_gather_into_tensor"}):
            findings.append(Finding(
                "CM001", path, line,
                f"{label}: unexpected collective `{name}` (×{coll[name]}) — "
                f"serving functions communicate only through the "
                f"O(shards·k) candidate merge",
                context=f"runtime:{label}:{name}"))
        if merge and gathers == 0:
            findings.append(Finding(
                "CM001", path, line,
                f"{label}: expected the O(shards·k) candidate merge "
                f"(an all-gather), found none — the merge contract changed",
                context=f"runtime:{label}:missing"))
        if merge and n_reads:
            findings.append(Finding(
                "CM001", path, line,
                f"{label}: {n_reads} host read(s) in the sharded merge "
                f"({', '.join(sorted(sites))}) — the merge must stay on "
                f"the device", context=f"runtime:{label}:host_read"))
    return findings, report


# ---------------------------------------------------------------------------
# PL001: the kernels' compiled resources
# ---------------------------------------------------------------------------

_TYPES = {"a": "signed char", "h": "unsigned char", "c": "char",
          "s": "short", "i": "int", "j": "unsigned int", "l": "long",
          "f": "float", "d": "double", "b": "bool"}


def demangle(name: str) -> str:
    """``_Z18masked_topk_kernelIaLb0EEv...`` -> ``masked_topk_kernel<signed
    char, false>``: the Itanium names of the free function templates the
    CUDA sources define, in an anonymous namespace (``_ZN..._GLOBAL__N_...``)
    or not; anything else comes back as it is."""
    nested = name.startswith("_ZN")
    if not name.startswith("_Z"):
        return name
    i, parts = 3 if nested else 2, []
    while i < len(name) and name[i].isdigit():
        m = re.match(r"\d+", name[i:])
        end = i + m.end() + int(m.group())
        parts.append(name[i + m.end(): end])
        i = end
        if not nested:
            break
    base = "::".join(p for p in parts if not p.startswith("_GLOBAL__N"))
    if not base:
        return name
    if not name.startswith("I", i):
        return base
    args, i = [], i + 1
    while i < len(name) and name[i] != "E":
        lit = re.match(r"L([a-z])(\d+)E", name[i:])
        if lit:
            v = lit.group(2)
            args.append({"0": "false", "1": "true"}[v] if lit.group(1) == "b"
                        else v)
            i += lit.end()
        elif name[i] in _TYPES:
            args.append(_TYPES[name[i]])
            i += 1
        else:
            return name
    return f"{base}<{', '.join(args)}>"


def parse_ptxas(text: str) -> list:
    """Every function of an ``nvcc -Xptxas -v`` report: ``{"mangled",
    "name", "entry", "registers", "smem", "stack", "spill_stores",
    "spill_loads"}``."""
    funcs: dict = {}
    cur = None

    def rec(name):
        return funcs.setdefault(name, dict(
            mangled=name, name=demangle(name), entry=False, registers=0,
            smem=0, stack=0, spill_stores=0, spill_loads=0))

    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = rec(m.group(1))
            cur["entry"] = True
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = rec(m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return list(funcs.values())


def cu_launch_specs(source: str) -> dict:
    """{kernel: {"threads", "min_ctas", "optin"}} from a CUDA source: each
    ``__launch_bounds__`` kernel's threads and minimum CTAs a SM (integer
    ``constexpr`` names resolved), and the dynamic shared-memory threshold
    past which its launcher calls ``cudaFuncSetAttribute`` (None if it
    never does)."""
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr\s+int\s+(\w+)\s*=\s*(\d+)\s*;", source)}

    def val(tok):
        return int(tok) if tok.isdigit() else consts[tok]

    specs = {}
    for m in re.finditer(r"__launch_bounds__\(\s*(\w+)\s*(?:,\s*(\w+)\s*)?"
                         r"\)\s*(\w+)\s*\(", source):
        specs[m.group(3)] = dict(
            threads=val(m.group(1)),
            min_ctas=val(m.group(2)) if m.group(2) else 1, optin=None)
    for m in re.finditer(r"cudaError_t\s+\w+\s*\((.*?)\n}\n", source,
                         re.DOTALL):
        body = m.group(1)
        opt = re.search(r"if\s*\(\s*smem\s*>\s*(\d+)\s*\*\s*1024\s*\)\s*\{"
                        r"[^}]*cudaFuncSetAttribute", body)
        if opt is None:
            continue
        for name in set(re.findall(r"(\w+)\s*<", body)) & set(specs):
            specs[name]["optin"] = int(opt.group(1)) * 1024
    return specs


def launcher_smem() -> dict:
    """{kernel: (dynamic bytes at the declared envelope, the most the
    launcher admits)}, from the launchers' own ``query_smem_bytes``."""
    from repro_torch.kernels import gather_score as gs
    from repro_torch.kernels import masked_topk as mt
    from repro_torch.kernels.shapes import MAX_COL_DIM, MAX_VEC_COLS

    gather = (gs.query_smem_bytes((MAX_COL_DIM,) * MAX_VEC_COLS),
              gs.QUERY_SMEM_MAX)
    return {"gather_score_kernel": gather,
            "gather_score_int8_kernel": gather,
            "masked_topk_kernel": (mt.query_smem_bytes(MAX_COL_DIM),
                                   mt.MAX_QUERY_SMEM)}


def resident_ctas(regs: int, threads: int, smem: int, card) -> int:
    """CTAs of one kernel an SM holds at once, by the card's arithmetic:
    the least of the CTA slots, the threads, the register file (allocated
    a warp at a time, in units of ``reg_unit``) and the shared memory (each
    CTA also reserving ``smem_reserved``)."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // card.reg_unit) * card.reg_unit
    by_regs = card.regs_per_sm // (per_warp * warps) if per_warp else \
        card.ctas_per_sm
    by_smem = card.smem_per_sm // (smem + card.smem_reserved)
    return min(card.ctas_per_sm, card.threads_per_sm // threads, by_regs,
               by_smem)


def find_log(name: str, cfg: LintConfig) -> pathlib.Path:
    """The report of ``csrc/<name>.cu``: ``<dir>/<name>.log`` or the newest
    ``<dir>/lib<name>-*.log`` under ``cfg.ptxas_logs``, else the one
    ``kernels/build.py`` keeps beside the library of the current source."""
    if cfg.ptxas_logs:
        d = pathlib.Path(cfg.ptxas_logs)
        found = sorted(d.glob(f"lib{name}-*.log"),
                       key=lambda p: p.stat().st_mtime)
        return found[-1] if found else d / f"{name}.log"
    from repro_torch.kernels import build

    return build.library_path(name).with_suffix(".log")


def check_kernel_resources(cfg: LintConfig) -> tuple:
    """PL001 on every kernel of the ptxas reports. -> (findings, rows)."""
    from repro_torch.kernels import build

    card = cfg.card
    dyn = launcher_smem()
    findings, rows = [], []
    for src in SOURCES:
        cu = build.CSRC / f"{src}.cu"
        path = _relpath(cu)
        log = find_log(src, cfg)
        if not log.exists():
            findings.append(Finding(
                "PL001", path, 1,
                f"{src}: no nvcc -Xptxas -v report at {_relpath(log)} — "
                f"build the library (kernels/build.py keeps the report "
                f"beside it) or pass --ptxas-logs DIR",
                context=f"ptxas:{src}:missing"))
            continue
        specs = cu_launch_specs(cu.read_text())
        funcs = parse_ptxas(log.read_text())
        seen = set()

        def emit(fname, what, msg):
            findings.append(Finding("PL001", path, 1, f"{fname}: {msg}",
                                    context=f"ptxas:{fname}:{what}"))

        for f in funcs:
            fname = f["name"]
            if f["spill_stores"] + f["spill_loads"] > card.spill_bytes:
                emit(fname, "spill", f"{f['spill_stores']} bytes spill "
                     f"stores, {f['spill_loads']} bytes spill loads — "
                     f"registers spill to local memory")
            if f["stack"] > card.spill_bytes:
                emit(fname, "stack", f"{f['stack']} bytes stack frame — a "
                     f"local array or call frame lives in local memory")
            if not f["entry"]:
                continue
            base = fname.split("<")[0]
            spec = specs.get(base)
            if spec is None or base not in dyn:
                emit(fname, "unknown", "a kernel the linter does not know "
                     "(no __launch_bounds__ in the source, or no launcher "
                     "shared-memory formula)")
                continue
            seen.add(base)
            env, most = dyn[base]
            threads, min_ctas, optin = spec["threads"], spec["min_ctas"], \
                spec["optin"]
            regs, smem = f["registers"], f["smem"]
            if regs > card.regs_per_thread or \
                    regs * threads * min_ctas > card.regs_per_sm:
                emit(fname, "registers", f"{regs} registers × {threads} "
                     f"threads × {min_ctas} CTAs = "
                     f"{regs * threads * min_ctas} > the SM's "
                     f"{card.regs_per_sm} (at most {card.regs_per_thread} "
                     f"a thread)")
            limit = card.smem_optin if optin is not None \
                else card.smem_default
            for what, d in (("envelope", env), ("launcher", most)):
                if smem + d > limit:
                    emit(fname, f"smem_{what}", f"{smem} static + {d} "
                         f"dynamic bytes of shared memory ({what}) > "
                         f"{limit}" + ("" if optin is not None else
                                       " without a cudaFuncSetAttribute "
                                       "opt-in"))
            if optin is not None and optin + smem > card.smem_default:
                emit(fname, "smem_optin", f"the launcher opts in only past "
                     f"{optin} dynamic bytes, but {optin} + {smem} static "
                     f"> {card.smem_default}")
            rows.append(dict(
                kernel=fname, source=path, registers=regs, smem_static=smem,
                smem_dynamic_envelope=env, smem_dynamic_max=most,
                spill_stores=f["spill_stores"], spill_loads=f["spill_loads"],
                stack=f["stack"], threads=threads, min_ctas=min_ctas,
                resident_ctas=resident_ctas(regs, threads, smem + env,
                                            card)))
        for base in sorted(set(specs) - seen):
            emit(base, "absent", f"a kernel of {src}.cu missing from the "
                 f"report {_relpath(log)}")
    return findings, rows


def run_runtime_checks(cfg: LintConfig) -> tuple:
    """-> (findings, {"functions": CM001's report, "kernels": PL001's
    rows})."""
    found, functions = check_host_reads()
    pl, kernels = check_kernel_resources(cfg)
    return found + pl, {"functions": functions, "kernels": kernels}
