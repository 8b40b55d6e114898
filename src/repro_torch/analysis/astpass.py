"""Level-1 AST rules of the port: HS001 (hot host functions), EP001, EP002
and PL001's build-flag form.

The reference's HS001 has two scopes: traced functions (a host read under
a JAX trace) and the hot host functions of the serving path. Nothing in
the port is traced or jitted, so only the hot scope is carried over. It
flags a sync inside the loops of a registered hot function (a sync per
iteration) and the same expression read to the host twice (a duplicate
round-trip), and it knows torch's syncs as well as numpy's: the reads
``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
``np.asarray``/``np.array`` of a non-constant and ``int``/``float``/
``bool`` of a non-constant; the host->device copies
``torch.as_tensor``/``torch.tensor`` with a ``device=`` and indexing with
a host list; and ``torch.cuda.synchronize()``. A hot method that runs
inside a loop of its class (called there, or from a method that is) syncs
once per iteration too, wherever in its body the sync stands: the
reference's loops sit in the same function as their syncs, the port's
per-chunk syncs in the methods a loop calls. The duplicate rule keeps the
reference's three exceptions: mutually exclusive ``if`` arms, a name
rebound between the two reads, and the lazy-memo idiom
(``if x is None: x = ...``). A chain of reads (``x.cpu().numpy()``,
``int(x.item())``) is one read, at its innermost call.

EP001 and EP002 are the reference's rules as they are.

PL001 here reads a module's ``NVCC_FLAGS``: the port's exact denormal
bounds (``~(col == 0)`` compiles to ±1.4e-45) need a build that flushes no
denormal and keeps IEEE division and square roots, so ``--use_fast_math``,
``-ftz=true``, ``-prec-div=false`` and ``-prec-sqrt=false`` are findings.

Left out, each for its reason: HS001's traced scope and RC001 (no trace, no
jit cache: ``kernels/build.library_path`` keys a build on source and flags
only, so shapes cannot cause one), SM001 (a port rank is a process that
holds only what it is passed), and PL001's ``BlockSpec`` form (no Pallas).
"""
from __future__ import annotations

import ast
import fnmatch

from repro_torch.analysis.config import (
    CACHE_ENTRY_FIELDS, TIERED_MUTABLE_FIELDS, LintConfig,
)
from repro_torch.analysis.findings import Finding

NP_ALIASES = {"np", "numpy", "onp"}
COERCERS = {"int", "float", "bool", "complex"}
# tensor methods that copy to the host (and so wait for the device)
HOST_READ_METHODS = {"item", "tolist", "cpu", "numpy"}
SYNC_CALLS = {"torch.cuda.synchronize"}
# host->device copies from host memory, which wait for the stream too
H2D_CALLS = {"torch.as_tensor", "torch.tensor"}
# nvcc flags that flush denormals or relax IEEE division / square roots
FAST_MATH_FLAGS = {"use_fast_math", "ftz=true", "prec-div=false",
                   "prec-sqrt=false"}


def dotted(node) -> str | None:
    """'torch.cuda.synchronize' for Attribute/Name chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _tail(name: str | None) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


def _annotate_parents(tree) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._bl_parent = node


def _qualname(fn) -> str:
    parts = [fn.name]
    cur = getattr(fn, "_bl_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            parts.append(cur.name)
        cur = getattr(cur, "_bl_parent", None)
    return ".".join(reversed(parts))


def _is_cpu(node) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return isinstance(node, ast.Call) and _tail(dotted(node.func)) == \
        "device" and bool(node.args) and _is_cpu(node.args[0])


def host_read(node) -> tuple | None:
    """-> (label, the expression read) when the call copies a tensor to the
    host, else None. Constants and sequences built on the host
    (``np.asarray([q.k for q in qs])``) are never read."""
    if not isinstance(node, ast.Call):
        return None
    fd = dotted(node.func)
    if fd and fd.split(".")[0] in NP_ALIASES and _tail(fd) in (
            "asarray", "array"):
        arg = node.args[0] if node.args else None
        if isinstance(arg, (ast.List, ast.Tuple, ast.ListComp,
                            ast.GeneratorExp)):
            return None  # a sequence built on the host
        label = f"`{fd}()`"
    elif isinstance(node.func, ast.Attribute) and \
            node.func.attr in HOST_READ_METHODS:
        arg, label = node.func.value, f"`.{node.func.attr}()`"
    elif isinstance(node.func, ast.Attribute) and node.func.attr == "to" \
            and (any(_is_cpu(a) for a in node.args[:1]) or any(
                kw.arg == "device" and _is_cpu(kw.value)
                for kw in node.keywords)):
        arg, label = node.func.value, '`.to("cpu")`'
    else:
        return None
    if arg is None or isinstance(arg, ast.Constant):
        return None
    return label, arg


def h2d_copy(node) -> str | None:
    """-> a label when the call copies host data to a device tensor
    (``torch.as_tensor(x, device=dev)`` with ``dev`` not the CPU)."""
    if not isinstance(node, ast.Call):
        return None
    fd = dotted(node.func)
    if fd not in H2D_CALLS:
        return None
    for kw in node.keywords:
        if kw.arg == "device" and not _is_cpu(kw.value) and not (
                isinstance(kw.value, ast.Constant) and kw.value.value is None):
            return f"`{fd}(..., device=)`"
    return None


def list_index(node) -> str | None:
    """-> a label when a subscript indexes with a host list
    (``w[:, list(act)]``, ``x[[0, 2]]``): torch copies the index to the
    tensor's device first."""
    if not isinstance(node, ast.Subscript):
        return None
    sl = node.slice
    for e in (sl.elts if isinstance(sl, ast.Tuple) else [sl]):
        if isinstance(e, (ast.List, ast.ListComp)) or (
                isinstance(e, ast.Call) and dotted(e.func) == "list"):
            return "indexing with a host list (a host->device copy)"
    return None


def _calls_in_loops(cls, is_hot) -> dict:
    """{method def: caller qualname} for the methods of ``cls`` that run
    inside a loop of the serving path: called as ``self.m(...)`` inside a
    loop or comprehension of a method the hot functions reach (itself
    included: a recursive call per sub-batch), or from a method that itself
    runs inside one."""
    methods = {n.name: n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    edges = []  # (caller, callee, in a loop at the call site)
    for fn in methods.values():
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and isinstance(
                    node.func.value, ast.Name) and \
                    node.func.value.id == "self" and \
                    node.func.attr in methods:
                edges.append((fn, methods[node.func.attr],
                              _in_loop(node, fn)))
    reach = {fn for fn in methods.values() if is_hot(fn)}
    out: dict = {}
    changed = True
    while changed:
        changed = False
        for caller, callee, looped in edges:
            if caller in reach and callee not in reach:
                reach.add(callee)
                changed = True
            if caller in reach and callee not in out and (
                    looped or caller in out):
                out[callee] = _qualname(caller)
                changed = True
    return out


def _in_loop(node, fn) -> bool:
    """True when node sits in a loop or comprehension of fn."""
    cur = getattr(node, "_bl_parent", None)
    while cur is not None and cur is not fn:
        if isinstance(cur, (ast.For, ast.AsyncFor, ast.While,
                            ast.comprehension, ast.ListComp, ast.SetComp,
                            ast.DictComp, ast.GeneratorExp)):
            return True
        cur = getattr(cur, "_bl_parent", None)
    return False


class ModuleLint:
    """One source file through every level-1 rule."""

    def __init__(self, path: str, source: str, cfg: LintConfig,
                 relpath: str | None = None):
        self.path = relpath if relpath is not None else path
        self.source = source
        self.cfg = cfg
        self.findings: list = []
        self.tree = ast.parse(source, filename=path)
        _annotate_parents(self.tree)
        self.lines = source.splitlines()

    def run(self) -> list:
        self._looped = {}
        for cls in ast.walk(self.tree):
            if isinstance(cls, ast.ClassDef):
                self._looped.update(_calls_in_loops(cls, self._is_hot))
        for fn in self._all_defs():
            if self._is_hot(fn):
                self._scan_hot(fn)
                self._check_ep001(fn)
                self._check_ep002(fn)
        self._check_nvcc_flags()
        return self.findings

    def _emit(self, rule, node, message, severity="error"):
        line = getattr(node, "lineno", 1)
        ctx = self.lines[line - 1].strip() if line - 1 < len(self.lines) \
            else ""
        self.findings.append(Finding(rule, self.path, line, message,
                                     severity, ctx))

    def _all_defs(self):
        return [n for n in ast.walk(self.tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]

    # -- HS001: hot host functions --------------------------------------------

    def _is_hot(self, fn) -> bool:
        qn = _qualname(fn)
        for path_suffix, pattern in self.cfg.hot_functions:
            if self.path.endswith(path_suffix) and fnmatch.fnmatch(
                    qn, pattern):
                return True
        return False

    def hot_spans(self) -> list:
        """(first line, last line, qualname) of every hot function."""
        return [(fn.lineno, fn.end_lineno, _qualname(fn))
                for fn in self._all_defs() if self._is_hot(fn)]

    @staticmethod
    def _in_chain(node) -> bool:
        """True when node is a host read of a value already read to the
        host (``x.cpu().numpy()``: only ``.cpu()`` counts)."""
        return host_read(node) is not None and any(
            isinstance(n, ast.Call) and host_read(n) is not None
            for n in ast.walk(host_read(node)[1]))

    def _scan_hot(self, fn):
        transfers: dict = {}  # unparsed arg -> [(node, arg)]
        own_nodes = [n for n in ast.walk(fn)
                     if self._owner_fn(n) is fn]
        for node in own_nodes:
            if not isinstance(node, (ast.Call, ast.Subscript)) or \
                    self._in_chain(node):
                continue
            fd = dotted(getattr(node, "func", None))
            read = host_read(node)
            h2d = h2d_copy(node) or list_index(node)
            is_sync = fd in SYNC_CALLS
            is_coerce = fd in COERCERS and bool(node.args) and not isinstance(
                node.args[0], ast.Constant) and not any(
                    host_read(n) for n in ast.walk(node.args[0]))
            if read is not None:
                transfers.setdefault(ast.unparse(read[1]),
                                     []).append((node, read[1]))
            label = read[0] if read else h2d or f"`{fd}()`"
            if (read or h2d or is_sync or is_coerce) and \
                    self._loop_depth(node, fn) > 0:
                self._emit(
                    "HS001", node,
                    f"{label} inside a loop of hot function "
                    f"`{_qualname(fn)}` — a host sync with the device per "
                    f"iteration; hoist to one transfer per batch/round")
            elif (read or h2d or is_sync) and fn in self._looped:
                self._emit(
                    "HS001", node,
                    f"{label} in hot function `{_qualname(fn)}`, which runs "
                    f"inside a loop (from `{self._looped[fn]}`) — a host "
                    f"sync with the device per iteration; hoist to one "
                    f"transfer per batch/round")
        # duplicate-transfer grouping: two same-text transfers count only
        # when (a) both can execute in one pass (no mutually exclusive `if`
        # arms between them) and (b) no name the expression reads is
        # reassigned between the two sites (a rebound `ids` is a new value)
        stores = sorted(
            (n.lineno, n.id) for n in own_nodes
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store))
        for src, sites in transfers.items():
            if len(sites) < 2:
                continue
            sites.sort(key=lambda p: p[0].lineno)
            done = False
            for i in range(1, len(sites)):
                cur, arg = sites[i]
                roots = {nm.id for nm in ast.walk(arg)
                         if isinstance(nm, ast.Name)}
                sig_cur = self._branch_sig(cur, fn)
                for prev, _a in sites[:i]:
                    sig_prev = self._branch_sig(prev, fn)
                    if any(sig_cur.get(key, arm) != arm
                           for key, arm in sig_prev.items()):
                        continue  # mutually exclusive branches
                    if any(prev.lineno < ln < cur.lineno and nm in roots
                           for ln, nm in stores):
                        continue  # rebound between the sites
                    if self._assign_targets(prev) & self._none_guards(
                            cur, fn):
                        continue  # lazy-memo idiom: `if x is None: x = ...`
                    self._emit(
                        "HS001", cur,
                        f"repeated host transfer of `{src}` in hot "
                        f"function `{_qualname(fn)}` ({len(sites)} sites) "
                        f"— transfer once and reuse the host value")
                    done = True
                    break
                if done:
                    break

    # -- EP001: epoch-consistency of tiered reads ---------------------------

    def _check_ep001(self, fn):
        """Serving hot paths must read tiered ingest state through ONE
        ``snapshot()`` taken at batch-formation time. A direct read of a
        mutable ``TieredTable`` field (``_hot``/``_cold``/``_sealing``/...)
        can observe a DIFFERENT epoch than the rest of the batch when a
        background compaction swaps mid-flight — mixed-epoch row ids are
        silently wrong, not crashes. The detector is textual by design: any
        attribute access whose base expression mentions ``tiered`` and
        whose attr is a registered mutable field."""
        banned = set(TIERED_MUTABLE_FIELDS)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Attribute) or \
                    self._owner_fn(node) is not fn:
                continue
            if node.attr not in banned:
                continue
            base = ast.unparse(node.value)
            if "tiered" not in base:
                continue
            self._emit(
                "EP001", node,
                f"hot function `{_qualname(fn)}` reads mutable tiered "
                f"state `{base}.{node.attr}` directly — a background "
                f"compaction can swap the epoch mid-batch and mix row-id "
                f"spaces; take one `tiered.snapshot()` at batch formation "
                f"and read `(epoch, cold, hot_views)` from it")

    # -- EP002: freshness of semantic-cache reads ----------------------------

    def _check_ep002(self, fn):
        """Serving hot paths must not read semantic-cache entry payloads
        (``ids``/``scores``/``centroids``) without a freshness check: a raw
        entry read can serve a result computed under a PREVIOUS epoch —
        resurrecting pre-compaction row ids — or one that predates a
        hot-tier insert. The sanctioned read is ``SemanticCache.lookup()``
        (it enforces the ``(epoch, n_rows)`` token internally); a function
        that compares an entry's ``token``/``epoch`` explicitly also
        qualifies. Textual like EP001: attribute reads whose base mentions
        ``cache`` or ``entry``."""
        if self._has_freshness_check(fn):
            return
        banned = set(CACHE_ENTRY_FIELDS)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Attribute) or \
                    self._owner_fn(node) is not fn:
                continue
            if node.attr not in banned:
                continue
            base = ast.unparse(node.value).lower()
            if "cache" not in base and "entry" not in base:
                continue
            self._emit(
                "EP002", node,
                f"hot function `{_qualname(fn)}` reads cache-entry payload "
                f"`{base}.{node.attr}` without a freshness check — a stale "
                f"entry can resurrect pre-compaction results; go through "
                f"`SemanticCache.lookup()` (token-checked) or compare the "
                f"entry's token against the current `(epoch, n_rows)` first")

    def _has_freshness_check(self, fn) -> bool:
        """True when fn reads the cache through lookup() or explicitly
        compares a token/epoch attribute (either side of any comparison)."""
        for node in ast.walk(fn):
            if self._owner_fn(node) is not fn:
                continue
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "lookup":
                return True
            if isinstance(node, ast.Compare):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Attribute) and \
                            sub.attr in ("token", "epoch"):
                        return True
        return False

    # -- PL001: the kernels' build flags -------------------------------------

    def _check_nvcc_flags(self):
        """A module-level ``NVCC_FLAGS`` holding a flag that flushes
        denormals or relaxes IEEE division / square roots."""
        for node in self.tree.body:
            if not isinstance(node, ast.Assign) or not any(
                    isinstance(t, ast.Name) and t.id == "NVCC_FLAGS"
                    for t in node.targets):
                continue
            for c in ast.walk(node.value):
                if isinstance(c, ast.Constant) and isinstance(c.value, str) \
                        and c.value.lstrip("-") in FAST_MATH_FLAGS:
                    self._emit(
                        "PL001", c,
                        f"NVCC_FLAGS carries `{c.value}` — it flushes "
                        f"denormals or relaxes IEEE division/sqrt, and the "
                        f"port's exact ±1.4e-45 predicate bounds depend on "
                        f"neither happening")

    # -- helpers --------------------------------------------------------------

    @staticmethod
    def _assign_targets(node) -> set:
        """Names the nearest enclosing Assign binds (node on its RHS)."""
        prev, cur = node, getattr(node, "_bl_parent", None)
        while cur is not None and not isinstance(cur, ast.stmt):
            prev, cur = cur, getattr(cur, "_bl_parent", None)
        if isinstance(cur, ast.Assign) and prev is cur.value:
            return {n.id for t in cur.targets for n in ast.walk(t)
                    if isinstance(n, ast.Name)}
        return set()

    def _none_guards(self, node, fn) -> set:
        """Names N where node sits in the body of `if N is None:`."""
        guards: set = set()
        prev, cur = node, getattr(node, "_bl_parent", None)
        while cur is not None and cur is not fn:
            if isinstance(cur, ast.If) and any(prev is s for s in cur.body):
                t = cur.test
                if isinstance(t, ast.Compare) and len(t.ops) == 1 and \
                        isinstance(t.ops[0], ast.Is) and \
                        isinstance(t.left, ast.Name) and isinstance(
                            t.comparators[0], ast.Constant) and \
                        t.comparators[0].value is None:
                    guards.add(t.left.id)
            prev, cur = cur, getattr(cur, "_bl_parent", None)
        return guards

    def _branch_sig(self, node, fn) -> dict:
        """{id(if-node): arm} for every `if` between node and fn — two
        nodes with the same if on different arms never co-execute."""
        sig = {}
        prev, cur = node, getattr(node, "_bl_parent", None)
        while cur is not None and cur is not fn:
            if isinstance(cur, ast.If) and prev is not cur.test:
                in_body = any(prev is s for s in cur.body)
                sig[id(cur)] = "body" if in_body else "orelse"
            prev, cur = cur, getattr(cur, "_bl_parent", None)
        return sig

    def _owner_fn(self, node):
        cur = getattr(node, "_bl_parent", None)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return cur
            cur = getattr(cur, "_bl_parent", None)
        return None

    def _loop_depth(self, node, fn) -> int:
        depth = 0
        prev = node
        cur = getattr(node, "_bl_parent", None)
        while cur is not None and cur is not fn:
            if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)):
                depth += 1
            elif isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
            prev, cur = cur, getattr(cur, "_bl_parent", None)
        # a While's test runs every iteration too
        if isinstance(cur, ast.While) and prev is cur.test:
            depth += 1
        return depth


def lint_source(path: str, source: str, cfg: LintConfig | None = None,
                relpath: str | None = None) -> list:
    """Lint one module's source. Returns raw findings (suppressions are
    applied by the runner)."""
    return ModuleLint(path, source, cfg or LintConfig(), relpath).run()
