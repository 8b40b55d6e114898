"""boomlint for the port (``repro_torch.analysis``): golden fixtures, the
runtime checks, the shipped tree's gate, and parity with the JAX package's
``repro.analysis`` on its framework-neutral fixtures.

The port's fixtures live in ``tests/fixtures/boomlint_torch/`` (torch
idioms, ``NVCC_FLAGS``, ptxas reports); the parity cases read the
reference's ``tests/fixtures/boomlint/``.
"""
import collections
import json
import os
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

from repro.analysis import astpass as ref_astpass  # noqa: E402
from repro.analysis import suppressions as ref_sup  # noqa: E402
from repro.analysis.config import LintConfig as RefConfig  # noqa: E402
from repro.analysis.findings import Finding as RefFinding  # noqa: E402
from repro_torch.analysis import astpass, cli, runtimepass  # noqa: E402
from repro_torch.analysis import suppressions as sup  # noqa: E402
from repro_torch.analysis.config import LintConfig  # noqa: E402
from repro_torch.analysis.findings import Finding  # noqa: E402
from repro_torch.analysis.runner import run_paths  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIX = ROOT / "tests" / "fixtures" / "boomlint_torch"
REF_FIX = ROOT / "tests" / "fixtures" / "boomlint"
PORT_SRC = ROOT / "src" / "repro_torch"
BASELINE = ROOT / "boomlint_torch.baseline.json"

HOT = (("hs001_bad.py", "hot_*"), ("hs001_bad.py", "Hot.*"),
       ("hs001_clean.py", "hot_*"), ("hs001_clean.py", "Hot.*"),
       ("ep001_bad.py", "hot_*"), ("ep001_clean.py", "hot_*"),
       ("ep002_bad.py", "hot_*"), ("ep002_clean.py", "hot_*"))
FIXTURE_CFG = LintConfig(runtime=False, hot_functions=HOT)
REF_CFG = RefConfig(trace=False, hot_functions=HOT)


@pytest.fixture(autouse=True)
def _repo_cwd(monkeypatch):
    """Findings carry paths relative to the working directory, as the CLI
    run from the repository root gives them."""
    monkeypatch.chdir(ROOT)


def _scan(path, cfg=FIXTURE_CFG):
    return run_paths([str(path)], cfg)


def _rule_lines(findings, rules) -> set:
    return {(f.rule, f.line) for f in findings if f.rule in rules}


# ---------------------------------------------------------------------------
# level 1: golden fixtures
# ---------------------------------------------------------------------------

def test_hs001_bad_fixture_flags_every_torch_idiom():
    active = _scan(FIX / "hs001_bad.py")["active"]
    assert collections.Counter(f.rule for f in active) == {"HS001": 13}, \
        [f.render() for f in active]
    msgs = " | ".join(f.message for f in active)
    for label in ("`.item()`", "`.tolist()`", "`.cpu()`", "`.numpy()`",
                  '`.to("cpu")`', "`np.asarray()`", "`int()`",
                  "`torch.cuda.synchronize()`",
                  "`torch.as_tensor(..., device=)`",
                  "indexing with a host list",
                  "repeated host transfer of `ids`",
                  "runs inside a loop (from `Hot.run`)"):
        assert label in msgs, label
    assert len({f.line for f in active}) == 13


def test_hs001_clean_fixture_keeps_each_exception_of_the_duplicate_rule():
    """Exclusive arms, rebinding, the lazy memo, a chain read once, host
    sequences, device casts, a method called once and a loop outside the
    hot functions: no finding."""
    active = _scan(FIX / "hs001_clean.py")["active"]
    assert active == [], [f.render() for f in active]


def test_nvcc_flags_with_fast_math_are_a_finding():
    active = _scan(FIX / "nvcc_bad.py")["active"]
    assert [(f.rule, f.line) for f in active] == [("PL001", 3)]
    assert "--use_fast_math" in active[0].message
    assert _scan(FIX / "nvcc_clean.py")["active"] == []
    build = _scan(PORT_SRC / "kernels" / "build.py", LintConfig(
        runtime=False))
    assert build["active"] == []


# ---------------------------------------------------------------------------
# parity with the JAX package on its framework-neutral fixtures
# ---------------------------------------------------------------------------

def _both(name):
    path = REF_FIX / name
    src = path.read_text()
    rel = os.path.relpath(path).replace(os.sep, "/")
    ref = ref_astpass.lint_source(str(path), src, REF_CFG, relpath=rel)
    port = astpass.lint_source(str(path), src, FIXTURE_CFG, relpath=rel)
    return src, ref, port


@pytest.mark.parametrize("name", ["ep001_bad.py", "ep001_clean.py",
                                  "ep002_bad.py", "ep002_clean.py"])
def test_epoch_and_cache_rules_match_the_reference(name):
    _, ref, port = _both(name)
    rules = {"EP001", "EP002"}
    assert _rule_lines(port, rules) == _rule_lines(ref, rules)
    if "clean" in name:
        assert port == []
    else:
        assert _rule_lines(port, rules)


def _hot_spans(src) -> list:
    import ast

    return [(n.lineno, n.end_lineno) for n in ast.walk(ast.parse(src))
            if isinstance(n, ast.FunctionDef) and n.name.startswith("hot_")]


@pytest.mark.parametrize("name", ["hs001_bad.py", "hs001_clean.py"])
def test_hot_scope_findings_are_a_superset_of_the_reference(name):
    src, ref, port = _both(name)
    spans = _hot_spans(src)
    ref_hot = {(f.rule, f.line) for f in ref if f.rule == "HS001"
               and any(a <= f.line <= z for a, z in spans)}
    assert ref_hot <= _rule_lines(port, {"HS001"})
    if "clean" in name:
        assert port == []
    else:
        assert ref_hot  # the reference flags the hot cases too


@pytest.mark.parametrize("name", sorted(p.name for p in REF_FIX.glob("*.py")))
def test_suppression_maps_match_the_reference(name):
    src = (REF_FIX / name).read_text()
    assert sup.parse_suppressions(src) == ref_sup.parse_suppressions(src)


def test_suppressions_split_the_reference_findings_alike():
    path = REF_FIX / "suppressed.py"
    src = path.read_text()
    ref = ref_astpass.lint_source(str(path), src, REF_CFG, relpath="s.py")
    port = [Finding(**f.to_dict()) for f in ref]
    a_ref, s_ref = ref_sup.split_suppressed(
        ref, {"s.py": ref_sup.parse_suppressions(src)})
    a_port, s_port = sup.split_suppressed(
        port, {"s.py": sup.parse_suppressions(src)})
    assert [(f.rule, f.line) for f in a_port] == \
        [(f.rule, f.line) for f in a_ref]
    assert [(f.rule, f.line) for f in s_port] == \
        [(f.rule, f.line) for f in s_ref]
    assert len(s_port) == 2 and len(a_port) == 1


def test_a_baseline_written_by_one_package_reads_back_in_the_other(tmp_path):
    findings = []
    for name in ("hs001_bad.py", "ep001_bad.py", "ep002_bad.py"):
        findings += _both(name)[1]
    as_port = [Finding(**f.to_dict()) for f in findings]
    ref_path, port_path = tmp_path / "ref.json", tmp_path / "port.json"
    ref_sup.Baseline.from_findings(findings).save(str(ref_path))
    sup.Baseline.from_findings(as_port).save(str(port_path))
    assert ref_path.read_text() == port_path.read_text()
    assert sup.Baseline.load(str(ref_path)).filter(as_port) == []
    assert ref_sup.Baseline.load(str(port_path)).filter(findings) == []
    extra = Finding("HS001", "x.py", 1, "m", context="y = x.cpu()")
    assert sup.Baseline.load(str(ref_path)).filter(as_port + [extra]) == \
        [extra]
    # and the findings' JSON is the same, field for field
    from repro.analysis.findings import to_json as ref_to_json
    from repro_torch.analysis.findings import to_json

    assert to_json(as_port) == ref_to_json(
        [RefFinding(**f.to_dict()) for f in as_port])


# ---------------------------------------------------------------------------
# the shipped tree
# ---------------------------------------------------------------------------

def test_the_port_lints_clean_against_its_baseline():
    """AST only: every entry but the kernels' ptxas ones (level 2 on the
    card's report) is consumed, and nothing is left over."""
    baseline = sup.Baseline.load(str(BASELINE))
    res = run_paths([str(PORT_SRC)], LintConfig(runtime=False),
                    baseline=baseline)
    assert res["active"] == [], [f.render() for f in res["active"]]
    assert res["baselined"] == sum(not c.startswith("ptxas:")
                                   for _, _, c in baseline.entries)
    assert len(res["suppressed"]) >= 2


def test_every_inline_ignore_in_the_port_carries_a_reason():
    n = 0
    for path in PORT_SRC.rglob("*.py"):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            m = re.search(r"#\s*boomlint:\s*ignore\[[^\]]+\]\s*(.*)", line)
            if m:
                n += 1
                assert m.group(1).strip(), f"{path}:{i} ignore without a " \
                                           f"reason"
    assert n >= 2


def test_every_baselined_finding_carries_a_reason(tmp_path):
    """Each entry says what it reads (the parked speed list, keyed as the
    baseline is), and ``--write-baseline`` keeps the reasons it still
    finds."""
    baseline = sup.Baseline.load(str(BASELINE))
    assert baseline.entries
    for key in baseline.entries:
        assert baseline.reasons.get(key, "").strip(), key
    out = tmp_path / "rewritten.json"
    assert cli.main(["src/repro_torch", "--no-runtime", "--baseline",
                     str(BASELINE), "--write-baseline", str(out)]) == 0
    again = sup.Baseline.load(str(out))
    ast_keys = [k for k in baseline.entries if not k[2].startswith("ptxas:")]
    assert sorted(again.entries) == sorted(ast_keys)
    assert again.reasons == {k: baseline.reasons[k] for k in ast_keys}


def test_cli_gates_the_port_ast_only(capsys):
    rc = cli.main(["src/repro_torch", "--baseline", str(BASELINE),
                   "--no-runtime"])
    assert rc == 0, capsys.readouterr()
    assert cli.main([str(FIX / "hs001_bad.py"), "--no-runtime"]) == 0
    assert cli.main([str(FIX / "nvcc_bad.py"), "--no-runtime"]) == 1


# ---------------------------------------------------------------------------
# level 2: CM001 on the serving functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cm001():
    return runtimepass.check_host_reads()


def test_cm001_the_port_keeps_the_collective_and_host_read_contract(cm001):
    findings, report = cm001
    assert findings == [], [f.render() for f in findings]
    assert set(report) == {"gather_score_ref", "gather_score_kernel",
                           "filter_first_local_batch", "search_local_batch",
                           "sharded_batch_topk", "sharded_ivf_topk"}
    merge = report["sharded_batch_topk"]
    assert 1 <= merge["collectives"].get("all_gather", 0) <= 2
    assert merge["host_reads"] == 0
    for label, r in report.items():
        assert isinstance(r["host_reads"], int)
        if label != "sharded_batch_topk":
            assert r["collectives"] == {}, label


def _merge_twin(monkeypatch, kind):
    """Plant one breach of the merge contract in ``sharded_batch_topk``."""
    import torch.distributed as dist

    from repro_torch.vectordb import distributed

    merge, packed = distributed._merge_shard_candidates, \
        distributed._gather_packed

    def merge_with(s_all, g_all, *, k):
        if kind == "extra collective" and dist.is_initialized():
            dist.all_reduce(torch.zeros(1))
        elif kind == "host read" and dist.is_initialized():
            float(s_all.max())
        return merge(s_all, g_all, k=k)

    def gather_times(n):
        def run(tensors, mesh, data_axes):
            for _ in range(n - 1):
                packed(tensors, mesh, data_axes)
            return packed(tensors, mesh, data_axes) if n else list(tensors)
        return run

    monkeypatch.setattr(distributed, "_merge_shard_candidates", merge_with)
    if kind == "no merge":
        monkeypatch.setattr(distributed, "_gather_packed", gather_times(0))
    elif kind == "three gathers":
        monkeypatch.setattr(distributed, "_gather_packed", gather_times(3))


@pytest.mark.parametrize("kind,context", [
    ("extra collective", "runtime:sharded_batch_topk:all_reduce"),
    ("host read", "runtime:sharded_batch_topk:host_read"),
    ("no merge", "runtime:sharded_batch_topk:missing"),
    ("three gathers", "runtime:sharded_batch_topk:all_gather"),
])
def test_cm001_bad_twins_of_the_sharded_merge(monkeypatch, kind, context):
    _merge_twin(monkeypatch, kind)
    findings, report = runtimepass.check_host_reads()
    assert [f.context for f in findings] == [context], \
        [f.render() for f in findings]
    assert findings[0].rule == "CM001"
    assert findings[0].path == "src/repro_torch/vectordb/distributed.py"
    if kind == "host read":
        assert report["sharded_batch_topk"]["host_reads"] == 1


def test_the_kernel_route_stand_in_agrees_with_the_plain_path():
    """The CM001 run of the gather entry's CUDA route (padding, blocks,
    merge) with the plain per-block stand-in gives the plain path's
    answer on the fixture."""
    from repro_torch.kernels import gather_score as gs

    vectors, scalars, q_b, pred_b, w_b = runtimepass._fixture()
    b = q_b.shape[0]
    cand = torch.randint(-1, 256, (b, 300), generator=torch.Generator()
                         .manual_seed(0), dtype=torch.int32)
    fields = gs._pred_fields(pred_b, b, scalars.shape[1], "cpu")
    want = gs.gather_score_topk(cand, (vectors,), (q_b,), w_b, scalars,
                                pred_b, k=8)
    got = gs.kernel_route(cand, (vectors,), (q_b,), w_b, scalars, *fields,
                          k=8, metric="dot", block_s=gs.GATHER_BLOCK_S,
                          scales=None, apply_pred=True,
                          blocks=runtimepass._plain_blocks)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    assert torch.equal(got[2].long(), want[2].long())


# ---------------------------------------------------------------------------
# level 2: PL001 on the kernels' ptxas reports
# ---------------------------------------------------------------------------

def test_pl001_clean_reports_fit_the_card():
    findings, rows = runtimepass.check_kernel_resources(
        LintConfig(ptxas_logs=str(FIX / "ptxas_clean")))
    assert findings == [], [f.render() for f in findings]
    assert {r["kernel"] for r in rows} == {
        "gather_score_kernel<true>", "gather_score_kernel<false>",
        "gather_score_int8_kernel<true>", "gather_score_int8_kernel<false>",
        "masked_topk_kernel<signed char, false>",
        "masked_topk_kernel<float, true>", "masked_topk_kernel<float, false>"}
    scan = next(r for r in rows if r["kernel"].startswith("masked"))
    assert (scan["threads"], scan["min_ctas"], scan["resident_ctas"]) == \
        (512, 2, 2)


def test_pl001_bad_reports_are_findings():
    """A spill, a stack frame, registers over the launch bounds' budget,
    shared memory over 48 KB without an opt-in, and an opt-in threshold
    whose static bytes push it past 48 KB."""
    findings, _ = runtimepass.check_kernel_resources(
        LintConfig(ptxas_logs=str(FIX / "ptxas_bad")))
    assert {f.context for f in findings} == {
        "ptxas:gather_score_kernel<true>:spill",
        "ptxas:gather_score_int8_kernel<true>:smem_optin",
        "ptxas:masked_topk_kernel<signed char, false>:stack",
        "ptxas:masked_topk_kernel<float, true>:registers",
        "ptxas:masked_topk_kernel<float, false>:smem_envelope",
        "ptxas:masked_topk_kernel<float, false>:smem_launcher"}
    assert all(f.rule == "PL001" for f in findings)


def test_a_missing_report_is_an_error_that_names_it(tmp_path, monkeypatch,
                                                    capsys):
    from repro_torch.kernels import build

    findings, _ = runtimepass.check_kernel_resources(
        LintConfig(ptxas_logs=str(tmp_path)))
    assert sorted(f.context for f in findings) == [
        "ptxas:gather_score:missing", "ptxas:masked_topk:missing"]
    assert str(os.path.relpath(tmp_path / "gather_score.log")) in \
        findings[0].message
    # no --ptxas-logs and no built library: the CLI fails, naming the log
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    assert cli.main([str(FIX / "nvcc_clean.py")]) == 1
    out = capsys.readouterr().out
    assert "no nvcc -Xptxas -v report at" in out
    assert build.library_path("masked_topk").with_suffix(".log").name in out


def test_cli_json_reports_the_host_reads_as_numbers(capsys):
    rc = cli.main([str(FIX / "nvcc_clean.py"), "--json", "--ptxas-logs",
                   str(FIX / "ptxas_clean")])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0 and payload["findings"] == []
    assert set(payload["host_reads"]) >= {"sharded_batch_topk",
                                          "search_local_batch"}
    assert all(isinstance(n, int) for n in payload["host_reads"].values())
    assert len(payload["runtime"]["kernels"]) == 7


def test_ptxas_parser_and_demangler():
    text = (FIX / "ptxas_bad" / "masked_topk.log").read_text()
    funcs = runtimepass.parse_ptxas(text)
    assert [f["name"] for f in funcs] == [
        "masked_topk_kernel<float, false>",
        "masked_topk_kernel<signed char, false>",
        "masked_topk_kernel<float, true>"]
    assert funcs[0]["smem"] == 46500 and funcs[1]["stack"] == 16
    assert funcs[2]["registers"] == 72 and all(f["entry"] for f in funcs)
    assert runtimepass.demangle("_Z3fooILi7EEvv") == "foo<7>"
    assert runtimepass.demangle("kernel") == "kernel"


def test_launch_specs_and_smem_come_from_the_sources_and_launchers():
    from repro_torch.kernels import build

    g = runtimepass.cu_launch_specs((build.CSRC / "gather_score.cu")
                                    .read_text())
    s = runtimepass.cu_launch_specs((build.CSRC / "masked_topk.cu")
                                    .read_text())
    assert g == {k: dict(threads=256, min_ctas=1, optin=32 * 1024)
                 for k in ("gather_score_kernel",
                           "gather_score_int8_kernel")}
    assert s == {"masked_topk_kernel": dict(threads=512, min_ctas=2,
                                            optin=None)}
    assert runtimepass.launcher_smem() == {
        "gather_score_kernel": (4 * 768 * 4, 48 * 1024),
        "gather_score_int8_kernel": (4 * 768 * 4, 48 * 1024),
        "masked_topk_kernel": (768 * 4, 32 * 1024)}


def test_the_smem_formulas_follow_the_sources_layout():
    """``query_smem_bytes`` is what the launchers check and what PL001
    reads: 16-byte aligned query slices (``qoff`` in gather_score.cu, at
    least 4 floats), the scan's query as floats."""
    from repro_torch.kernels import gather_score as gs
    from repro_torch.kernels import masked_topk as mt

    assert gs.query_smem_bytes((770,)) == 772 * 4
    assert gs.query_smem_bytes((3, 5)) == (4 + 8) * 4
    assert gs.query_smem_bytes(()) == 16
    assert mt.query_smem_bytes(mt.MAX_DIM) == mt.MAX_QUERY_SMEM == 32 * 1024
    assert gs.QUERY_SMEM_MAX == 48 * 1024
    # the C launchers refuse past the same bounds
    from repro_torch.kernels import build

    gather_cu = (build.CSRC / "gather_score.cu").read_text()
    scan_cu = (build.CSRC / "masked_topk.cu").read_text()
    assert "if (smem > 48 * 1024) return" in gather_cu
    m = re.search(r"kMaxQueryFloats = (\d+) \* 1024;", scan_cu)
    assert int(m.group(1)) * 1024 == mt.MAX_DIM
