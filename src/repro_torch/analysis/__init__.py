"""boomlint for the port: host-sync, epoch/cache and kernel-resource checks.

The port's counterpart of ``repro.analysis``, with its rule ids, finding
format, suppression syntax (``# boomlint: ignore[HS001] reason``) and
baseline format, so the two can be read side by side. Two levels, one
finding stream:

* **Level 1 (AST)**, :mod:`repro_torch.analysis.astpass`:
  - **HS001**: in the serving path's hot host functions
    (``config.DEFAULT_HOT_FUNCTIONS``), a device->host read inside a loop
    (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
    ``np.asarray``/``np.array``, ``int``/``float``/``bool`` of a
    non-constant), a host->device copy (``torch.as_tensor(...,
    device=)``, a host list as an index) or ``torch.cuda.synchronize()``
    inside a loop, or in a hot method a loop of its class runs: a sync per
    iteration; and the same expression read twice in one pass: a
    duplicate round-trip.
  - **EP001**: a hot function reading the tiered table's mutable fields
    (``_hot``, ``_cold``, ...) instead of one ``snapshot()``.
  - **EP002**: a hot function reading a cache entry's payload without
    ``SemanticCache.lookup()`` or a token/epoch comparison.
  - **PL001** (flags): ``--use_fast_math``, ``-ftz=true``,
    ``-prec-div=false`` or ``-prec-sqrt=false`` in ``NVCC_FLAGS``.
* **Level 2 (runtime)**, :mod:`repro_torch.analysis.runtimepass`:
  - **CM001**: the serving functions run on a tiny fixture while host
    reads and ``torch.distributed`` collectives are counted: none in the
    single-device and per-shard functions, 1..2 all-gathers and no host
    read in the sharded merge.
  - **PL001** (resources): every kernel's registers, shared memory,
    spills and stack from ``nvcc -Xptxas -v``, held to the H100's limits
    at the declared envelope.

Out of scope, each for its reason: HS001's traced scope and RC001 (nothing
is traced or jitted; ``kernels/build.library_path`` keys a build on source
and flags only, so shapes cannot cause a rebuild), SM001 (a port rank is a
process that holds only what it is passed) and PL001's ``BlockSpec`` form
(no Pallas). The CLI (``python -m repro_torch.analysis.cli``) gates on zero
unsuppressed, unbaselined findings. Rule catalog: ``docs/analysis_torch.md``.
"""
from repro_torch.analysis.config import LintConfig
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.runner import run_paths

__all__ = ["Finding", "LintConfig", "run_paths"]
