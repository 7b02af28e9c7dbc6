"""Static analysis of the port: the encoding gate, field hulls, and the
ownership and purity passes over the engine sources (``cli analyze``).

The port's copy of ``kafka_specification_tpu/analysis/__init__.py``.
``require_encoding_sound`` is the gate that ``engine/bfs.py::check`` and
``utils/cfg.py::build_model`` call before anything is explored: an action
that can write outside its declared field ranges would be masked silently
by the lane packer, so the model is refused (``models.base.
EncodingUnsound``, a ValueError carrying the interval counterexample).
``KSPEC_ANALYZE=0`` turns the gate off.  ``field_hulls`` gives the
device-resident level pipeline its proven per-field value hulls
(``analysis/encoding.py``).

``analyze_engine_sources`` runs the AST passes of ``analysis/
ownership.py`` over the port's own files: the ``THREAD_CONTRACT`` checker
over ``OWNERSHIP_MODULES`` and the purity lint (host reads inside
``# kspec: traced`` functions, iteration over sets) over
``PURITY_MODULES``.  ``analysis_record`` is the ``kspec-analysis/1``
record ``cli analyze --json`` prints.  Nothing here needs a card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field as dc_field
from typing import Optional

#: the machine-readable findings record version (as kspec-verdict/1)
ANALYSIS_SCHEMA = "kspec-analysis/1"

SEVERITIES = ("HIGH", "MEDIUM", "LOW", "INFO")

ANALYZE_ENV = "KSPEC_ANALYZE"


@dataclass(frozen=True)
class Finding:
    """One analysis finding, machine-readable.

    kind: spec-width | encoding-overflow | frame-violation |
          vacuous-action | read-of-unwritten-field | dead-field |
          analysis-skip | analysis-error |
          ownership-breach | unlocked-shared-write |
          unannotated-attribute | stale-annotation | worker-unsafe-write |
          host-materialization | set-iteration-order
    """

    kind: str
    severity: str
    target: str
    message: str
    data: dict = dc_field(default_factory=dict)
    suppressed: Optional[str] = None  # justification when downgraded

    def record(self) -> dict:
        out = {"kind": self.kind, "severity": self.severity,
               "target": self.target, "message": self.message,
               "data": self.data}
        if self.suppressed:
            out["suppressed"] = self.suppressed
        return out


def analysis_record(findings, targets=()) -> dict:
    """The ``kspec-analysis/1`` findings record (``cli analyze --json``):
    the targets, every finding, the counts by severity, and ``ok`` (no
    HIGH finding)."""
    counts = {s: 0 for s in SEVERITIES}
    for f in findings:
        counts[f.severity] = counts.get(f.severity, 0) + 1
    return {
        "schema": ANALYSIS_SCHEMA,
        "targets": list(targets),
        "findings": [f.record() for f in findings],
        "counts": counts,
        "ok": counts.get("HIGH", 0) == 0,
    }


def analysis_enabled() -> bool:
    """The gate's kill switch: KSPEC_ANALYZE=0 (or off/false/no)."""
    return os.environ.get(ANALYZE_ENV, "1").strip().lower() not in ("0", "off", "false", "no")


# models verified in this process, keyed by their structural identity
# (name, field bounds, and each action's name, fanout, write set and
# kernel code, closures included), never by name alone: a same-named model
# with other bounds or other kernels must not ride a sibling's pass
_VERIFIED_MODELS: set = set()


def _code_key(fn, depth: int = 4):
    """Identity of a kernel's code: its code object and, through its
    closure, the code and hashable constants it captured (so a product
    kernel lifting one base is told apart from one lifting another)."""
    code = getattr(fn, "__code__", None)
    if code is None or depth == 0:
        return code
    cells = []
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            v = cell.cell_contents
        except ValueError:
            continue
        if callable(v) and hasattr(v, "__code__"):
            cells.append(_code_key(v, depth - 1))
        elif hasattr(v, "kernel") and hasattr(v, "n_choices"):
            cells.append((v.name, v.n_choices, _code_key(v.kernel, depth - 1)))
        else:
            try:
                hash(v)
            except TypeError:
                continue
            cells.append(v)
    return code, tuple(cells)


def _model_memo_key(model):
    try:
        key = (
            model.name,
            tuple((f.name, f.shape, f.lo, f.hi) for f in model.spec.fields),
            tuple((a.name, a.n_choices, getattr(a, "writes", None), _code_key(a.kernel))
                  for a in model.actions),
        )
        hash(key)
        return key
    except Exception:  # noqa: BLE001 -- duck-typed doubles: verify, no memo
        return None


def require_encoding_sound(model) -> None:
    """Refuse to explore an encoding-unsound model: raises
    models.base.EncodingUnsound with the interval counterexample.
    KSPEC_ANALYZE=0 skips.  Memoized on the model's structural identity,
    so a rebuilt model of the same structure costs nothing."""
    if not analysis_enabled():
        return
    key = _model_memo_key(model)
    if key is not None and key in _VERIFIED_MODELS:
        return
    from .encoding import verify_model_encoding

    verify_model_encoding(model)
    if key is not None:
        _VERIFIED_MODELS.add(key)


def field_hulls(model, strict: bool = False) -> dict:
    """Per-field reachable-value hulls (``analysis/encoding.py``)."""
    from .encoding import field_hulls as _fh

    return _fh(model, strict=strict)


#: the port's threaded modules, each with a THREAD_CONTRACT (repo-relative)
OWNERSHIP_MODULES = (
    "kafka_specification_tpu_torch/overlap.py",
    "kafka_specification_tpu_torch/storage/tiered.py",
    "kafka_specification_tpu_torch/resilience/checkpoints.py",
)
#: the modules of the device-resident level pipeline: a host read inside a
#: `# kspec: traced` function there would put a sync into the level
PURITY_MODULES = (
    "kafka_specification_tpu_torch/engine/pipeline.py",
    "kafka_specification_tpu_torch/ops/devlevel.py",
)


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def analyze_engine_sources(root: Optional[str] = None) -> list:
    """The ownership-contract and purity/order passes over the port's
    engine sources (``analysis/ownership.py``)."""
    from .ownership import check_module_contract, lint_purity

    root = root or repo_root()
    findings = []
    for rel in OWNERSHIP_MODULES:
        findings += check_module_contract(os.path.join(root, rel), rel)
    for rel in PURITY_MODULES:
        findings += lint_purity(os.path.join(root, rel), rel)
    return findings
