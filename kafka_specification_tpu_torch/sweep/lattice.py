"""Declarative config lattices (``kspec-sweep-lattice/1``).

A lattice names a base TLC .cfg plus AXES — each axis varies one
CONSTANT (ints, or replica-set sizes for model-value sets), one
exploration bound (``max_depth`` / ``max_states``), or the module
itself (model variants; product mixes ride the authored ``Partitions``
constant like any other axis).  Enumeration takes the cartesian
product per sheet and synthesizes each point a complete, standalone
.cfg text — the point IS an ordinary job, bit-identical to what `cli
check` or `cli submit` would run by hand.

Canonical keying.  Every point resolves to the state-space cache's own
:class:`~..service.state_cache.CacheKey` (module, kernel source,
canonical CONSTANTS, resolved ordered invariants, constraints, deadlock
flag, bounds) and its ``point_id`` is that key's content address
(``<base16-base-digest>:<bounds>``).  The sweep therefore keys the SAME
namespace the cache does: a repeat sweep's points are O(verify) hits, a
deeper-bound point finds its shallower sibling's boundary, and two
axis paths that synthesize the same config dedupe to one point.

Static vacuity skip.  Before any exploration is paid for, each distinct
shape runs the ``kspec analyze`` action passes
(analysis/encoding.analyze_model, on CPU tensors): a point whose
CONSTANTS statically disable one or more actions (``vacuous-action``
findings — its distinguishing behavior cannot occur) is skipped or
deferred per the lattice's ``on_vacuous`` policy, and the finding
travels with the point so the skip is auditable in the manifest and
``cli sweep report`` — never silent coverage loss.

The port's own copy of ``kafka_specification_tpu/sweep/lattice.py``.  The
JAX package analyses a point under a stub of its array library; the
port's analyser is torch code (``IVal`` works through
``__torch_function__``), so :func:`vacuous_findings` imports torch
lazily and runs on CPU tensors only, never initialising CUDA.  Everything
else here is torch-free.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from ..service.state_cache import CacheKey, canonical_constants
from ..utils.cfg import parse_cfg, resolved_invariants

LATTICE_SCHEMA = "kspec-sweep-lattice/1"

#: what to do with a point whose model carries vacuous-action findings
ON_VACUOUS = ("skip", "defer", "run")


@dataclass(frozen=True)
class Axis:
    """One lattice dimension.

    kind:
      ``constant`` — vary CONSTANTS[name]; int values replace an int
        constant directly, and for a model-value-set constant (e.g.
        ``Replicas = {b1, b2}``) an int N means "a set of N values"
        (named from the base set's prefix);
      ``bound``    — vary ``max_depth`` or ``max_states`` (null = unbounded);
      ``module``   — vary the TLA+ module itself (model variants).
    """

    name: str
    values: tuple
    kind: str = "constant"

    def record(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "values": list(self.values)}


@dataclass
class LatticeSheet:
    """One (module, base cfg, axes) product — a lattice may union
    several sheets (e.g. an IdSequence MaxId sweep next to a
    FiniteReplicatedLog brokers x log-size sweep)."""

    module: str
    cfg_text: str
    axes: list
    kernel_source: str = "hand"

    def record(self) -> dict:
        return {
            "module": self.module,
            "cfg_text": self.cfg_text,
            "kernel_source": self.kernel_source,
            "axes": [a.record() for a in self.axes],
        }


@dataclass
class LatticeSpec:
    name: str
    sheets: list
    on_vacuous: str = "skip"
    source_path: Optional[str] = None

    def record(self) -> dict:
        return {
            "schema": LATTICE_SCHEMA,
            "name": self.name,
            "on_vacuous": self.on_vacuous,
            "sheets": [s.record() for s in self.sheets],
        }

    def axis_names(self) -> list:
        seen: list = []
        for s in self.sheets:
            for a in s.axes:
                if a.name not in seen:
                    seen.append(a.name)
        return seen


@dataclass
class LatticePoint:
    """One enumerated config — a complete, standalone unit of work."""

    point_id: str
    module: str
    cfg_text: str
    kernel_source: str
    coords: tuple  # ((axis_name, value), ...) in sheet axis order
    max_depth: Optional[int]
    max_states: Optional[int]
    key: CacheKey
    vacuous: list = field(default_factory=list)  # finding records

    def record(self) -> dict:
        return {
            "point_id": self.point_id,
            "module": self.module,
            "coords": [[n, v] for n, v in self.coords],
            "max_depth": self.max_depth,
            "max_states": self.max_states,
            "base_digest": self.key.base_digest(),
            "kernel_source": self.kernel_source,
        }


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------


def _axis_from_record(rec: dict) -> Axis:
    kind = rec.get("kind", "constant")
    if "bound" in rec and "name" not in rec:  # {"bound": "max_depth", ...}
        kind, name = "bound", rec["bound"]
    else:
        name = rec.get("name") or rec.get("constant")
        if rec.get("constant"):
            kind = "constant"
        if rec.get("kind"):
            kind = rec["kind"]
    if not name:
        raise ValueError(f"axis needs a name: {rec!r}")
    if kind == "bound" and name not in ("max_depth", "max_states"):
        raise ValueError(f"bound axis must be max_depth|max_states: {name!r}")
    if kind not in ("constant", "bound", "module"):
        raise ValueError(f"unknown axis kind {kind!r}")
    values = rec.get("values")
    if not isinstance(values, list) or not values and values != [None]:
        raise ValueError(f"axis {name!r} needs a non-empty values list")
    return Axis(name=name, values=tuple(
        tuple(v) if isinstance(v, list) else v for v in values
    ), kind=kind)


def _sheet_from_record(rec: dict, base_dir: Path) -> LatticeSheet:
    cfg_text = rec.get("cfg_text")
    if cfg_text is None:
        base = rec.get("base_cfg")
        if base is None:
            raise ValueError("sheet needs cfg_text or base_cfg")
        p = Path(base)
        if not p.is_absolute():
            p = base_dir / p
        cfg_text = p.read_text()
    module = rec.get("module")
    if not module:
        raise ValueError("sheet needs a module")
    axes = [_axis_from_record(a) for a in rec.get("axes", [])]
    ks = rec.get("kernel_source", "hand")
    if ks not in ("auto", "emitted", "hand"):
        raise ValueError(f"bad kernel_source {ks!r}")
    return LatticeSheet(module=module, cfg_text=cfg_text, axes=axes,
                        kernel_source=ks)


def load_lattice(path_or_record) -> LatticeSpec:
    """Load a ``kspec-sweep-lattice/1`` spec from a JSON file path or an
    already-parsed record dict."""
    if isinstance(path_or_record, dict):
        rec, base_dir, src = path_or_record, Path("."), None
    else:
        p = Path(path_or_record)
        rec = json.loads(p.read_text())
        base_dir, src = p.parent, str(p)
    if rec.get("schema") != LATTICE_SCHEMA:
        raise ValueError(
            f"not a {LATTICE_SCHEMA} record (schema={rec.get('schema')!r})"
        )
    sheets_rec = rec.get("sheets")
    if sheets_rec is None:
        # single-sheet shorthand: module/base_cfg/axes at top level
        sheets_rec = [rec]
    sheets = [_sheet_from_record(s, base_dir) for s in sheets_rec]
    if not sheets:
        raise ValueError("lattice has no sheets")
    on_vac = rec.get("on_vacuous", "skip")
    if on_vac not in ON_VACUOUS:
        raise ValueError(f"on_vacuous must be one of {ON_VACUOUS}")
    return LatticeSpec(
        name=rec.get("name") or (sheets[0].module if sheets else "lattice"),
        sheets=sheets,
        on_vacuous=on_vac,
        source_path=src,
    )


# --------------------------------------------------------------------------
# enumeration
# --------------------------------------------------------------------------


def _apply_constant(constants: dict, name: str, value):
    """Override one CONSTANT.  For model-value-set constants an int N
    means a set of N values, named from the base set's prefix (so
    ``Replicas = {b1, b2}`` swept to 3 becomes ``{b1, b2, b3}`` — the
    engine maps names to indices, only the SIZE is semantic)."""
    base = constants.get(name)
    if isinstance(base, list) and isinstance(value, int):
        prefix = "".join(c for c in str(base[0]) if not c.isdigit()) or "v"
        constants[name] = [f"{prefix}{i + 1}" for i in range(value)]
    elif isinstance(value, tuple):
        constants[name] = list(value)
    else:
        constants[name] = value


def _render_cfg(cfg) -> str:
    """Synthesize standalone TLC .cfg text from a parsed config — the
    point's complete unit of work (travels inline in the job spec)."""
    lines = [f"SPECIFICATION {cfg.specification or 'Spec'}", "CONSTANTS"]
    for k, v in cfg.constants.items():
        if isinstance(v, list):
            lines.append(f"    {k} = {{{', '.join(str(x) for x in v)}}}")
        else:
            lines.append(f"    {k} = {v}")
    if cfg.invariants:
        lines.append("INVARIANTS " + " ".join(cfg.invariants))
    if cfg.constraints:
        lines.append("CONSTRAINT " + " ".join(cfg.constraints))
    lines.append(
        f"CHECK_DEADLOCK {'TRUE' if cfg.check_deadlock else 'FALSE'}"
    )
    return "\n".join(lines) + "\n"


def point_key(module: str, cfg, emitted: bool,
              max_depth, max_states) -> CacheKey:
    """The state-cache key this point's job resolves to — EXACTLY
    service/state_cache.key_for_job's resolution, so sweep bookkeeping
    and the cache share one content address."""
    return CacheKey(
        module=module,
        emitted=bool(emitted),
        constants=canonical_constants(cfg.constants),
        invariants=tuple(resolved_invariants(module, cfg)),
        constraints=tuple(cfg.constraints),
        check_deadlock=bool(cfg.check_deadlock),
        max_depth=max_depth,
        max_states=max_states,
    )


def enumerate_points(spec: LatticeSpec) -> list:
    """Cartesian product per sheet, union across sheets, deduped on the
    canonical point_id (two axis paths synthesizing the same config are
    ONE point).  Submit-stable order: sheets in spec order, coordinates
    in row-major axis order."""
    import copy

    out: list = []
    seen: set = set()
    for sheet in spec.sheets:
        base = parse_cfg(sheet.cfg_text)
        axes = sheet.axes or [Axis("_base", (None,), "bound")]
        # kernel_source resolution is static per sheet ("auto" keys as
        # emitted iff the reference checkout has the module — same rule
        # as the daemon's resolve_kernel_source, evaluated lazily only
        # when someone actually asked for auto)
        emitted = _resolve_emitted(sheet.kernel_source, sheet.module)
        for combo in itertools.product(*(a.values for a in axes)):
            cfg = copy.deepcopy(base)
            module = sheet.module
            max_depth = max_states = None
            coords = []
            for axis, value in zip(axes, combo):
                if axis.name == "_base":
                    continue
                coords.append((axis.name, value))
                if axis.kind == "module":
                    module = value
                elif axis.kind == "bound":
                    if axis.name == "max_depth":
                        max_depth = value
                    else:
                        max_states = value
                else:
                    _apply_constant(cfg.constants, axis.name, value)
            key = point_key(module, cfg, emitted, max_depth, max_states)
            pid = f"{key.base_digest()}:{key.bounds_name()}"
            if pid in seen:
                continue
            seen.add(pid)
            out.append(LatticePoint(
                point_id=pid,
                module=module,
                cfg_text=_render_cfg(cfg),
                kernel_source=sheet.kernel_source,
                coords=tuple(coords),
                max_depth=max_depth,
                max_states=max_states,
                key=key,
            ))
    return out


def _resolve_emitted(kernel_source: str, module: str) -> bool:
    if kernel_source == "emitted":
        return True
    if kernel_source == "hand":
        return False
    from ..service.kernel_cache import resolve_kernel_source

    return resolve_kernel_source("auto", module)


# --------------------------------------------------------------------------
# static vacuity (the pre-exploration skip)
# --------------------------------------------------------------------------

#: per-process memo: one abstract-interpretation pass per distinct
#: model shape (module, emitted, constants, constraints) — a lattice
#: whose points differ only in bounds/invariants analyzes each shape once
_VACUOUS_MEMO: dict = {}


def vacuous_findings(module: str, cfg_text: str) -> list:
    """``vacuous-action`` finding records for this (module, CONSTANTS)
    shape, via the interval analyser (analysis/encoding.analyze_model)
    on CPU tensors.  Returns [] when the shape analyzes clean; an
    UNANALYZABLE shape also returns [] — vacuity skipping is an
    optimization and must never veto a point the engine could
    legitimately run.  A box without torch fails here, loudly: planning
    with no vacuity pass would give another manifest."""
    cfg = parse_cfg(cfg_text)
    memo_key = (module, canonical_constants(cfg.constants),
                tuple(cfg.constraints))
    hit = _VACUOUS_MEMO.get(memo_key)
    if hit is not None:
        return list(hit)
    import torch  # noqa: F401  (outside the advisory except below)

    from ..analysis.encoding import analyze_model
    from ..utils.cfg import build_model

    try:
        model = build_model(module, cfg, analysis_gate=False)
        found = [
            f.record() for f in analyze_model(model)
            if f.kind == "vacuous-action" and not f.suppressed
        ]
    except Exception:  # noqa: BLE001 — analysis is advisory here
        found = []
    _VACUOUS_MEMO[memo_key] = found
    return list(found)


def annotate_vacuous(points: list) -> list:
    """Attach vacuous-action findings to each point (memoized per
    shape); returns the same list for chaining."""
    for p in points:
        p.vacuous = vacuous_findings(p.module, p.cfg_text)
    return points
