"""Encoding soundness and the action lint over built models.

The port's copy of ``kafka_specification_tpu/analysis/encoding.py``, with
the interval pass run over the port's batched kernels
(``analysis/interval.py``: one abstract run per action covers every
choice).  One Finding vocabulary:

- ``spec-width`` (HIGH): a declared field range leaves int32, the element
  range of the packer (``models/base.py::check_spec_fields``).
- ``encoding-overflow`` (HIGH): a possibly-enabled successor writes a
  field element whose interval escapes the declared [lo, hi]; the packer
  (``ops/packing.py``: ``((flat - los) & masks) << shifts``) would mask it
  silently and the checker would explore a state that never existed.
- ``frame-violation`` (HIGH): the kernel wrote a field outside the
  action's declared write set (``Action.writes``), or declared a write for
  a name that is not a spec field.
- ``vacuous-action`` (MEDIUM): every choice is statically disabled.
- ``read-of-unwritten-field`` / ``dead-field`` (LOW): a field no action
  writes.
- ``analysis-skip`` (INFO): the kernel used a construct outside the
  abstract domain; the action is skipped, never guessed at.

Suppression: ``model.meta["analysis_suppress"]`` is an iterable of
``{"kind": ..., "target": <substring>, "reason": ...}``; matching findings
are downgraded to INFO with the justification attached.
"""

from __future__ import annotations


import weakref

import numpy as np

from ..models.base import INT32_MAX, INT32_MIN, EncodingUnsound
from . import Finding
from .interval import AnalysisUnsupported, analyze_action, definitely_disabled

FATAL_KINDS = ("spec-width", "encoding-overflow", "frame-violation")


def spec_fits_errors(fields, context: str = "") -> list:
    """Spec-width findings for a field table (empty list == sound)."""
    out = []
    prefix = f"{context}: " if context else ""
    for f in fields:
        if f.lo < INT32_MIN or f.hi > INT32_MAX:
            out.append(Finding(
                kind="spec-width",
                severity="HIGH",
                target=f"field:{f.name}",
                message=(
                    f"{prefix}field {f.name!r} declares [{f.lo}, {f.hi}] "
                    f"but the packed element dtype is int32 "
                    f"[{INT32_MIN}, {INT32_MAX}]: values would silently "
                    f"wrap before packing"
                ),
                data={"field": f.name, "declared": [f.lo, f.hi],
                      "dtype_range": [INT32_MIN, INT32_MAX],
                      "needed_bits": max(1, int(f.hi - f.lo).bit_length())},
            ))
    return out


def _overflow_elements(nv, field):
    """Elements of a written field whose interval escapes the declared
    range -> (worst_lo, worst_hi, n_bad) or None."""
    bad = (nv.lo < field.lo) | (nv.hi > field.hi)
    if not bool(np.any(bad)):
        return None
    return int(np.min(nv.lo)), int(np.max(nv.hi)), int(np.sum(bad))


# interval runs in this process: kernel -> {(fields, choices): per-choice
# results or the AnalysisUnsupported raised}, so the gate and the hulls of
# one model run each kernel's abstract pass once
_RUNS = weakref.WeakKeyDictionary()


def action_runs(action, fields) -> list:
    """``interval.analyze_action`` of one action over `fields`, memoized on
    its kernel and the fields' bounds."""
    key = (tuple((f.name, f.shape, f.lo, f.hi) for f in fields), action.n_choices)
    try:
        runs = _RUNS.setdefault(action.kernel, {})
    except TypeError:  # a kernel that takes no weak reference: no memo
        runs = {}
    if key not in runs:
        try:
            runs[key] = analyze_action(action.kernel, fields, action.n_choices)
        except AnalysisUnsupported as e:
            runs[key] = e
    if isinstance(runs[key], AnalysisUnsupported):
        raise runs[key]
    return runs[key]


def analyze_actions(model) -> list:
    """The action passes (overflow / frame / vacuous + dead-field) over one
    built model.  Returns raw findings (no suppression)."""
    fields = model.spec.fields
    by_name = {f.name: f for f in fields}
    findings: list = []
    written_any: set = set()
    read_any: set = set()
    # a skipped action's writes are unknown: its declared write set still
    # counts as written somewhere, and with none declared the dead-field
    # pass would be guessing
    writes_unknown = False

    for a in model.actions:
        changed: set = set()
        n_disabled = 0
        try:
            per_choice = action_runs(a, fields)
        except AnalysisUnsupported as e:
            findings.append(Finding(
                kind="analysis-skip",
                severity="INFO",
                target=f"action:{a.name}",
                message=(
                    f"action {a.name!r} uses a construct outside the "
                    f"interval domain ({e}) — not analyzed"
                ),
                data={"action": a.name, "reason": str(e)},
            ))
            per_choice = None
            if a.writes is not None:
                written_any |= set(a.writes)
            else:
                writes_unknown = True
        for c, r in enumerate(per_choice or ()):
            enabled = r["enabled"]
            read_any |= set(enabled.deps)
            if definitely_disabled(enabled):
                n_disabled += 1
                continue  # statically disabled: nothing can commit
            for f in fields:
                if not r["written"][f.name]:
                    continue
                nv = r["next"][f.name]
                changed.add(f.name)
                read_any |= set(nv.deps)
                ovf = _overflow_elements(nv, f)
                if ovf is not None:
                    lo, hi, n_bad = ovf
                    findings.append(Finding(
                        kind="encoding-overflow",
                        severity="HIGH",
                        target=f"action:{a.name}",
                        message=(
                            f"action {a.name!r} (choice {c}) writes "
                            f"field {f.name!r} with interval [{lo}, {hi}]"
                            f" outside its declared [{f.lo}, {f.hi}] — "
                            f"the bit packer would silently truncate it"
                        ),
                        data={"action": a.name, "choice": c,
                              "field": f.name, "interval": [lo, hi],
                              "declared": [f.lo, f.hi],
                              "bad_elements": n_bad},
                    ))
        written_any |= changed
        if per_choice is not None and a.n_choices and n_disabled == a.n_choices:
            findings.append(Finding(
                kind="vacuous-action",
                severity="MEDIUM",
                target=f"action:{a.name}",
                message=(
                    f"action {a.name!r} is statically disabled for every "
                    f"choice under the declared bounds — dead spec code "
                    f"or a mistranscribed guard"
                ),
                data={"action": a.name, "choices": a.n_choices},
            ))
        if a.writes is not None:
            # declared write sets are upper bounds: only changed-but-
            # undeclared is a finding
            extra = sorted(changed - set(a.writes))
            if extra:
                findings.append(Finding(
                    kind="frame-violation",
                    severity="HIGH",
                    target=f"action:{a.name}",
                    message=(
                        f"action {a.name!r} writes {extra} outside its "
                        f"declared write set {sorted(a.writes)}"
                    ),
                    data={"action": a.name, "extra_writes": extra,
                          "declared_writes": sorted(a.writes)},
                ))
            unknown = sorted(n for n in a.writes if n not in by_name)
            if unknown:
                findings.append(Finding(
                    kind="frame-violation",
                    severity="HIGH",
                    target=f"action:{a.name}",
                    message=(
                        f"action {a.name!r} declares writes {unknown} "
                        f"that are not fields of the spec"
                    ),
                    data={"action": a.name, "unknown_writes": unknown},
                ))

    for f in (fields if not writes_unknown else ()):
        if f.name in written_any:
            continue
        if f.name in read_any:
            findings.append(Finding(
                kind="read-of-unwritten-field",
                severity="LOW",
                target=f"field:{f.name}",
                message=(
                    f"field {f.name!r} feeds action guards/updates but "
                    f"no action ever writes it — it is constant at its "
                    f"init value (forgotten update transcription?)"
                ),
                data={"field": f.name},
            ))
        else:
            findings.append(Finding(
                kind="dead-field",
                severity="LOW",
                target=f"field:{f.name}",
                message=(
                    f"field {f.name!r} is neither written nor read by "
                    f"any action — encoding bits wasted on a constant "
                    f"(invariants may still read it)"
                ),
                data={"field": f.name},
            ))
    return findings


def field_hulls(model, strict: bool = False) -> dict:
    """Per-field reachable-value interval hulls: {name: (lo, hi)}.

    The hull of a field joins the model's concrete init values and every
    possibly-enabled write interval of the action pass: a sound over-
    approximation of every value the checker can pack.  The device-
    resident level pipeline requires each hull inside the declared range
    (``engine/pipeline.py::device_hull_fallback``): no host-side check
    runs between its chunks.

    A kernel outside the abstract domain makes its writes unknowable:
    with ``strict=True`` that raises ``AnalysisUnsupported``; otherwise
    the affected fields widen to their declared ranges.  Hulls are not
    clipped to the declared ranges.  Memoized on the model object, strict
    and non-strict apart (a strict failure is cached as the exception to
    re-raise), and in this process by the model's structure and init
    states."""
    attr = "_field_hulls_strict" if strict else "_field_hulls"
    cached = getattr(model, attr, None)
    key = _hull_memo_key(model, strict)
    if cached is None and key is not None:
        cached = _HULLS.get(key)
    if isinstance(cached, AnalysisUnsupported):
        raise cached
    if cached is not None:
        return dict(cached)

    def keep(value):
        try:
            setattr(model, attr, value)
        except AttributeError:
            pass
        if key is not None:
            _HULLS[key] = value

    def fail(exc):
        keep(exc)
        raise exc

    fields = model.spec.fields
    by_name = {f.name: f for f in fields}
    hulls: dict = {}

    def widen(name, lo, hi):
        cur = hulls.get(name)
        hulls[name] = (min(cur[0], lo), max(cur[1], hi)) if cur else (lo, hi)

    try:
        inits = model.init_states()
    except Exception as e:  # noqa: BLE001 -- exotic init functions
        if strict:
            fail(AnalysisUnsupported(f"init states not enumerable: {e}"))
        inits = None
    if inits is None:
        for f in fields:
            widen(f.name, f.lo, f.hi)
    else:
        for s in inits:
            for f in fields:
                v = np.asarray(s[f.name])
                widen(f.name, int(np.min(v)), int(np.max(v)))

    for a in model.actions:
        try:
            per_choice = action_runs(a, fields)
        except AnalysisUnsupported:
            if strict:
                fail(AnalysisUnsupported(
                    f"action {a.name!r} outside the interval domain — no proven hull"))
            names = a.writes if a.writes is not None else by_name
            for n in names:
                f = by_name.get(n)
                if f is not None:
                    widen(f.name, f.lo, f.hi)
            continue
        for r in per_choice:
            if definitely_disabled(r["enabled"]):
                continue
            for f in fields:
                if r["written"][f.name]:
                    nv = r["next"][f.name]
                    widen(f.name, int(np.min(nv.lo)), int(np.max(nv.hi)))
    keep(dict(hulls))
    return hulls


# hulls computed in this process, keyed by the model's structural identity
# (``analysis._model_memo_key``) and its init states, so a model rebuilt
# from the same config costs nothing
_HULLS: dict = {}


def _hull_memo_key(model, strict: bool):
    from . import _model_memo_key

    key = _model_memo_key(model)
    if key is None:
        return None
    try:
        inits = tuple(tuple((k, repr(np.asarray(v).tolist())) for k, v in sorted(s.items()))
                      for s in model.init_states())
    except Exception:  # noqa: BLE001 -- no memo, just compute
        return None
    return key, inits, strict


def apply_suppressions(findings, model) -> list:
    """Downgrade findings matching ``meta['analysis_suppress']`` to INFO,
    carrying the justification."""
    meta = getattr(model, "meta", None) or {}
    rules = [(r.get("kind"), r.get("target", ""), r.get("reason", "suppressed"))
             for r in meta.get("analysis_suppress", ())]
    if not rules:
        return list(findings)
    out = []
    for f in findings:
        for kind, target, reason in rules:
            if (kind is None or kind == f.kind) and target in f.target:
                f = Finding(kind=f.kind, severity="INFO", target=f.target,
                            message=f.message, data=f.data, suppressed=reason)
                break
        out.append(f)
    return out


def analyze_model(model) -> list:
    """Spec-width + action passes + suppressions for one built model."""
    findings = spec_fits_errors(model.spec.fields, context=model.name)
    findings += analyze_actions(model)
    return apply_suppressions(findings, model)


def verify_model_encoding(model) -> list:
    """The gate's core: raise EncodingUnsound on any unsuppressed HIGH
    spec-width, encoding-overflow or frame-violation finding; return the
    full finding list otherwise."""
    findings = analyze_model(model)
    fatal = [f for f in findings if f.severity == "HIGH" and f.kind in FATAL_KINDS]
    if fatal:
        head = fatal[0]
        raise EncodingUnsound(
            f"model {model.name!r} is encoding-unsound "
            f"({len(fatal)} HIGH finding(s)); first: {head.message}  "
            f"[refusing to explore: the verdict would be untrustworthy; "
            f"KSPEC_ANALYZE=0 overrides at your own risk]",
            findings=fatal,
        )
    return findings
