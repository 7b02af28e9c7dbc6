"""Durable-write discipline lint: every durable filesystem effect must
flow through the recordable shim.

The crashcheck harness (``resilience/crashcheck``) can only model-check
what it can see: a raw ``os.rename``/``os.replace`` or an unregistered
``O_APPEND`` journal writer is a durable effect the op-recorder never
records, so its crash states are never enumerated and its recovery is
never exercised.  This lint pins the interposition boundary:

- **entry ops**: ``os.rename(`` / ``os.replace(`` may appear only inside
  ``durable_io.py`` itself (the shim is where the real syscall lives);
  everyone else goes through ``durable_io.rename/replace`` or the
  blessed atomic helpers (``storage/atomic.py``, ``obs/atomicio.py``),
  which already route there.
- **append journals**: ``os.O_APPEND`` opens and ``open(..., "a")`` may
  appear only in the registered emitters (``obs/tracer.py``,
  ``obs/fleettrace.py`` — both call ``durable_io.note_append`` after the
  write) or route through ``durable_io.append_text``.

A site that is genuinely not durable state (ephemeral IPC markers,
scratch files) carries a reasoned suppression on its own line or the
line above::

    # kspec: allow(durable-io) <why this is not durable state>

A bare tag with no reason is itself a finding.  Wired into
``cli analyze`` as HIGH ``durable-io`` findings and pinned at zero by a
tier-1 test, with a seeded-mutant test proving the lint actually fires.
"""

from __future__ import annotations

import os
import re
from typing import Optional

# the shim itself: the only file allowed to issue the raw entry syscalls
_SHIM = "kafka_specification_tpu_torch/durable_io.py"

#: files whose O_APPEND writers are registered with the shim (they call
#: ``durable_io.note_append`` after each raw append write)
_REGISTERED_EMITTERS = {
    _SHIM,
    "kafka_specification_tpu_torch/obs/tracer.py",
    "kafka_specification_tpu_torch/obs/fleettrace.py",
}

_DOCSTRING_RE = re.compile(r'""".*?"""|\'\'\'.*?\'\'\'', re.S)

_ENTRY_OP_RE = re.compile(r"\bos\.(rename|replace)\s*\(")
_APPEND_RE = re.compile(
    r"\bos\.O_APPEND\b|\bopen\s*\([^)\n]*,\s*[\"']a[bt+]?[\"']"
)

_ALLOW_RE = re.compile(r"#\s*kspec:\s*allow\(durable-io\)\s*(.*)")


def _allowed(lines: list, lineno: int):
    """(suppressed, reason-missing) for a 1-based finding line: the tag
    counts on the line itself or either of the two lines above (the
    reasoned form usually wraps)."""
    for ln in (lineno, lineno - 1, lineno - 2):
        if 1 <= ln <= len(lines):
            m = _ALLOW_RE.search(lines[ln - 1])
            if m:
                return True, not m.group(1).strip()
    return False, False


def lint_durable_io(package_root: Optional[str] = None) -> list:
    """Static interposition-boundary lint.  Returns
    ``{path, line, problem}`` findings (empty = clean); wired into
    ``cli analyze`` and pinned by a tier-1 test so no durable write can
    drift outside what the crashcheck harness records."""
    if package_root is None:
        package_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)
        ))
    repo = os.path.dirname(package_root)
    findings = []
    for dirpath, dirnames, filenames in os.walk(package_root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, repo).replace(os.sep, "/")
            try:
                with open(path) as fh:
                    src = fh.read()
            except OSError:
                continue
            # docstrings quote the raw idiom as documentation; only real
            # code sites count (comments still count: the allow-tag
            # machinery below is how a comment legitimizes a site)
            scrubbed = _DOCSTRING_RE.sub(
                lambda m: "\n" * m.group(0).count("\n"), src
            )
            lines = src.splitlines()
            checks = []
            if rel != _SHIM:
                checks.append((
                    _ENTRY_OP_RE,
                    "raw os.rename/os.replace outside durable_io — the "
                    "crashcheck recorder never sees this entry op; use "
                    "durable_io.replace/rename or a blessed atomic "
                    "helper",
                ))
            if rel not in _REGISTERED_EMITTERS:
                checks.append((
                    _APPEND_RE,
                    "append-mode writer outside the registered journal "
                    "emitters — crashcheck cannot enumerate its torn "
                    "tails; use durable_io.append_text or register the "
                    "emitter",
                ))
            for pattern, problem in checks:
                for m in pattern.finditer(scrubbed):
                    # comment-only mentions of the idiom are not sites
                    lineno = scrubbed[: m.start()].count("\n") + 1
                    code = lines[lineno - 1]
                    if code.lstrip().startswith("#"):
                        continue
                    suppressed, bare = _allowed(lines, lineno)
                    if suppressed and not bare:
                        continue
                    findings.append({
                        "path": rel,
                        "line": lineno,
                        "problem": (
                            "kspec: allow(durable-io) tag carries no "
                            "reason — state why this site is not "
                            "durable state"
                        ) if suppressed else problem,
                    })
    return findings
