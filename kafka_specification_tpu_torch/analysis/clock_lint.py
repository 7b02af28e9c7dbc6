"""Raw-clock discipline lint: clock-migrated control-plane modules must
take time from the injectable shim.

The deterministic fleet simulation (``resilience/simfleet``) can only
own what flows through ``utils/clock.py``: a raw ``time.time()`` /
``time.sleep()`` / ``time.monotonic()`` in a migrated module is a
timing decision the virtual clock never sees — the simulated schedule
silently reads the REAL wall clock there, and the whole
same-seed-same-run guarantee dissolves.  This lint pins the boundary:
in the modules listed in :data:`CLOCK_MIGRATED`, the three raw idioms
may appear only inside ``utils/clock.py`` itself (where the real calls
live).

Pure *formatting* of an already-taken stamp (``time.strftime``,
``time.gmtime``) and profiling reads (``time.perf_counter``) are not
timing decisions and are not flagged.

A site that genuinely must read real time regardless of any installed
virtual clock carries a reasoned suppression on its own line or up to
two lines above (the ``durable-io`` lint's exact idiom)::

    # kspec: allow(raw-clock) <why this must be the real clock>

A bare tag with no reason is itself a finding.  Wired into
``cli analyze`` as HIGH ``raw-clock`` findings and pinned at zero by a
tier-1 test, with a seeded-mutant test proving the lint actually fires.
"""

from __future__ import annotations

import os
import re
from typing import Optional

# the shim itself: the only migrated file allowed the raw calls
_SHIM = "kafka_specification_tpu_torch/utils/clock.py"

#: the clock-migrated set — every module whose timing decisions the
#: simulation kernel owns.  Grows as modules migrate; a module listed
#: here may never regress to the raw idioms.
CLOCK_MIGRATED = (
    _SHIM,
    "kafka_specification_tpu_torch/service/queue.py",
    "kafka_specification_tpu_torch/service/router.py",
    "kafka_specification_tpu_torch/service/daemon.py",
    "kafka_specification_tpu_torch/service/fleet.py",
    "kafka_specification_tpu_torch/service/state_cache.py",
    "kafka_specification_tpu_torch/service/scheduler.py",
    "kafka_specification_tpu_torch/resilience/heartbeat.py",
    "kafka_specification_tpu_torch/resilience/retry.py",
    "kafka_specification_tpu_torch/resilience/supervisor.py",
    "kafka_specification_tpu_torch/obs/fleettrace.py",
    "kafka_specification_tpu_torch/resilience/simfleet/simclock.py",
    "kafka_specification_tpu_torch/resilience/simfleet/kernel.py",
    "kafka_specification_tpu_torch/resilience/simfleet/oracles.py",
    "kafka_specification_tpu_torch/resilience/simfleet/search.py",
)

_DOCSTRING_RE = re.compile(r'""".*?"""|\'\'\'.*?\'\'\'', re.S)

_RAW_CLOCK_RE = re.compile(
    r"\btime\.(time|sleep|monotonic)\s*\("
    r"|\bfrom\s+time\s+import\s+[^\n]*\b(time|sleep|monotonic)\b"
)

_ALLOW_RE = re.compile(r"#\s*kspec:\s*allow\(raw-clock\)\s*(.*)")


def _allowed(lines: list, lineno: int):
    """(suppressed, reason-missing) for a 1-based finding line: the tag
    counts on the line itself or either of the two lines above."""
    for ln in (lineno, lineno - 1, lineno - 2):
        if 1 <= ln <= len(lines):
            m = _ALLOW_RE.search(lines[ln - 1])
            if m:
                return True, not m.group(1).strip()
    return False, False


def lint_raw_clock(package_root: Optional[str] = None) -> list:
    """Static clock-boundary lint over :data:`CLOCK_MIGRATED`.  Returns
    ``{path, line, problem}`` findings (empty = clean); wired into
    ``cli analyze`` and pinned by a tier-1 test so no timing decision
    can drift back outside the simulation's reach."""
    if package_root is None:
        package_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)
        ))
    repo = os.path.dirname(package_root)
    pkg_name = os.path.basename(package_root)
    findings = []
    for listed in CLOCK_MIGRATED:
        if listed == _SHIM:
            continue
        # the listed paths are canonical-repo-relative; re-anchor them
        # under the given root so seeded-mutant tests can lint a copy
        rel_in_pkg = listed.split("/", 1)[1]
        path = os.path.join(package_root, *rel_in_pkg.split("/"))
        rel = f"{pkg_name}/{rel_in_pkg}"
        try:
            with open(path) as fh:
                src = fh.read()
        except OSError:
            continue  # a trimmed package copy: absent modules are clean
        # docstrings quote the raw idiom as documentation; only real
        # code sites count (comments still count: the allow-tag
        # machinery below is how a comment legitimizes a site)
        scrubbed = _DOCSTRING_RE.sub(
            lambda m: "\n" * m.group(0).count("\n"), src
        )
        lines = src.splitlines()
        for m in _RAW_CLOCK_RE.finditer(scrubbed):
            lineno = scrubbed[: m.start()].count("\n") + 1
            code = lines[lineno - 1]
            if code.lstrip().startswith("#"):
                continue  # comment-only mentions are not sites
            suppressed, bare = _allowed(lines, lineno)
            if suppressed and not bare:
                continue
            findings.append({
                "path": rel,
                "line": lineno,
                "problem": (
                    "kspec: allow(raw-clock) tag carries no reason — "
                    "state why this site must read the real clock"
                ) if suppressed else (
                    "raw time.time/sleep/monotonic in a clock-migrated "
                    "module — the simfleet virtual clock never sees "
                    "this timing decision; route it through "
                    "utils/clock.py (now/sleep/monotonic)"
                ),
            })
    return findings
