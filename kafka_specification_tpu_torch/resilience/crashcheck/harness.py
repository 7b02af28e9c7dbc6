"""Record -> enumerate -> recover: the crashcheck run loop.

One scenario pass: run the protocol once against a scratch tree with the
``durable_io`` recorder installed, enumerate every legal post-crash
state of the recorded op-trace (``fsmodel``), materialize each state
into a fresh tree, and run the protocol's recovery owner against it
inside the *crashed-process view* — the recording pid reads as dead (so
pid-keyed adoption protocols fire) and the clock-skew allowance is
zeroed (so the backdated leases read as the expired leases they would be
at real recovery time).

Output is the schema-versioned ``kspec-crashcheck/1`` record.  Every
non-convergent state ships as a machine-readable finding: the summarized
op-log, the crash prefix, the degradations applied, and the state's file
listing — enough to rebuild the exact tree and replay the recovery under
a debugger.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import time
from contextlib import contextmanager

from ... import durable_io as _dio
from .fsmodel import enumerate_crash_states, materialize, snapshot_tree, \
    summarize_ops

CRASHCHECK_SCHEMA = "kspec-crashcheck/1"


@contextmanager
def _crashed_process_view():
    """Recovery-side reality adjustment: this process recorded the
    scenario, so ITS pid is the 'crashed' one — adoption sweeps keyed on
    pid-aliveness must treat it as dead.  The zero-skew allowance that
    a corpse must not enjoy is no longer forced here via a process-global
    ``os.environ`` mutation (unsafe under concurrent harnesses): the
    recovery steps pass ``skew_s=0.0`` explicitly to the queue/router
    skew readers instead, and the env var stays the documented default
    for production sweeps."""
    from ...service import queue as qmod
    from ...service import router as rmod

    me = os.getpid()
    real = qmod._pid_alive

    def fake(pid: int) -> bool:
        return False if pid == me else real(pid)

    qmod._pid_alive = fake
    rmod._pid_alive = fake
    try:
        yield
    finally:
        qmod._pid_alive = real
        rmod._pid_alive = real


def _tree_listing(tree: dict) -> dict:
    return {
        path: {"len": len(data),
               "sha256": hashlib.sha256(data).hexdigest()[:16]}
        for path, data in sorted(tree.items())
    }


def run_scenario(scn, workdir: str) -> dict:
    """One scenario's full pass; -> its per-scenario record section."""
    t_start = time.monotonic()
    record_root = os.path.join(workdir, f"record-{scn.name}")
    os.makedirs(record_root)
    scn.setup(record_root)
    base, dirs = snapshot_tree(record_root)
    rec = _dio.OpRecorder(record_root)
    prev = _dio.install(rec)
    try:
        ctx = scn.run(record_root, rec)
    finally:
        _dio.install(prev)
    ops = rec.ops
    states = enumerate_crash_states(base, ops)
    findings = []
    checked = 0
    with _crashed_process_view():
        for st in states:
            acked = {
                op["label"] for op in ops[:st.prefix] if op["op"] == "ack"
            }
            dest = os.path.join(workdir, "state")
            if os.path.isdir(dest):
                shutil.rmtree(dest)
            materialize(st, dirs, dest)
            checked += 1
            try:
                violations = scn.recover(dest, acked, ctx)
            except Exception as e:  # noqa: BLE001 - a raise IS a finding
                violations = [
                    f"recovery itself raised {type(e).__name__}: {e}"
                ]
            if violations:
                findings.append({
                    "scenario": scn.name,
                    "protocol": scn.protocol,
                    "violations": violations,
                    "prefix": st.prefix,
                    "degraded": st.degraded,
                    "state_digest": st.digest(),
                    "acked": sorted(acked),
                    "op_log": summarize_ops(ops),
                    "tree": _tree_listing(st.tree),
                })
    return {
        "name": scn.name,
        "protocol": scn.protocol,
        "ops": len(ops),
        "states": checked,
        "non_convergent": len(findings),
        "seconds": round(time.monotonic() - t_start, 3),
        "findings": findings,
    }


def run_crashcheck(protocols=None, workdir=None) -> dict:
    """Run every scenario (or the ``--protocol``-selected subset) and
    return the ``kspec-crashcheck/1`` record.  ``ok`` is True iff every
    enumerated crash state converged."""
    from .scenarios import SCENARIOS

    selected = [
        s for s in SCENARIOS
        if protocols is None or s.protocol in protocols
        or s.name in protocols
    ]
    if not selected:
        raise ValueError(
            f"no crashcheck scenario matches {sorted(protocols)} "
            f"(protocols: {sorted({s.protocol for s in SCENARIOS})})"
        )
    t0 = time.monotonic()
    own_tmp = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="kspec-crashcheck-")
    sections, findings = [], []
    try:
        for scn in selected:
            section = run_scenario(scn, workdir)
            findings.extend(section.pop("findings"))
            sections.append(section)
    finally:
        if own_tmp:
            shutil.rmtree(workdir, ignore_errors=True)
    return {
        "schema": CRASHCHECK_SCHEMA,
        "scenarios": sections,
        "protocols": sorted({s["protocol"] for s in sections}),
        "states": sum(s["states"] for s in sections),
        "non_convergent": len(findings),
        "findings": findings,
        "seconds": round(time.monotonic() - t0, 3),
        "ok": not findings,
    }
