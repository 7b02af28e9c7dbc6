"""Span tracer: nested, run_id-stamped spans to an untearable JSONL.

The port's own copy of ``kafka_specification_tpu/obs/tracer.py``, with
the same record shapes, so ``cli report`` of either package reads the
other's ``spans.jsonl``.  Every span record is one JSON line written with
a single ``os.write`` on an ``O_APPEND`` file descriptor: a hard kill can
tear at most the final line (the reader tolerates exactly that), never an
earlier one.

Record shapes (all carry the shared heartbeat envelope kind/ts/unix from
``resilience.heartbeat`` plus ``run_id``):

    {"kind": "span",  "ph": "E", "span": "<span kind>", "span_id": ...,
     "parent_id": ..., "t0": ..., "ms": ..., <attrs>}       completed span
    {"kind": "span",  "ph": "B", "span": "<span kind>", ...}  begin marker
    {"kind": "event", "event": "<event kind>", <attrs>}     point-in-time

Begin markers are emitted only for the long-lived kinds the engine marks
explicitly (``level``) so a crash mid-level is visible in the log; every
other span lands as one "E" record at exit (span bodies that crash emit
nothing — the surrounding begin marker and the heartbeat stream carry the
forensics).

Deep call sites (storage spills, checkpoint writes, the resource
governor) use the module-level :func:`span` / :func:`event` helpers, which
no-op unless a run context is active — so the storage and resilience
layers need no plumbing.

Optional profiler windows: ``KSPEC_OBS_XPROF=<span_kind>[:<lo>[-<hi>]]``
(the JAX package's grammar) arms a ``torch.profiler`` window around spans
of that kind whose ``depth`` attr falls in the range — e.g.
``KSPEC_OBS_XPROF=level:3-5`` profiles BFS levels 3..5.  Each window
writes a Chrome trace (CPU activity, and CUDA activity when a card is
present) under the run directory's ``xprof/``.  torch is imported only
when a window arms.  A window is best-effort, as in the JAX package: one
that fails to start is reported on stderr and not retried;
``xprof_force_stop`` (called by ``RunContext.deactivate``) closes any
window still open, so none outlives the run.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Optional

from ..resilience.heartbeat import heartbeat_record

XPROF_ENV = "KSPEC_OBS_XPROF"


def parse_xprof(spec: Optional[str]):
    """``"level:3-5"`` -> ("level", 3, 5); ``"level:3"`` -> ("level", 3, 3);
    ``"level"`` -> ("level", 0, inf).  None/empty -> None."""
    if not spec:
        return None
    kind, _, rng = spec.partition(":")
    kind = kind.strip()
    if not kind:
        raise ValueError(f"{XPROF_ENV}={spec!r}: empty span kind")
    if not rng:
        return kind, 0, float("inf")
    lo, sep, hi = rng.partition("-")
    try:
        lo_i = int(lo)
        hi_i = int(hi) if sep else lo_i
    except ValueError:
        raise ValueError(
            f"{XPROF_ENV}={spec!r}: range must be '<lo>[-<hi>]'"
        )
    return kind, lo_i, hi_i


class _SpanCM:
    """Context manager for one span (returned by SpanTracer.span)."""

    def __init__(self, tracer: "SpanTracer", kind: str, attrs: dict):
        self.tracer = tracer
        self.kind = kind
        self.attrs = attrs
        self.span_id = None
        self.t0 = None

    def __enter__(self):
        self.span_id, self.t0 = self.tracer._enter(self.kind, self.attrs)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.tracer._exit(self.kind, self.span_id, self.t0, self.attrs,
                          error=exc_type.__name__ if exc_type else None)
        return False


class _NullCM:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL_CM = _NullCM()


class SpanTracer:
    def __init__(self, path: str, run_id: str):
        self.path = path
        self.run_id = run_id
        self._fd = None
        self._seq = 0
        # one tracer may be shared by concurrent threads: the fd open /
        # seq allocation / close races are guarded here, and each record is a SINGLE
        # os.write on the O_APPEND fd — lines interleave whole, never torn.
        # The NESTING stack is per-thread (not merely locked): a shared
        # stack would attribute thread A's span to thread B's open parent,
        # which is nesting that never happened
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._xprof = parse_xprof(os.environ.get(XPROF_ENV))
        self._xprof_dir = os.path.join(os.path.dirname(path), "xprof")
        self._xprof_live = False
        self._xprof_prof = None
        self._xprof_depth = None

    # --- untearable append ------------------------------------------------
    def _write(self, rec: dict) -> None:
        payload = (json.dumps(rec) + "\n").encode()
        with self._lock:
            if self._fd is None:
                self._fd = os.open(
                    self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
                )
            os.write(self._fd, payload)

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    # --- span protocol ----------------------------------------------------
    @property
    def _stack(self) -> list:
        """This thread's open-span-id stack (parent attribution)."""
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _next_id(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def _enter(self, kind: str, attrs: dict):
        span_id = self._next_id()
        self._stack.append(span_id)
        self.xprof_maybe_start(kind, attrs.get("depth"))
        return span_id, time.time()

    def _exit(self, kind, span_id, t0, attrs, error=None):
        self.xprof_maybe_stop(kind)
        if self._stack and self._stack[-1] == span_id:
            self._stack.pop()
        parent = self._stack[-1] if self._stack else None
        t1 = time.time()
        rec = heartbeat_record(
            "span",
            t=t1,
            run_id=self.run_id,
            ph="E",
            span=kind,
            span_id=span_id,
            parent_id=parent,
            t0=round(t0, 3),
            ms=round((t1 - t0) * 1e3, 1),
            **attrs,
        )
        if error is not None:
            rec["error"] = error
        self._write(rec)

    def span(self, kind: str, **attrs) -> _SpanCM:
        return _SpanCM(self, kind, attrs)

    def emit_span(self, kind: str, t0: float, t1: float, **attrs) -> None:
        """Record an already-completed span from explicit timestamps — the
        zero-intrusion form for engine hot loops that already keep their
        own timers (no context manager overhead)."""
        parent = self._stack[-1] if self._stack else None
        self._write(
            heartbeat_record(
                "span",
                t=t1,
                run_id=self.run_id,
                ph="E",
                span=kind,
                span_id=self._next_id(),
                parent_id=parent,
                t0=round(t0, 3),
                ms=round((t1 - t0) * 1e3, 1),
                **attrs,
            )
        )

    def begin(self, kind: str, **attrs) -> None:
        """Emit a begin marker (ph=B) — crash forensics for long-lived
        spans: a 'B' with no matching 'E' pins where the run died."""
        self._write(
            heartbeat_record(
                "span",
                run_id=self.run_id,
                ph="B",
                span=kind,
                span_id=self._next_id(),
                **attrs,
            )
        )
        self.xprof_maybe_start(kind, attrs.get("depth"))

    def end(self, kind: str, t0: float, **attrs) -> None:
        """Close a begin-marked span by explicit start time (pairs with
        `begin`; the engines' level loop uses begin/end because wrapping
        the whole level body in a context manager is not practical)."""
        self.xprof_maybe_stop(kind)
        self.emit_span(kind, t0, time.time(), **attrs)

    def event(self, kind: str, **attrs) -> None:
        self._write(
            heartbeat_record("event", run_id=self.run_id, event=kind, **attrs)
        )

    # --- optional torch.profiler windows ---------------------------------
    def xprof_maybe_start(self, kind: str, depth) -> None:
        if self._xprof is None or self._xprof_live:
            return
        want_kind, lo, hi = self._xprof
        if kind != want_kind:
            return
        if depth is not None and not (lo <= depth <= hi):
            return
        try:
            os.makedirs(self._xprof_dir, exist_ok=True)
            self._xprof_prof = start_profiler()
            self._xprof_live = True
            self._xprof_depth = depth
            self.event("xprof-start", span=kind, depth=depth,
                       dir=self._xprof_dir)
        except Exception as e:  # profiling is best-effort, never a failure
            self._xprof = None  # don't retry every span
            print(f"[obs] {XPROF_ENV} window failed to start: {e}",
                  file=sys.stderr)

    def xprof_maybe_stop(self, kind: str) -> None:
        if not self._xprof_live or self._xprof is None:
            return
        if kind != self._xprof[0]:
            return
        self._xprof_stop(kind)

    def xprof_force_stop(self) -> None:
        """Flush any still-open window — a verdict/cutoff `break` exits
        the level loop without the span end that would close it."""
        if self._xprof_live and self._xprof is not None:
            self._xprof_stop(self._xprof[0])

    def _xprof_stop(self, kind: str) -> None:
        prof, self._xprof_prof = self._xprof_prof, None
        self._xprof_live = False
        path = os.path.join(
            self._xprof_dir,
            f"{kind}-{self._xprof_depth}-{os.getpid()}.pt.trace.json",
        )
        try:
            stop_profiler(prof, path)
        except Exception:
            pass
        self.event("xprof-stop", span=kind)


def start_profiler():
    """Start and return a ``torch.profiler`` profile recording CPU
    activity, and CUDA activity when a card is present."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop_profiler(prof, path: str) -> None:
    """Stop a profile of :func:`start_profiler` and write its Chrome trace
    to `path`.  The profile is stopped even when the export fails."""
    try:
        prof.stop()
    finally:
        prof.export_chrome_trace(path)


# --- module-level current tracer (deep call sites, zero plumbing) ---------
#
# Thread-LOCAL, not process-global, as in the JAX package: runs in two
# threads of one process, each with its own RunContext, must not
# cross-stamp each other's spans.  Each thread sees only the tracer it
# activated.
_active = threading.local()


def set_tracer(tracer: Optional[SpanTracer]) -> None:
    _active.tracer = tracer


def current_tracer() -> Optional[SpanTracer]:
    return getattr(_active, "tracer", None)


def span(kind: str, **attrs):
    """Span context manager on the active tracer; no-op when none."""
    cur = current_tracer()
    return cur.span(kind, **attrs) if cur is not None else _NULL_CM


def event(kind: str, **attrs) -> None:
    """Point event on the active tracer; no-op when none."""
    cur = current_tracer()
    if cur is not None:
        cur.event(kind, **attrs)


def read_jsonl_tolerant(path: str) -> list:
    """Parse a JSONL file, skipping torn lines and blanks.

    The O_APPEND writers can tear only the FINAL line — but a resumed run
    appends past its predecessor's torn tail (one shared stats/spans file
    per run directory), so by the time `cli report` reads the stream a
    tear can sit anywhere.  Unparsable lines are
    skipped, never fatal: a report over a crashed run must render from
    whatever survived."""
    out = []
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
    except OSError:
        return out
    for line in raw.split(b"\n"):
        if not line.strip():
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            continue  # torn by a kill; the surrounding records stand alone
    return out
