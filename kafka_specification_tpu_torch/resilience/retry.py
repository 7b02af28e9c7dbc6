"""Failure classification + bounded exponential backoff for chunk steps.

The port's own copy of ``kafka_specification_tpu/resilience/retry.py``:
the same four classes, the same policy, the same stderr lines, tracer
events and degradation records.  The ladder:

- **transient**: the backend hiccuped.  The chunk is side-effect-free
  until its results are committed, so the response is to re-run the same
  attempt after a short, bounded, exponentially backed-off sleep.
- **compile_oom**: in the JAX package, the reproducible XLA:CPU LLVM OOM
  on escalated programs.  Retrying identically cannot help; the engine
  degrades the escalated attempt instead and records it in
  ``result.stats["degradations"]`` (``kind: "compile_fallback"``).
- **device_resource**: the card ran out of memory executing a chunk.
  Re-running the identical chunk would allocate the identical buffers and
  die identically, so the engine degrades the WORK SHAPE instead: the
  chunk re-runs as its two halves and the streaming chunk size halves for
  the rest of the run (``kind: "chunk_degrade"``).
- **other**: a real bug: propagate.

How CUDA failures map onto the classes.  :func:`classify` decides by the
exception's class first, and only then by JAX's substring rules:

- ``torch.OutOfMemoryError`` (``torch.cuda.OutOfMemoryError`` is the same
  class) is ``device_resource``.  Its text, "CUDA out of memory. Tried to
  allocate ...", holds JAX's compile-OOM substring "out of memory", so a
  verbatim copy of JAX's rules would call an allocation failure
  ``compile_oom`` and re-raise it on a non-escalated attempt.
- A CUDA runtime error is ``other``: ``torch.AcceleratorError`` where the
  build has it, and any ``RuntimeError`` whose text begins "CUDA error:"
  ("an illegal memory access was encountered", "unspecified launch
  failure", ...).  Such errors are sticky: the process's CUDA context is
  lost, and a retry in place would fail again or, worse, read poisoned
  memory.  They surface, and the supervisor's restart into a fresh process
  (``resilience/supervisor.py``) owns them.
- There is no honest "transient" CUDA class inside one process:
  ``transient`` is the injected ``faults.TRANSIENT_MARKER`` and JAX's
  substrings (gRPC status names a remote backend would carry).

torch is looked up lazily and never imported here: the supervisor's
import graph stays free of it.
"""

from __future__ import annotations

import os
import random
import sys
from dataclasses import dataclass, field

from ..utils import clock as _clk

TRANSIENT_PATTERNS = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "DATA_LOSS",
    "ABORTED",
    "CANCELLED",
    "Socket closed",
    "connection reset",
)
OOM_PATTERNS = (
    "LLVM ERROR",
    "out of memory",
    "bad_alloc",
)
# device allocation failure at chunk-execute time (JAX's status name; the
# card's own allocation failure is classified by its class, below)
DEVICE_RESOURCE_PATTERNS = ("RESOURCE_EXHAUSTED",)
# the head of a CUDA runtime error's text as torch raises it
CUDA_ERROR_PREFIX = "CUDA error:"


def _cuda_class(exc: BaseException):
    """'device_resource' | 'other' for torch's CUDA failures, else None.
    A torch exception can only exist once torch is loaded, so an unloaded
    torch means no match (and no import)."""
    torch = sys.modules.get("torch")
    if torch is not None:
        if isinstance(exc, torch.OutOfMemoryError):
            return "device_resource"
        accel = getattr(torch, "AcceleratorError", None)
        if accel is not None and isinstance(exc, accel):
            return "other"
    if isinstance(exc, RuntimeError) and str(exc).startswith(CUDA_ERROR_PREFIX):
        return "other"
    return None


def is_sticky_cuda_error(exc: BaseException) -> bool:
    """A CUDA runtime error: the process's context is lost (docstring)."""
    return _cuda_class(exc) == "other"


def classify(exc: BaseException) -> str:
    """-> 'transient' | 'device_resource' | 'compile_oom' | 'other'."""
    kind = _cuda_class(exc)
    if kind is not None:
        return kind
    text = f"{type(exc).__name__}: {exc}"
    if any(p in text for p in TRANSIENT_PATTERNS):
        return "transient"
    if any(p in text for p in DEVICE_RESOURCE_PATTERNS):
        return "device_resource"
    if any(p in text for p in OOM_PATTERNS):
        return "compile_oom"
    return "other"


@dataclass
class RetryPolicy:
    """Bounded exponential backoff with jitter for transient errors."""

    max_retries: int = 3
    base_delay: float = 0.5
    factor: float = 2.0
    max_delay: float = 30.0
    jitter: float = 0.5  # delay *= 1 + U(0, jitter)
    rng: random.Random = field(default_factory=random.Random, repr=False)

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        return cls(
            max_retries=int(os.environ.get("KSPEC_RETRY_MAX", "3")),
            base_delay=float(os.environ.get("KSPEC_RETRY_BASE_DELAY", "0.5")),
            max_delay=float(os.environ.get("KSPEC_RETRY_MAX_DELAY", "30")),
        )

    def delay(self, attempt: int) -> float:
        """Backoff before retry number `attempt` (1-based)."""
        d = min(self.base_delay * self.factor ** (attempt - 1), self.max_delay)
        return d * (1.0 + self.jitter * self.rng.random())


@dataclass
class ChunkRetryHandler:
    """The chunk-step failure policy, JAX's ``ChunkRetryHandler``.

    Called from the engine's chunk-attempt except blocks; decides between
    - 'retry'   — transient error with budget left: sleeps the backoff and
                  tells the caller to re-run the same attempt;
    - 'degrade' — non-transient failure of an ESCALATED attempt (a
                  ``fused`` chunk above the compact gate, a device level):
                  records a ``compile_fallback`` degradation and tells the
                  caller to fall back a rung;
    - 'degrade_chunk' — a device allocation failure on a NON-escalated
                  attempt: the identical chunk would allocate the
                  identical buffers and die again, so the caller re-runs
                  it as its two halves AND halves its streaming chunk size
                  for the rest of the run (bounded by
                  `max_chunk_degrades`; recorded in
                  result.stats["degradations"]).  An escalated attempt's
                  allocation failure takes the 'degrade' path instead;
    - re-raise  — anything else, including a transient error that exhausted
                  its retry budget and every sticky CUDA error, escalated
                  or not (the supervisor's restart-from-checkpoint layer
                  owns those; JAX's handler degrades an escalated
                  attempt's 'other', which JAX's errors are never sticky
                  for).

    The transient counter is per-chunk (`reset_chunk`); the totals and the
    degradation records accumulate per-run and land in result.stats.
    """

    policy: RetryPolicy
    tag: str  # "[engine]" stderr prefix
    transient_try: int = 0
    retries_total: int = 0
    chunk_degrades: int = 0
    max_chunk_degrades: int = 6  # 64x shrink, then surface the outage
    degradations: list = field(default_factory=list)

    @classmethod
    def from_env(cls, tag: str) -> "ChunkRetryHandler":
        return cls(policy=RetryPolicy.from_env(), tag=tag)

    def reset_chunk(self) -> None:
        self.transient_try = 0

    def handle(
        self,
        e: BaseException,
        escalated: bool,
        depth: int,
        retry_transient: bool = True,
    ) -> str:
        kind = classify(e)
        if kind == "transient":
            if not retry_transient:
                # retry-in-place is unsound where peers run in lockstep:
                # surface it instead
                raise e
            if self.transient_try >= self.policy.max_retries:
                raise e  # budget exhausted: surface the outage
            self.transient_try += 1
            self.retries_total += 1
            pause = self.policy.delay(self.transient_try)
            print(
                f"{self.tag} transient backend error "
                f"({type(e).__name__}: {e}); retry "
                f"{self.transient_try}/{self.policy.max_retries} in "
                f"{pause:.2f}s",
                file=sys.stderr,
            )
            # run-correlated retry record (obs/tracer; a no-op without a
            # run context; the lazy import keeps obs <-> resilience acyclic)
            from ..obs import tracer as _obs

            _obs.event(
                "retry",
                depth=depth,
                attempt=self.transient_try,
                backoff_s=round(pause, 2),
                error=f"{type(e).__name__}: {e}"[:200],
            )
            _clk.sleep(pause)
            return "retry"
        if kind == "device_resource" and not escalated:
            # (an ESCALATED attempt's allocation failure falls through to
            # the degrade below, as in the JAX package; the chunk shrink
            # here is only sound where a lone retry-in-place is)
            if not retry_transient:
                raise e
            if self.chunk_degrades >= self.max_chunk_degrades:
                raise e  # shrinking isn't helping: a real capacity wall
            self.chunk_degrades += 1
            print(
                f"{self.tag} device RESOURCE_EXHAUSTED executing a chunk "
                f"({type(e).__name__}); degrading work shape "
                f"({self.chunk_degrades}/{self.max_chunk_degrades}: uniform "
                f"compact now, half chunk size from the next level)",
                file=sys.stderr,
            )
            self.degradations.append(
                {
                    "kind": "chunk_degrade",
                    "depth": depth,
                    "error": f"{type(e).__name__}: {e}"[:300],
                }
            )
            from ..obs import tracer as _obs

            _obs.event(
                "chunk-degrade",
                depth=depth,
                attempt=self.chunk_degrades,
                error=f"{type(e).__name__}: {e}"[:200],
            )
            return "degrade_chunk"
        if not escalated or is_sticky_cuda_error(e):
            # a non-escalated attempt has nothing to fall back to, and a
            # sticky CUDA error has lost the context a fallback would use
            raise e
        print(
            f"{self.tag} adaptive compact step failed "
            f"({type(e).__name__}); falling back to the uniform compact "
            f"path for the rest of the run",
            file=sys.stderr,
        )
        self.degradations.append(
            {
                "kind": "compile_fallback",
                "depth": depth,
                "error": f"{type(e).__name__}: {e}"[:300],
            }
        )
        from ..obs import tracer as _obs

        _obs.event(
            "compile-fallback",
            depth=depth,
            error=f"{type(e).__name__}: {e}"[:200],
        )
        return "degrade"
