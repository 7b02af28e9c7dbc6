"""Thread-ownership contracts at run time: the KSPEC_TSAN sanitizer.

The port's copy of the runtime half of ``kafka_specification_tpu/
analysis/ownership.py``.  Each threaded module of the port (overlap.py,
storage/tiered.py, resilience/checkpoints.py) declares a module-level
``THREAD_CONTRACT``, equal to the JAX package's::

    THREAD_CONTRACT = {
        "schema": "kspec-ownership/1",
        "classes": {
            "AsyncWorker": {
                "lock": "_cv",                  # guard for shared state
                "shared_locked": [...],         # mutate only under lock
                "engine_only": [...],           # submitting thread only
                "immutable_after_init": [...],  # set once in __init__
                "worker_methods": [...],        # run on the worker
                "worker_safe": [...],           # any thread, no self-mutation
            },
        },
    }

and calls :func:`bind_contract` at import.  With ``KSPEC_TSAN=1`` (tests
only) the annotated classes are armed at import: each gets a checking
``__setattr__`` that asserts the contract on every write — engine-only
attributes must not be written from a registered worker thread, shared
ones only with the lock held, immutables only once — and raises
:class:`OwnershipViolation` otherwise.  :func:`arm_all` and
:func:`disarm_all` arm and disarm around a scenario.  ``AsyncWorker``
registers its thread through :func:`register_worker_thread`.

The static half (the AST pass over the contracts and the purity lint,
``cli analyze``) is not ported yet; the JAX package's checker reads the
port's contracts from their source.

Stdlib only.
"""

from __future__ import annotations

import os
import threading

OWNERSHIP_SCHEMA = "kspec-ownership/1"
TSAN_ENV = "KSPEC_TSAN"


class OwnershipViolation(AssertionError):
    """KSPEC_TSAN runtime ownership assertion failure."""


_WORKER_THREADS: set = set()
_WT_LOCK = threading.Lock()


def tsan_enabled() -> bool:
    return os.environ.get(TSAN_ENV, "").strip().lower() in (
        "1", "on", "true", "yes"
    )


def register_worker_thread(thread: threading.Thread) -> None:
    """Called by overlap.AsyncWorker when its thread starts (no cost when
    TSAN is off beyond one set insert)."""
    with _WT_LOCK:
        _WORKER_THREADS.add(thread.ident or id(thread))


def unregister_worker_thread(thread: threading.Thread) -> None:
    with _WT_LOCK:
        _WORKER_THREADS.discard(thread.ident or id(thread))


def on_worker_thread() -> bool:
    ident = threading.get_ident()
    with _WT_LOCK:
        return ident in _WORKER_THREADS


def live_worker_threads() -> list:
    """The names of the port's registered worker threads still alive."""
    with _WT_LOCK:
        idents = set(_WORKER_THREADS)
    return sorted(t.name for t in threading.enumerate()
                  if t.ident in idents and t.is_alive())


def _checking_setattr(cls, contract: dict):
    engine_only = set(contract.get("engine_only", ()))
    shared = set(contract.get("shared_locked", ()))
    immutable = set(contract.get("immutable_after_init", ()))
    lock_name = contract.get("lock")
    orig = cls.__setattr__

    def __setattr__(self, name, value):
        if id(self) in _IN_INIT:
            # construction precedes publication: __init__ writes are
            # single-threaded by contract
            orig(self, name, value)
            return
        if name in engine_only and on_worker_thread():
            raise OwnershipViolation(
                f"{cls.__name__}.{name} is engine-thread-only but was "
                f"written from worker thread "
                f"{threading.current_thread().name!r} (THREAD_CONTRACT)"
            )
        if name in immutable and hasattr(self, name):
            raise OwnershipViolation(
                f"{cls.__name__}.{name} is immutable-after-init but was "
                f"rebound (THREAD_CONTRACT)"
            )
        if name in shared and lock_name is not None:
            lock = getattr(self, lock_name, None)
            owned = getattr(lock, "_is_owned", None)
            if lock is not None and owned is not None and not owned():
                raise OwnershipViolation(
                    f"{cls.__name__}.{name} is shared state but was "
                    f"written without holding {lock_name} "
                    f"(THREAD_CONTRACT)"
                )
        orig(self, name, value)

    return __setattr__


#: objects currently inside their (sanitized) constructor
_IN_INIT: set = set()

#: classes registered via bind_contract, with their contracts
_BOUND: list = []
#: armed classes -> their original (__setattr__, __init__)
_ARMED: dict = {}


def _checking_init(cls):
    orig_init = cls.__init__

    def __init__(self, *a, **k):
        _IN_INIT.add(id(self))
        try:
            orig_init(self, *a, **k)
        finally:
            _IN_INIT.discard(id(self))

    return __init__


def bind_contract(module_globals: dict, contract: dict) -> None:
    """Register a module's THREAD_CONTRACT classes for the runtime
    sanitizer; arm immediately when KSPEC_TSAN=1 (no cost otherwise)."""
    for cls_name, c in contract.get("classes", {}).items():
        cls = module_globals.get(cls_name)
        if cls is not None:
            _BOUND.append((cls, c))
    if tsan_enabled():
        arm_all()


def arm_all() -> int:
    """Install the checking __setattr__/__init__ on every registered
    class (tests arm/disarm around a TSAN scenario; KSPEC_TSAN=1 arms
    at import).  Returns the number of classes armed."""
    n = 0
    for cls, c in _BOUND:
        if cls in _ARMED:
            continue
        _ARMED[cls] = (cls.__setattr__, cls.__init__)
        cls.__setattr__ = _checking_setattr(cls, c)
        cls.__init__ = _checking_init(cls)
        n += 1
    return n


def disarm_all() -> None:
    """Restore the original __setattr__/__init__ on every armed class."""
    for cls, (s, i) in _ARMED.items():
        cls.__setattr__ = s
        cls.__init__ = i
    _ARMED.clear()


def armed() -> list:
    """The names of the classes armed now."""
    return sorted(cls.__name__ for cls in _ARMED)
