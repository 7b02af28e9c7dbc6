"""Thread-ownership contracts, checked at run time and from the source.

The port's copy of ``kafka_specification_tpu/analysis/ownership.py``.
Each threaded module of the port (overlap.py, storage/tiered.py,
resilience/checkpoints.py) declares a module-level
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

The static half reads the same contracts from the source
(:func:`check_module_contract`, an AST pass): it flags attribute writes
that break them (engine-only state written from worker context, shared
state written outside ``with self.<lock>:``, an immutable rebound after
``__init__``, an unannotated attribute written outside ``__init__``), and
annotations no method writes.  Worker context is the declared worker
methods, nested functions handed to ``*.submit(...)`` or ``AsyncJob(...)``,
and every method they call through ``self``.  A flagged line is allowed
with ``# kspec: allow(<kind>) <reason>`` on it or up to three lines above.

:func:`lint_purity` covers the device-resident level pipeline: a function
marked ``# kspec: traced`` queues work on the card with no host read, so a
host read inside it (``int()``, ``float()``, ``bool()``, ``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize()``,
``np.*``) is a finding, and no module it scans may iterate a ``set`` or
``frozenset`` directly in a ``for`` (hash-seed dependent order).
``cli analyze`` runs both over ``analysis.OWNERSHIP_MODULES`` and
``analysis.PURITY_MODULES``.

Stdlib only.
"""

from __future__ import annotations

import ast
import os
import re
import threading
from typing import Optional

from . import Finding

OWNERSHIP_SCHEMA = "kspec-ownership/1"
TSAN_ENV = "KSPEC_TSAN"

_ALLOW_RE = re.compile(r"#\s*kspec:\s*allow\(([\w-]+)\)\s*(.*)")
_TRACED_RE = re.compile(r"#\s*kspec:\s*traced\b")

#: container methods that mutate their receiver (the deque/list/dict/set
#: surface the engine uses)
_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "discard", "remove", "clear", "pop", "popleft", "popitem", "update",
    "setdefault", "sort", "reverse",
}


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


# --------------------------------------------------------------------------
# static contract checker
# --------------------------------------------------------------------------


def _literal_contract(tree: ast.Module) -> Optional[dict]:
    """Extract the module-level THREAD_CONTRACT literal, or None."""
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "THREAD_CONTRACT"):
            try:
                return ast.literal_eval(node.value)
            except ValueError:
                return None
    return None


def _allow_reasons(source: str) -> dict:
    """lineno -> (kind, reason) for `# kspec: allow(kind) reason` lines."""
    out = {}
    for i, line in enumerate(source.splitlines(), 1):
        m = _ALLOW_RE.search(line)
        if m:
            out[i] = (m.group(1), m.group(2).strip() or "allowed")
    return out


def _allow_match(allows: dict, lineno: int, kinds) -> bool:
    """THE suppression-window rule, shared by the ownership and purity
    passes: an allow() comment matches on the flagged line or up to
    three lines above (black-formatted code rarely has room on the
    statement line itself)."""
    for ln in range(lineno, max(0, lineno - 4), -1):
        a = allows.get(ln)
        if a is not None and a[0] in kinds:
            return True
    return False


def _self_root_attr(node) -> Optional[str]:
    """For an attribute/subscript chain rooted at `self`, the FIRST
    attribute after self (`self.deleter.pending` -> "deleter") — a
    mutation anywhere down the chain reaches state owned through that
    root attribute.  None when the chain is not self-rooted."""
    attr = None
    cur = node
    while True:
        if isinstance(cur, ast.Attribute):
            attr = cur.attr
            cur = cur.value
        elif isinstance(cur, ast.Subscript):
            cur = cur.value
        elif isinstance(cur, ast.Name):
            return attr if cur.id == "self" else None
        else:
            return None


def _self_attr_writes(fn: ast.AST, exclude=()):
    """Yield (attr, lineno, via_call) for self-attribute mutations inside
    one function body.  Nested function defs are descended into EXCEPT
    the ids in `exclude` (worker-submitted closures, which get their own
    worker-context classification) — an un-submitted nested callback
    inherits its enclosing method's context, so its mutations are never
    invisible to the checker."""
    excluded = set(exclude)

    class V(ast.NodeVisitor):
        def __init__(self):
            self.out = []

        def visit_FunctionDef(self, node):
            if node is fn or id(node) not in excluded:
                self.generic_visit(node)

        visit_AsyncFunctionDef = visit_FunctionDef

        def _target(self, t):
            # self.x = / self.x[...] = / self.a.b = / (a, self.x) = ...
            # — any self-rooted chain mutates state reached through its
            # root attribute
            if isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    self._target(e)
                return
            if isinstance(t, (ast.Attribute, ast.Subscript)):
                root = _self_root_attr(t)
                if root is not None:
                    self.out.append((root, t.lineno, False))

        def visit_Assign(self, node):
            for t in node.targets:
                self._target(t)
            self.generic_visit(node)

        def visit_AugAssign(self, node):
            self._target(node.target)
            self.generic_visit(node)

        def visit_AnnAssign(self, node):
            if node.value is not None:
                self._target(node.target)
            self.generic_visit(node)

        def visit_Delete(self, node):
            for t in node.targets:
                self._target(t)
            self.generic_visit(node)

        def visit_Call(self, node):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
                # self.<chain>.append(...) — any depth, incl. subscripts
                root = _self_root_attr(f.value)
                if root is not None:
                    self.out.append((root, node.lineno, True))
            self.generic_visit(node)

    v = V()
    v.visit(fn)
    return v.out


def _lock_spans(fn: ast.AST, lock_name: str):
    """Line ranges covered by `with self.<lock_name>` blocks in fn."""
    spans = []

    class V(ast.NodeVisitor):
        def visit_With(self, node):
            for item in node.items:
                e = item.context_expr
                if (isinstance(e, ast.Attribute)
                        and isinstance(e.value, ast.Name)
                        and e.value.id == "self"
                        and e.attr == lock_name):
                    last = node.body[-1]
                    spans.append((node.lineno,
                                  getattr(last, "end_lineno",
                                          last.lineno)))
            self.generic_visit(node)

    V().visit(fn)
    return spans


def _self_calls(fn: ast.AST) -> set:
    """Names of methods this function calls as self.<m>(...)."""
    out = set()

    class V(ast.NodeVisitor):
        def visit_Call(self, node):
            f = node.func
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "self"):
                out.add(f.attr)
            self.generic_visit(node)

    V().visit(fn)
    return out


def _submitted_nested(fn: ast.AST) -> list:
    """Nested FunctionDefs inside `fn` whose NAME is passed to a
    `*.submit(...)` call or an `AsyncJob(...)` constructor — they run on
    the worker thread."""
    nested = {n.name: n for n in ast.walk(fn)
              if isinstance(n, ast.FunctionDef) and n is not fn}
    if not nested:
        return []
    hits = []

    class V(ast.NodeVisitor):
        def visit_Call(self, node):
            f = node.func
            is_submit = isinstance(f, ast.Attribute) and f.attr == "submit"
            is_job = isinstance(f, ast.Name) and f.id == "AsyncJob"
            if is_submit or is_job:
                for a in node.args:
                    if isinstance(a, ast.Name) and a.id in nested:
                        hits.append(nested[a.id])
            self.generic_visit(node)

    V().visit(fn)
    return hits


def check_module_contract(path: str, rel: str) -> list:
    """Verify one module's THREAD_CONTRACT annotations; returns findings.

    A module without a THREAD_CONTRACT yields a single MEDIUM finding
    when it is in the declared ownership scope (the caller only passes
    modules that must carry one)."""
    with open(path) as fh:
        source = fh.read()
    tree = ast.parse(source, filename=path)
    allows = _allow_reasons(source)
    contract = _literal_contract(tree)
    findings: list = []
    if contract is None:
        return [Finding(
            kind="unannotated-attribute", severity="MEDIUM",
            target=rel,
            message=f"{rel} has threaded classes but no THREAD_CONTRACT",
            data={"module": rel},
        )]

    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}
    for cls_name, c in contract.get("classes", {}).items():
        node = classes.get(cls_name)
        if node is None:
            findings.append(Finding(
                kind="stale-annotation", severity="LOW",
                target=f"{rel}:{cls_name}",
                message=f"THREAD_CONTRACT names missing class {cls_name}",
                data={"class": cls_name},
            ))
            continue
        findings += _check_class(node, c, rel, allows)

    # classes with threaded surface but no contract entry: a class that
    # references a worker/submit and is not annotated
    annotated = set(contract.get("classes", {}))
    for cls_name, node in classes.items():
        if cls_name in annotated:
            continue
        src = ast.get_source_segment(source, node) or ""
        if ".submit(" in src or "AsyncJob(" in src:
            findings.append(Finding(
                kind="unannotated-attribute", severity="MEDIUM",
                target=f"{rel}:{cls_name}",
                message=(
                    f"class {cls_name} interacts with a worker but has "
                    f"no THREAD_CONTRACT entry"
                ),
                data={"class": cls_name},
            ))
    return findings


def _check_class(node: ast.ClassDef, c: dict, rel: str,
                 allows: dict) -> list:
    findings: list = []
    engine_only = set(c.get("engine_only", ()))
    shared = set(c.get("shared_locked", ()))
    immutable = set(c.get("immutable_after_init", ()))
    worker_safe = set(c.get("worker_safe", ()))
    lock_name = c.get("lock")
    known = engine_only | shared | immutable
    methods = {m.name: m for m in node.body
               if isinstance(m, ast.FunctionDef)}

    # context classification: worker = declared worker methods + nested
    # submitted functions + transitive self-calls from worker context
    worker_fns: list = []
    worker_names = set(c.get("worker_methods", ()))
    for name in worker_names:
        if name in methods:
            worker_fns.append(methods[name])
    submitted: list = []
    for m in methods.values():
        submitted.extend(_submitted_nested(m))
    worker_fns.extend(submitted)
    # submitted closures are walked in worker context; every OTHER
    # nested function inherits its enclosing method's context
    submitted_ids = {id(n) for n in submitted}
    # close worker context over self.<m>() calls
    frontier = list(worker_fns)
    while frontier:
        fn = frontier.pop()
        for callee in _self_calls(fn):
            if callee in methods and callee not in worker_names:
                worker_names.add(callee)
                worker_fns.append(methods[callee])
                frontier.append(methods[callee])

    worker_ids = {id(f) for f in worker_fns}
    seen_attrs: set = set()

    def engine_ctx_fns():
        for name, m in methods.items():
            if name not in worker_names:
                yield name, m

    def _suppressed(lineno, kind):
        # allow(ownership) is the category-wide form
        return _allow_match(allows, lineno, (kind, "ownership"))

    # worker-context mutations
    for fn in worker_fns:
        in_worker_safe = getattr(fn, "name", "") in worker_safe
        spans = _lock_spans(fn, lock_name) if lock_name else []
        for attr, lineno, via_call in _self_attr_writes(
                fn, exclude=submitted_ids):
            seen_attrs.add(attr)
            if attr in shared:
                if _suppressed(lineno, "unlocked-shared-write"):
                    continue
                if not any(a <= lineno <= b for a, b in spans):
                    findings.append(Finding(
                        kind="unlocked-shared-write", severity="HIGH",
                        target=f"{rel}:{lineno}",
                        message=(
                            f"{node.name}.{attr} is shared_locked but "
                            f"written without `with self.{lock_name}` "
                            f"(worker context, {getattr(fn, 'name', '?')})"
                        ),
                        data={"class": node.name, "attr": attr,
                              "line": lineno},
                    ))
                continue
            kind = ("ownership-breach" if attr in engine_only
                    or attr in immutable else "unannotated-attribute")
            if _suppressed(lineno, kind):
                continue
            # unannotated mutation is HIGH in WORKER context (nobody
            # decided who owns it, and a thread other than the engine is
            # touching it) vs MEDIUM from the engine side below
            findings.append(Finding(
                kind=kind, severity="HIGH",
                target=f"{rel}:{lineno}",
                message=(
                    f"{node.name}.{attr} mutated from worker context "
                    f"({getattr(fn, 'name', '<nested>')}) but is "
                    + ("engine-thread-only/immutable"
                       if kind == "ownership-breach"
                       else "not annotated in THREAD_CONTRACT")
                ),
                data={"class": node.name, "attr": attr, "line": lineno,
                      "context": "worker"},
            ))
        if in_worker_safe:
            ws_writes = [
                w for w in _self_attr_writes(fn, exclude=submitted_ids)
                if not _suppressed(w[1], "worker-unsafe-write")
            ]
            if ws_writes:
                findings.append(Finding(
                    kind="worker-unsafe-write", severity="HIGH",
                    target=f"{rel}:{fn.lineno}",
                    message=(
                        f"{node.name}.{fn.name} is declared worker_safe "
                        f"but mutates self"
                    ),
                    data={"class": node.name, "method": fn.name,
                          "attrs": sorted({w[0] for w in ws_writes})},
                ))

    # engine-context mutations
    for name, fn in engine_ctx_fns():
        spans = _lock_spans(fn, lock_name) if lock_name else []
        for attr, lineno, via_call in _self_attr_writes(
                fn, exclude=submitted_ids):
            seen_attrs.add(attr)
            if name == "__init__":
                continue  # construction precedes publication
            if attr in shared:
                if _suppressed(lineno, "unlocked-shared-write"):
                    continue
                if not any(a <= lineno <= b for a, b in spans):
                    findings.append(Finding(
                        kind="unlocked-shared-write", severity="HIGH",
                        target=f"{rel}:{lineno}",
                        message=(
                            f"{node.name}.{attr} is shared_locked but "
                            f"written without `with self.{lock_name}` "
                            f"({name})"
                        ),
                        data={"class": node.name, "attr": attr,
                              "line": lineno},
                    ))
            elif attr in immutable:
                if _suppressed(lineno, "ownership-breach"):
                    continue
                findings.append(Finding(
                    kind="ownership-breach", severity="HIGH",
                    target=f"{rel}:{lineno}",
                    message=(
                        f"{node.name}.{attr} is immutable-after-init but "
                        f"rebound in {name}"
                    ),
                    data={"class": node.name, "attr": attr,
                          "line": lineno},
                ))
            elif attr not in engine_only:
                if _suppressed(lineno, "unannotated-attribute"):
                    continue
                findings.append(Finding(
                    kind="unannotated-attribute", severity="MEDIUM",
                    target=f"{rel}:{lineno}",
                    message=(
                        f"{node.name}.{attr} mutated outside __init__ "
                        f"({name}) but not annotated in THREAD_CONTRACT"
                    ),
                    data={"class": node.name, "attr": attr,
                          "line": lineno, "context": "engine"},
                ))

    # worker_safe methods that mutate self (engine-classified ones too —
    # the declaration is "callable from any thread")
    for name in worker_safe:
        fn = methods.get(name)
        if fn is None or id(fn) in worker_ids:
            continue
        writes = [w for w in _self_attr_writes(fn, exclude=submitted_ids)
                  if not _suppressed(w[1], "worker-unsafe-write")]
        if writes:
            findings.append(Finding(
                kind="worker-unsafe-write", severity="HIGH",
                target=f"{rel}:{fn.lineno}",
                message=(
                    f"{node.name}.{name} is declared worker_safe (any "
                    f"thread) but mutates self.{writes[0][0]}"
                ),
                data={"class": node.name, "method": name,
                      "attrs": sorted({w[0] for w in writes})},
            ))

    # stale annotations: contracted attrs never touched in this class
    for attr in sorted(known):
        if attr not in seen_attrs:
            # immutables are typically only set in __init__ (which we
            # did record); anything truly unseen is stale
            findings.append(Finding(
                kind="stale-annotation", severity="LOW",
                target=f"{rel}:{node.name}",
                message=(
                    f"THREAD_CONTRACT annotates {node.name}.{attr} but "
                    f"no method ever writes it"
                ),
                data={"class": node.name, "attr": attr},
            ))
    return findings


# --------------------------------------------------------------------------
# purity / iteration-order lint
# --------------------------------------------------------------------------

#: what reads a tensor back to the host: builtin conversions, tensor
#: methods, and the module-qualified calls (``np.*`` is matched below)
_HOST_CALLS = {"int", "float", "bool"}
_HOST_ATTRS = {"item", "tolist", "cpu", "numpy"}
_HOST_QUALIFIED = {("torch", "cuda", "synchronize")}


def _dotted(node) -> tuple:
    """`a.b.c` -> ("a", "b", "c"); () for anything not a plain dotted name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ()
    parts.append(node.id)
    return tuple(reversed(parts))


def _traced_functions(tree: ast.Module, source: str):
    """FunctionDefs whose def line (or the line above) carries
    `# kspec: traced`."""
    lines = source.splitlines()
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        for ln in (node.lineno, node.lineno - 1):
            if 1 <= ln <= len(lines) and _TRACED_RE.search(lines[ln - 1]):
                out.append(node)
                break
    return out


def lint_purity(path: str, rel: str) -> list:
    """Host-read lint over `# kspec: traced` functions plus the
    module-wide set-iteration-order check."""
    with open(path) as fh:
        source = fh.read()
    tree = ast.parse(source, filename=path)
    allows = _allow_reasons(source)
    findings: list = []

    def allowed(lineno, kind):
        # allow(purity) is the category-wide form
        return _allow_match(allows, lineno, (kind, "purity"))

    for fn in _traced_functions(tree, source):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            flagged = None
            dotted = _dotted(f)
            if isinstance(f, ast.Name) and f.id in _HOST_CALLS:
                flagged = f"{f.id}(...)"
            elif dotted in _HOST_QUALIFIED:
                flagged = ".".join(dotted)
            elif isinstance(f, ast.Attribute):
                if isinstance(f.value, ast.Name) and f.value.id == "np":
                    flagged = f"np.{f.attr}"
                elif f.attr in _HOST_ATTRS:
                    flagged = f".{f.attr}()"
            if flagged and not allowed(node.lineno, "host-materialization"):
                findings.append(Finding(
                    kind="host-materialization", severity="MEDIUM",
                    target=f"{rel}:{node.lineno}",
                    message=(
                        f"traced function {fn.name!r} calls {flagged} — "
                        f"a host read inside a function that queues work "
                        f"on the card waits for the card "
                        f"(annotate `# kspec: allow(host-materialization)"
                        f" <why>` if the value is static)"
                    ),
                    data={"function": fn.name, "call": flagged,
                          "line": node.lineno},
                ))

    # set-iteration-order: `for x in {…}` / `for x in set(...)` — order
    # depends on PYTHONHASHSEED for str elements; the engine's results
    # (candidate order, digest chains) must not
    for node in ast.walk(tree):
        if not isinstance(node, (ast.For, ast.comprehension)):
            continue
        it = node.iter
        bad = None
        if isinstance(it, (ast.Set, ast.SetComp)):
            bad = "a set literal"
        elif (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id in ("set", "frozenset")):
            bad = f"{it.func.id}(...)"
        if bad and not allowed(it.lineno, "set-iteration-order"):
            findings.append(Finding(
                kind="set-iteration-order", severity="MEDIUM",
                target=f"{rel}:{it.lineno}",
                message=(
                    f"iteration over {bad} — set order is hash-seed "
                    f"dependent; wrap in sorted(...) or annotate "
                    f"`# kspec: allow(set-iteration-order) <why>`"
                ),
                data={"line": it.lineno},
            ))
    return findings
