"""Shape-keyed model cache: the warm heart of the serving daemon.

The port's own copy of ``kafka_specification_tpu/service/kernel_cache.py``,
keyed as there.  A cold ``cli check`` pays the torch import, the .cfg
parse, the model build and the encoding gate for its check; the daemon
pays each of them once per *schema shape* and serves every later job of
that shape warm.

Two layers, as in the JAX package:

**Model layer**, keyed by ``(module, kernel source, canonical CONSTANTS,
constraints)``: one built :class:`~..models.base.Model` with the sorted
UNION of every invariant any overlay of this shape has asked for.

**Invariant overlay**, keyed by the full shape key (ordered invariants and
the deadlock flag): a view of its base model with the invariants selected
and ordered (the order fixes the first-violation rule), and its own
:class:`~..engine.bfs.PreparedKernels`.  An overlay costs no model build.

The JAX package's unit of caching is the jitted step; the port compiles no
step, so what an entry keeps warm is the model and its preparation (the
encoding gate's pass, the field hulls, the visited-capacity fixed point).
``resolve_kernel_source`` accepts ``hand`` and ``auto``, which resolves to
hand: the emitted kernels (the reference checkout's mechanical
translation) are not ported, and a job asking for them gets an error
verdict.

Engine knobs (bucket floor, chunk size, visited backend) ride in the
daemon's configuration, not here.  Imported only by the daemon (building
models imports torch), never by the client commands.
"""

from __future__ import annotations

import dataclasses
import time

from ..utils.cfg import TlcConfig, build_model, parse_cfg, resolved_invariants


def canonical_constants(constants: dict) -> tuple:
    """Hashable canonical form of a .cfg's CONSTANTS block."""
    return tuple(
        (k, tuple(v) if isinstance(v, list) else v)
        for k, v in sorted(constants.items())
    )


def resolve_kernel_source(kernel_source: str, module: str) -> bool:
    """'auto'|'hand' -> emitted? (always False: auto resolves to the hand
    kernels, the only ones the port has); 'emitted' raises ValueError."""
    if kernel_source in ("auto", "hand"):
        return False
    if kernel_source == "emitted":
        raise ValueError(
            f"kernel source 'emitted' is not available for {module!r}: the "
            "port has the hand-written kernels only (submit with --hand or "
            "the default)"
        )
    raise ValueError(f"bad kernel_source {kernel_source!r}")


def shape_key(module: str, cfg: TlcConfig, emitted: bool,
              invariants: tuple) -> tuple:
    """The overlay key (ordered invariants fix the first-violation rule,
    so they key verbatim)."""
    return (
        module,
        bool(emitted),
        canonical_constants(cfg.constants),
        tuple(invariants),
        tuple(cfg.constraints),
        bool(cfg.check_deadlock),
    )


def model_key(module: str, cfg: TlcConfig, emitted: bool) -> tuple:
    """The model-layer key: everything that shapes the built Model except
    the invariant selection (overlaid) and the deadlock flag (an engine
    knob)."""
    return (
        module,
        bool(emitted),
        canonical_constants(cfg.constants),
        tuple(cfg.constraints),
    )


def _overlay_model(base, invariants: tuple):
    """A Model view of `base` checking `invariants`, in that order (it
    shares the base's spec, actions and decode)."""
    base_names = [i.name for i in base.invariants]
    if tuple(base_names) == tuple(invariants):
        return base
    by_name = {i.name: i for i in base.invariants}
    return dataclasses.replace(base, invariants=[by_name[n] for n in invariants])


class KernelCache:
    """In-process two-layer cache of built models and their preparations.
    Bounded LRU over the overlays (``max_entries``); a base model goes when
    its last overlay is evicted."""

    def __init__(self, max_entries: int = 32):
        self.max_entries = max_entries
        self._entries: dict = {}  # overlay key -> entry dict
        self._models: dict = {}  # model key -> {model, names, build_s}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.model_builds = 0
        self.overlay_derives = 0

    def __len__(self) -> int:
        return len(self._entries)

    def _base(self, module: str, cfg: TlcConfig, emitted: bool,
              invariants: tuple) -> dict:
        """The model-layer entry covering `invariants`, building (or
        rebuilding with a grown union) when needed."""
        bkey = model_key(module, cfg, emitted)
        base = self._models.get(bkey)
        if base is not None and set(invariants) <= set(base["names"]):
            return base
        union = sorted(set(invariants) | set(base["names"] if base else ()))
        t0 = time.perf_counter()
        build_cfg = TlcConfig(
            constants=dict(cfg.constants),
            invariants=list(union),
            constraints=list(cfg.constraints),
            specification=cfg.specification,
            check_deadlock=cfg.check_deadlock,
        )
        model = build_model(module, build_cfg)
        self.model_builds += 1
        if base is not None:
            # a grown union replaced the base: drop the overlays of the old
            # one, so that their next request derives from the new base
            for k in [k for k, e in self._entries.items() if e.get("base_key") == bkey]:
                del self._entries[k]
        base = {
            "key": bkey,
            "model": model,
            # the names actually RESOLVED into the model (builders may
            # apply defaults), so coverage checks match reality
            "names": tuple(i.name for i in model.invariants),
            "build_s": round(time.perf_counter() - t0, 3),
        }
        self._models[bkey] = base
        return base

    def get(self, module: str, cfg: TlcConfig, emitted: bool,
            invariants: tuple) -> dict:
        """-> {model, prepared, key, hit, build_s, overlay}; builds on a
        miss.  A miss on a warm model layer derives an overlay (no model
        build): ``overlay`` is True on such entries."""
        from ..engine.bfs import prepare

        key = shape_key(module, cfg, emitted, invariants)
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            entry["last_used"] = time.time()
            entry["uses"] += 1
            return {**entry, "hit": True}
        self.misses += 1
        t0 = time.perf_counter()
        prior = self._models.get(model_key(module, cfg, emitted))
        base = self._base(module, cfg, emitted, invariants)
        overlay = prior is not None and prior is base  # warm base, no build
        model = _overlay_model(base["model"], tuple(invariants))
        if model is not base["model"]:
            self.overlay_derives += 1
        entry = {
            "key": key,
            "base_key": base["key"],
            "model": model,
            "prepared": prepare(model),
            "build_s": round(time.perf_counter() - t0, 3),
            "overlay": bool(overlay),
            "last_used": time.time(),
            "uses": 1,
        }
        self._entries[key] = entry
        if len(self._entries) > self.max_entries:
            lru = min(self._entries.values(), key=lambda e: e["last_used"])
            del self._entries[lru["key"]]
            self.evictions += 1
            # drop the base model once no overlay references it
            bk = lru.get("base_key")
            if bk is not None and not any(
                e.get("base_key") == bk for e in self._entries.values()
            ):
                self._models.pop(bk, None)
        return {**entry, "hit": False}

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": round(
                self.hits / max(1, self.hits + self.misses), 4
            ),
            "model_layer": {
                "entries": len(self._models),
                "builds": self.model_builds,
                "overlay_derives": self.overlay_derives,
            },
        }


def job_cfg(spec: dict) -> TlcConfig:
    """Parse a job spec's inline .cfg text."""
    return parse_cfg(spec["cfg_text"])


def job_invariants(module: str, cfg: TlcConfig) -> tuple:
    """The invariant names, in model order, that a solo ``cli check`` of
    this job builds and checks (``utils.cfg.resolved_invariants``, so the
    batched replay never drifts from the solo path); an unknown module
    raises KeyError, as build_model does."""
    return resolved_invariants(module, cfg)
