"""Metrics registry: counters / gauges / histograms, JSONL + Prometheus.

The port's own copy of ``kafka_specification_tpu/obs/metrics.py``, with
the same metric names, labels, buckets and export formats, so a scraper
or ``cli report`` reads either package's run directory alike.

One registry per run.  The engine updates it through ``RunObserver``
(obs/observer.py); deep call sites (checkpoint writes, spill merges, the
resource governor) bump counters through the module-level :func:`inc` /
:func:`set_gauge` helpers, which no-op unless a run is active — mirroring
the tracer's current-tracer pattern so storage/resilience need no
plumbing.

Exports, refreshed on every snapshot call:

- ``metrics.jsonl`` — append-only heartbeat-enveloped snapshots (history;
  the report renderer reads the last one even from a crashed run).
- ``metrics.prom``  — the Prometheus *textfile-collector* format, written
  atomically (tmp + rename) so a scraper that re-reads the file never sees
  a torn export.  Every sample carries a ``run_id`` label; extra labels
  (e.g. ``shard``) ride alongside.

Metric names use the ``kspec_`` prefix and Prometheus conventions
(``*_total`` for counters).

Stdlib only.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from .. import durable_io as _dio
from ..resilience.heartbeat import heartbeat_record
from .atomicio import atomic_write_text

# histogram default buckets: per-level wall times span 4ms toy levels to
# multi-minute deep-product levels
DEFAULT_MS_BUCKETS = (10, 50, 100, 500, 1000, 5000, 30_000, 120_000, 600_000)


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    def __init__(self, run_id: str = "",
                 const_labels: Optional[dict] = None):
        """``const_labels`` ride on every exported sample beside ``run_id``:
        the serving daemon stamps ``instance``/``host``, so N fleet daemons'
        scraped series never collide on one name."""
        self.run_id = run_id
        self.const_labels = dict(const_labels or {})
        self.counters: dict = {}
        self.gauges: dict = {}
        self.hists: dict = {}  # name -> {buckets, counts[], sum, count}
        # one registry may be updated from concurrent threads:
        # read-modify-write counters and histogram cells would otherwise
        # drop increments under the interleaving
        self._lock = threading.Lock()

    # --- instruments ------------------------------------------------------
    def inc(self, name: str, value=1, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            self.counters[k] = self.counters.get(k, 0) + value

    def set_gauge(self, name: str, value, **labels) -> None:
        with self._lock:
            self.gauges[_key(name, labels)] = value

    def observe(self, name: str, value, buckets=DEFAULT_MS_BUCKETS) -> None:
        with self._lock:
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = {
                    "buckets": list(buckets),
                    "counts": [0] * (len(buckets) + 1),
                    "sum": 0.0,
                    "count": 0,
                }
            i = 0
            for i, b in enumerate(h["buckets"]):
                if value <= b:
                    break
            else:
                i = len(h["buckets"])
            h["counts"][i] += 1
            h["sum"] += value
            h["count"] += 1

    # --- export -----------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {
                    n: {
                        "sum": round(h["sum"], 3),
                        "count": h["count"],
                        "buckets": dict(
                            zip([str(b) for b in h["buckets"]] + ["+Inf"],
                                _cum(h["counts"]))
                        ),
                    }
                    for n, h in self.hists.items()
                },
            }

    def write_jsonl(self, path: str) -> None:
        rec = heartbeat_record("metrics", run_id=self.run_id,
                               **({"labels": self.const_labels}
                                  if self.const_labels else {}),
                               **self.snapshot())
        _dio.append_text(path, json.dumps(rec) + "\n")

    def write_prom(self, path: str) -> None:
        """Atomic Prometheus textfile export (tmp + rename: a scraper
        re-reading the path mid-write never sees a torn file)."""
        rid = ",".join(
            [f'run_id="{self.run_id}"']
            + [f'{k}="{self.const_labels[k]}"'
               for k in sorted(self.const_labels)]
        )
        with self._lock:  # consistent copies: no size-change mid-iteration
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            hists = {
                n: {
                    "buckets": list(h["buckets"]),
                    "counts": list(h["counts"]),
                    "sum": h["sum"],
                    "count": h["count"],
                }
                for n, h in self.hists.items()
            }

        def sample(key, value):
            # merge the run_id label into an existing {labels} suffix
            if key.endswith("}"):
                return f"{key[:-1]},{rid}}} {value}"
            return f"{key}{{{rid}}} {value}"

        lines = []
        seen_types = set()

        def type_line(key, mtype):
            base = key.split("{", 1)[0]
            if base not in seen_types:
                seen_types.add(base)
                lines.append(f"# TYPE {base} {mtype}")

        for k in sorted(counters):
            type_line(k, "counter")
            lines.append(sample(k, counters[k]))
        for k in sorted(gauges):
            type_line(k, "gauge")
            lines.append(sample(k, gauges[k]))
        for n in sorted(hists):
            h = hists[n]
            type_line(n, "histogram")
            for le, c in zip([str(b) for b in h["buckets"]] + ["+Inf"],
                             _cum(h["counts"])):
                lines.append(sample(f'{n}_bucket{{le="{le}"}}', c))
            lines.append(sample(f"{n}_sum", round(h["sum"], 3)))
            lines.append(sample(f"{n}_count", h["count"]))
        # no fsync — a scrape artifact needs no power-loss durability
        atomic_write_text(path, "\n".join(lines) + "\n", fsync=False)


def _cum(counts):
    out, acc = [], 0
    for c in counts:
        acc += c
        out.append(acc)
    return out


# --- module-level current registry (deep call sites, zero plumbing) -------
#
# Thread-LOCAL like the tracer's current (obs/tracer.py): concurrent
# in-process runs each activate their own registry without cross-stamping.
_active = threading.local()


def set_registry(reg: Optional[MetricsRegistry]) -> None:
    _active.registry = reg


def current_registry() -> Optional[MetricsRegistry]:
    return getattr(_active, "registry", None)


def inc(name: str, value=1, **labels) -> None:
    reg = current_registry()
    if reg is not None:
        reg.inc(name, value, **labels)


def set_gauge(name: str, value, **labels) -> None:
    reg = current_registry()
    if reg is not None:
        reg.set_gauge(name, value, **labels)
