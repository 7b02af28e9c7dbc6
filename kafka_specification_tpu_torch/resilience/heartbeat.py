"""Shared JSONL heartbeat envelope of the per-level stats stream.

The port's own copy of ``kafka_specification_tpu/resilience/heartbeat.py``.
Every record carries the same envelope, so one consumer (a stall detector,
or a human with ``tail -f | jq``) reads the port's stream and the JAX
package's alike:

    {"kind": "<stream>", "ts": "<UTC ISO-8601>", "unix": <float seconds>, ...}

The engine writes ``kind`` "level" records; stream-specific fields ride
alongside, in the order the caller gives them.
"""

from __future__ import annotations

import json
import time

from .. import durable_io as _dio
from ..utils import clock as _clk


def heartbeat_record(kind: str, t: float = None, **fields) -> dict:
    """Envelope a record; `t` overrides the stamped time (default: now,
    from the installed clock, ``utils/clock.py``)."""
    if t is None:
        t = _clk.now()
    return {
        "kind": kind,
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t)),
        "unix": round(t, 3),
        **fields,
    }


def append_jsonl(path: str, record: dict) -> None:
    _dio.append_text(path, json.dumps(record) + "\n")
