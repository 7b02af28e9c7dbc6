"""The machine-readable verdict record, ``kspec-verdict/1``.

The port's own copy of the record code of
``kafka_specification_tpu/service/verdict.py``: ``cli check --json`` of
either package prints the same record for the same result, so a client
scripting against it can switch packages without changing its parser:

    {"schema": "kspec-verdict/1",
     "model": ..., "distinct_states": ..., "diameter": ..., "levels": [...],
     "states_per_sec": ..., "seconds": ...,
     "violation": null | {"invariant": ..., "depth": ..., "trace_len": ...},
     "run_id": ..., "exit_code": 0|1|75|2|76}

Exit codes:
  0   exhaustive pass, no violation
  1   invariant violated (the verdict is the product, not an error)
  75  RESOURCE_EXHAUSTED: the run ran out of disk, memory or time
      (``resilience/resources.py``); its checkpoint resumes
  2   error (bad config, unknown module, engine failure)
  76  INTEGRITY_VIOLATION: the level digest chain caught corrupt state
      (``resilience/integrity.py``)
"""

from __future__ import annotations

from typing import Optional

VERDICT_SCHEMA = "kspec-verdict/1"

EXIT_OK = 0
EXIT_VIOLATION = 1
EXIT_ERROR = 2
EXIT_RESOURCE = 75


def verdict_from_result(res, run_id: Optional[str] = None) -> dict:
    """The verdict record of a CheckResult (anything with model, total,
    diameter, levels, seconds, states_per_sec and violation)."""
    violation = None
    if res.violation is not None:
        violation = {
            "invariant": res.violation.invariant,
            "depth": res.violation.depth,
            "trace_len": len(res.violation.trace),
        }
    return {
        "schema": VERDICT_SCHEMA,
        "model": res.model,
        "distinct_states": res.total,
        "diameter": res.diameter,
        "levels": list(res.levels),
        "states_per_sec": round(res.states_per_sec, 1),
        "seconds": round(res.seconds, 3),
        "violation": violation,
        "run_id": run_id,
        "exit_code": EXIT_OK if res.violation is None else EXIT_VIOLATION,
    }


def error_verdict(message: str, run_id: Optional[str] = None, exit_code: int = EXIT_ERROR) -> dict:
    """The record of a run that produced no CheckResult."""
    return {
        "schema": VERDICT_SCHEMA,
        "model": None,
        "distinct_states": None,
        "diameter": None,
        "levels": None,
        "states_per_sec": None,
        "seconds": None,
        "violation": None,
        "error": message,
        "run_id": run_id,
        "exit_code": exit_code,
    }


def verdict_exit_code(rec: dict) -> int:
    """The process exit code a consumer of this record should use."""
    code = rec.get("exit_code")
    return EXIT_ERROR if code is None else int(code)
