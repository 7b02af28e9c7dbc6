"""Crash-consistency torture harness for the port's own recovery
protocols.

The port's copy of ``kafka_specification_tpu/resilience/crashcheck/``,
driving the port's modules.  The repo's whole thesis is exhaustive state-space exploration — this
package applies the same discipline (ALICE-style; PAPERS.md) to the
seven durable-write protocols the serving plane stands on.  Three
parts:

1. **Durable-IO interposition** (``kafka_specification_tpu_torch.durable_io``)
   — every durable filesystem effect flows through one recordable shim,
   so a scenario run yields the exact op-trace the protocol issued.
2. **Crash-state enumeration** (``fsmodel``) — every prefix of the
   op-trace, degraded per what a real filesystem may legally persist:
   un-fsynced data truncated or block-torn, un-dir-fsynced renames
   reverted or half-persisted, killed-mid-append tails.
3. **Recovery oracles** (``scenarios``) — each protocol's *existing*
   recovery owner runs against every materialized crash state and its
   convergence invariant is asserted: no acknowledged job lost,
   exactly-once verdicts, no torn entry ever served, chains verify or
   degrade typed, no orphan survives the janitor.

Front door: ``cli crashcheck [--protocol P] [--json]`` — torch-free,
exits 1 on any non-convergent state, emits the schema-versioned
``kspec-crashcheck/1`` record whose findings carry the op-log prefix
and crash state as a machine-readable repro.  ``cli faults --list``
lists the scenarios beside the fault grammar.
"""

from .harness import CRASHCHECK_SCHEMA, run_crashcheck, run_scenario
from .scenarios import SCENARIOS, Scenario, list_scenarios

__all__ = [
    "CRASHCHECK_SCHEMA", "SCENARIOS", "Scenario", "list_scenarios",
    "run_crashcheck", "run_scenario",
]
