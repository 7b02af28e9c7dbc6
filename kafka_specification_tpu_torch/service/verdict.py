"""The ``kspec-verdict/1`` record under the JAX package's module name
(``kafka_specification_tpu/service/verdict.py``): the port keeps one copy,
``kafka_specification_tpu_torch/verdict.py``, which ``cli check --json``,
the daemon's result files and ``cli result`` share.  Torch-free."""

from ..verdict import (
    EXIT_ERROR,
    EXIT_OK,
    EXIT_RESOURCE,
    EXIT_VIOLATION,
    VERDICT_SCHEMA,
    error_verdict,
    render_verdict,
    verdict_exit_code,
    verdict_from_result,
)

__all__ = [
    "EXIT_ERROR",
    "EXIT_OK",
    "EXIT_RESOURCE",
    "EXIT_VIOLATION",
    "VERDICT_SCHEMA",
    "error_verdict",
    "render_verdict",
    "verdict_exit_code",
    "verdict_from_result",
]
