"""The reference interpreter: the models' set semantics, in pure Python."""

from .interp import OracleAction, OracleModel, OracleResult, oracle_bfs

__all__ = ["OracleAction", "OracleModel", "OracleResult", "oracle_bfs"]
