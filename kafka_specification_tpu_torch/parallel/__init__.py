"""The sharded engine (``sharded.py``) and its process plumbing
(``multihost.py``)."""

from .multihost import ShardMesh
from .sharded import check_sharded

__all__ = ["ShardMesh", "check_sharded"]
