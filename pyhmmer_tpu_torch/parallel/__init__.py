"""Distribution layers of the port: single-process sharding over torch
devices (:mod:`.mesh`) and the multi-process runtime over
``torch.distributed`` (:mod:`.multihost`); the port of
``pyhmmer_tpu/parallel``."""

from .mesh import make_mesh, ShardedCascade, sharded_search
from . import multihost

__all__ = ["make_mesh", "ShardedCascade", "sharded_search", "multihost"]
