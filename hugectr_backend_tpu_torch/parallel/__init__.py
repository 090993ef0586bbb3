"""Sharded tables on a device mesh: port of the JAX package's parallel/."""

from hugectr_backend_tpu_torch.parallel.mesh import Mesh, make_mesh
from hugectr_backend_tpu_torch.parallel.sharded_table import ShardedTable, sharded_lookup

__all__ = ["Mesh", "make_mesh", "ShardedTable", "sharded_lookup"]
