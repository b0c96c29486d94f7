from .mesh import make_mesh, shard_batch, sharded_apply, reconcile_sharded
from .collective import global_clock_union

__all__ = ["make_mesh", "shard_batch", "sharded_apply", "reconcile_sharded",
           "global_clock_union"]
