"""Multi-device data parallelism of the port (``frcnn_tpu/parallel/``):
``mesh`` (the mesh, its collectives and the launcher) and ``dryrun`` (the
sharded-equals-unsharded certificate)."""

from frcnn_tpu_torch.parallel.mesh import (Mesh, all_reduce_grads_, all_reduce_mean,
                                           gather_rows, make_mesh, replicate, shard_batch,
                                           spawn)

__all__ = ["Mesh", "all_reduce_grads_", "all_reduce_mean", "gather_rows", "make_mesh",
           "replicate", "shard_batch", "spawn"]
