"""Parallelism: the data mesh over a torch.distributed process group, the
data-parallel plans (mesh), the collectives of the global-batch steps
(collectives) and the analytic cost model (cost_model).

Run data-parallel with torchrun, one process a card:

    torchrun --nproc_per_node=N -m kd_pointcloud_tpu_torch.cli.train cfg.yaml

(NCCL; with --device cpu, gloo)."""

from .collectives import (GatheredView, all_reduce_sum, gather_rows,
                          gather_tree, global_view, moments, sync_grads)
from .mesh import (Mesh, Sharding, batch_sharding, data_parallel_plan,
                   data_parallel_sharding, init_from_env, init_mesh,
                   make_mesh, replicate, replicated, resolve_global_batch,
                   shard_batch)

__all__ = ["batch_sharding", "data_parallel_plan", "data_parallel_sharding",
           "make_mesh", "replicate", "replicated", "resolve_global_batch",
           "shard_batch", "Mesh", "Sharding", "init_from_env", "init_mesh",
           "GatheredView", "all_reduce_sum", "gather_rows", "gather_tree",
           "global_view", "moments", "sync_grads"]
