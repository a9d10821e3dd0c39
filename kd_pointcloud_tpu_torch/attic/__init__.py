"""Ports of the JAX package's attic kernels (attic/ at the root of the
repository: kept negative results that no path of either package runs).

fps_pruned: exact FPS with bounding-sphere pruning (csrc/fps_pruned.cu);
cross_pool: the cost-volume pool with an L-layer MLP (csrc/cross_pool.cu).
Each module holds its plain version beside its kernel wrapper.
"""

from .cross_pool import cross_pool_fused, cross_pool_plain
from .fps_pruned import (fps_pruned_plain, furthest_point_sample_pruned,
                         spatial_permutation)

__all__ = ["cross_pool_fused", "cross_pool_plain", "fps_pruned_plain",
           "furthest_point_sample_pruned", "spatial_permutation"]
