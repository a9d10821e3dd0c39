"""Point-cloud ops of the port: plain PyTorch where XLA lowered the JAX
package's op, a hand-written CUDA kernel (csrc/) where it had a Pallas one.
Each kernel wrapper runs its kernel on a CUDA tensor and its plain version
on a CPU tensor."""

from .distance import square_distance
from .fps import furthest_point_sample
from .gather import gather_points, group_points
from .interpolate import upsample_idw
from .knn import knn_point, knn_point_dist
from .pool_fused import pool_mlp_max
from .warp import point_warp

__all__ = [
    "square_distance", "furthest_point_sample", "gather_points",
    "group_points", "upsample_idw", "knn_point", "knn_point_dist",
    "pool_mlp_max", "point_warp",
]
