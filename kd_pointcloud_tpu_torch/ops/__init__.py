"""Point-cloud ops of the port: plain PyTorch where XLA lowered the JAX
package's op, a hand-written CUDA kernel (csrc/) where it had a Pallas one.
Each kernel wrapper runs its kernel on a CUDA tensor and its plain version
on a CPU tensor."""

from .ball_query import ball_query
from .distance import square_distance
from .fps import furthest_point_sample, furthest_point_sample_blocked
from .gather import (gather_points, group_points, group_points_kmajor,
                     group_points_kmajor_packed)
from .interpolate import three_interpolate, three_nn, upsample_idw
from .knn import knn_features, knn_point, knn_point_dist
from .pool_fused import leaky, pool_mlp_max
from .warp import point_warp

__all__ = [
    "ball_query", "square_distance", "furthest_point_sample",
    "furthest_point_sample_blocked", "gather_points", "group_points",
    "group_points_kmajor", "group_points_kmajor_packed",
    "three_interpolate", "three_nn", "upsample_idw", "knn_features",
    "knn_point", "knn_point_dist", "leaky", "pool_mlp_max", "point_warp",
]
