"""3-NN inverse-distance-weighted upsampling.

Port of kd_pointcloud_tpu/ops/interpolate.py upsample_idw. The search
selects with the expansion distance; the weights use distances recomputed
from the gathered coordinates, with the clamp inside the sqrt at 1e-20
(the reference's 1e-10 distance clamp), so an exactly coincident neighbour
is a copy and not a blend.
"""

from __future__ import annotations

import torch

from .gather import group_points
from .knn import knn_point_dist


def upsample_idw(dense_xyz: torch.Tensor, sparse_xyz: torch.Tensor,
                 sparse_feat: torch.Tensor, knn=None) -> torch.Tensor:
    """Upsample (B, S, C) features at sparse_xyz (B, S, 3) to dense_xyz
    (B, N, 3) by 3-NN inverse-distance weighting -> (B, N, C).

    knn: optional precomputed (d2, idx) 3-NN of sparse_xyz around dense_xyz,
    shared between upsamples over the same geometry."""
    _, idx = knn if knn is not None else knn_point_dist(3, sparse_xyz,
                                                        dense_xyz)
    grouped = group_points(torch.cat([sparse_xyz, sparse_feat], dim=-1), idx)
    neighbor_xyz, neighbor_feat = grouped[..., :3], grouped[..., 3:]
    diff = neighbor_xyz - dense_xyz[:, :, None, :]
    dist = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-20))
    inv = 1.0 / dist
    weight = inv / inv.sum(-1, keepdim=True)
    return (weight[..., None] * neighbor_feat).sum(2)
