"""Point-cloud warping by inverse-flow interpolation.

Port of kd_pointcloud_tpu/ops/warp.py point_warp (reference PointWarping):
pc2 moves back along an inverse flow built at its points by 3-NN
inverse-distance weighting over the forward-flowed pc1.
"""

from __future__ import annotations

import torch

from .gather import group_points
from .knn import knn_point


def point_warp(xyz1: torch.Tensor, xyz2: torch.Tensor,
               flow1: torch.Tensor | None) -> torch.Tensor:
    """Warp xyz2 (B, N2, 3) backward along flow1 (B, N1, 3) at xyz1
    (B, N1, 3); flow1=None is the identity."""
    if flow1 is None:
        return xyz2
    xyz1_to_2 = xyz1 + flow1
    idx = knn_point(3, xyz1_to_2, xyz2)                     # (B, N2, 3)
    grouped = group_points(torch.cat([xyz1_to_2, flow1], dim=-1), idx)
    neighbor_pos, grouped_flow1 = grouped[..., :3], grouped[..., 3:]
    d2 = ((xyz2[:, :, None, :] - neighbor_pos) ** 2).sum(-1)
    dist = torch.sqrt(torch.clamp(d2, min=1e-20))
    inv = 1.0 / dist
    weight = inv / inv.sum(-1, keepdim=True)
    return xyz2 - (weight[..., None] * grouped_flow1).sum(2)
