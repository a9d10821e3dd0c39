"""The pointnet2 API over the port's ops.

Port of kd_pointcloud_tpu/ops/pointnet2_compat.py: the functional aliases
of pointnet2_utils (gather_operation, grouping_operation, and FPS, ball
query, three_nn and three_interpolate under their own names), QueryAndGroup
and GroupAll, and the PointnetSAModule / PointnetFPModule of
pointnet2_modules. Channels-last (B, N, C), as the rest of the port. FPS
and three_nn's search run the FPS and kNN kernels on the card; the ball
query, grouping and MLPs are plain PyTorch on every device, as they are
XLA in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..nn.blocks import MLP
from .ball_query import ball_query
from .fps import furthest_point_sample
from .gather import gather_points, group_points
from .interpolate import three_interpolate, three_nn

__all__ = [
    "furthest_point_sample", "gather_operation", "grouping_operation",
    "ball_query", "three_nn", "three_interpolate", "QueryAndGroup",
    "GroupAll", "PointnetSAModule", "PointnetFPModule",
]

gather_operation = gather_points
grouping_operation = group_points


class QueryAndGroup(nn.Module):
    """Ball query and group, the relative coordinates first when use_xyz:
    (B, S, nsample, 3 + C)."""

    def __init__(self, radius: float, nsample: int, use_xyz: bool = True):
        super().__init__()
        self.radius = radius
        self.nsample = nsample
        self.use_xyz = use_xyz

    def forward(self, xyz, new_xyz, features: Optional[torch.Tensor] = None):
        idx = ball_query(self.radius, self.nsample, xyz, new_xyz)
        grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
        if features is not None:
            grouped = group_points(features, idx)
            if self.use_xyz:
                return torch.cat([grouped_xyz, grouped], dim=-1)
            return grouped
        if not self.use_xyz:
            raise ValueError("QueryAndGroup without features needs use_xyz")
        return grouped_xyz


class GroupAll(nn.Module):
    """One group of every point: (B, 1, N, 3 + C)."""

    def __init__(self, use_xyz: bool = True):
        super().__init__()
        self.use_xyz = use_xyz

    def forward(self, xyz, new_xyz, features: Optional[torch.Tensor] = None):
        grouped_xyz = xyz[:, None, :, :]
        if features is not None:
            grouped = features[:, None, :, :]
            if self.use_xyz:
                return torch.cat([grouped_xyz, grouped], dim=-1)
            return grouped
        return grouped_xyz


class PointnetSAModule(nn.Module):
    """Set abstraction: FPS (the kernel on the card), ball-query group,
    shared MLP, max over the group; npoint None groups everything around
    the origin. in_channel: the features' width (0 without features).
    Returns (new_xyz, new_features)."""

    def __init__(self, npoint: Optional[int], radius: float, nsample: int,
                 in_channel: int, mlp: Sequence[int], use_xyz: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.npoint = npoint
        self.group = (QueryAndGroup(radius, nsample, use_xyz)
                      if npoint is not None else GroupAll(use_xyz))
        self.mlp = MLP(in_channel + 3 * use_xyz, mlp, generator)

    def forward(self, xyz, features: Optional[torch.Tensor] = None):
        if self.npoint is not None:
            new_xyz = gather_points(xyz,
                                    furthest_point_sample(xyz, self.npoint))
        else:
            new_xyz = torch.zeros(xyz.shape[0], 1, 3, dtype=xyz.dtype,
                                  device=xyz.device)
        grouped = self.group(xyz, new_xyz, features)
        return new_xyz, self.mlp(grouped).amax(dim=2)


class PointnetFPModule(nn.Module):
    """Feature propagation: 3-NN (the kNN kernel on the card) inverse-
    distance interpolation of known_feats onto the unknown points, the
    unknown points' own features appended, then a pointwise MLP.
    in_channel: known_feats' width plus unknown_feats' (if given)."""

    def __init__(self, in_channel: int, mlp: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        self.mlp = MLP(in_channel, mlp, generator)

    def forward(self, unknown, known, unknown_feats, known_feats):
        if known is not None:
            dist, idx = three_nn(unknown, known)
            inv = 1.0 / dist
            weight = inv / inv.sum(-1, keepdim=True)
            interp = three_interpolate(known_feats, idx, weight)
        else:
            interp = known_feats.expand(known_feats.shape[0],
                                        unknown.shape[1],
                                        known_feats.shape[-1])
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp)
