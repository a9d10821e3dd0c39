"""PointConv layers: WeightNet-weighted continuous convolutions.

Port of kd_pointcloud_tpu/nn/pointconv.py: group_knn, contract_dense,
PointConv (same resolution) and PointConvD (FPS downsampling, with the
nested-FPS prefix). The (C, W) pair is flattened c-major into the Dense
kernel, as the reference's .view(B, N, -1) does.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import furthest_point_sample, gather_points, group_points, knn_point
from .blocks import Dense, leaky
from .weightnet import WeightNet


def group_knn(nsample: int, xyz, query_xyz, feats, idx=None, rel=None):
    """kNN-group feats (B, N, C) of xyz around query_xyz (B, S, 3).

    Returns (grouped (B, S, K, 3 + C), rel_xyz (B, S, K, 3)). idx shares
    one kNN between convs on the same clouds, rel also the neighbour
    position gather."""
    if idx is None:
        idx = knn_point(nsample, xyz, query_xyz)
    if rel is None:
        rel = group_points(xyz, idx) - query_xyz[:, :, None, :]
    return torch.cat([rel, group_points(feats, idx)], dim=-1), rel


def contract_dense(grouped: torch.Tensor, weights: torch.Tensor,
                   dense: Dense) -> torch.Tensor:
    """Dense(contract_K(grouped x weights)) without materialising the
    (B, S, C*W) product: the (c, w) pair contracts straight into the Dense
    kernel viewed as (C, W, O), the 3 relative-coordinate channels and the
    feature channels as two parts, like the JAX package."""
    C = grouped.shape[-1]
    W = weights.shape[-1]
    kern = dense.weight.t().reshape(C, W, -1)

    def part(g, k3):
        y = torch.einsum("bskc,bskw->bscw", g, weights)
        return torch.einsum("bscw,cwo->bso", y, k3)

    out = part(grouped[..., :3], kern[:3])
    if C > 3:
        out = out + part(grouped[..., 3:], kern[3:])
    return out + dense.bias


class _BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the trailing channel axis of (B, N, C)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.reshape(-1, x.shape[-1])).reshape(x.shape)


class PointConv(nn.Module):
    """Same-resolution PointConv; bn=True only inside the flow heads, the
    model's only BatchNorm (flax momentum 0.9 is torch momentum 0.1)."""

    def __init__(self, nsample: int, in_channel: int, out_channel: int,
                 weightnet: int = 16, bn: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.nsample = nsample
        self.weightnet = WeightNet(weightnet, generator=generator)
        self.dense = Dense((3 + in_channel) * weightnet, out_channel,
                           generator)
        self.bn = _BatchNorm(out_channel, eps=1e-5, momentum=0.1) if bn \
            else None

    def forward(self, xyz, feats, knn_idx=None, rel=None):
        grouped, rel = group_knn(self.nsample, xyz, xyz, feats, knn_idx, rel)
        y = contract_dense(grouped, self.weightnet(rel), self.dense)
        if self.bn is not None:
            y = self.bn(y)
        return leaky(y)


def fps_or_prefix(xyz: torch.Tensor, npoint: int, prefix: bool):
    """FPS-sample npoint rows, or take the leading npoint rows when prefix.

    Greedy FPS orderings are nested: on a cloud already in FPS-selection
    order, FPS of its first M rows selects exactly those rows in order
    (proof: kd_pointcloud_tpu/nn/pointconv.py _fps_or_prefix). So levels
    2-4 slice level 1's ordering and FPS runs once per pair."""
    if prefix:
        idx = torch.arange(npoint, dtype=torch.int32, device=xyz.device)
        return xyz[:, :npoint].contiguous(), idx.expand(xyz.shape[0], npoint)
    idx = furthest_point_sample(xyz, npoint)
    return gather_points(xyz, idx), idx


class PointConvD(nn.Module):
    """FPS-downsampling PointConv. Returns (new_xyz, new_feat, fps_idx)."""

    def __init__(self, npoint: int, nsample: int, in_channel: int,
                 out_channel: int, weightnet: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.npoint = npoint
        self.nsample = nsample
        self.weightnet = WeightNet(weightnet, generator=generator)
        self.dense = Dense((3 + in_channel) * weightnet, out_channel,
                           generator)

    def forward(self, xyz, feats, prefix_sample: bool = False):
        new_xyz, fps_idx = fps_or_prefix(xyz, self.npoint, prefix_sample)
        grouped, rel = group_knn(self.nsample, xyz, new_xyz, feats)
        y = contract_dense(grouped, self.weightnet(rel), self.dense)
        return new_xyz, leaky(y), fps_idx
