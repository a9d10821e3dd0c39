"""Scene-flow estimator head.

Port of kd_pointcloud_tpu/nn/flowhead.py SceneFlowEstimatorResidual:
[feats, cost] -> PointConv(9-NN, bn=True) x 2 -> pointwise MLP -> Dense to 3,
clamped at +-200, added to the upsampled coarse flow. One self-kNN and one
neighbour-position gather serve the whole PointConv stack.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import group_points, knn_point
from .blocks import MLP, Dense
from .pointconv import PointConv


class SceneFlowEstimatorResidual(nn.Module):
    def __init__(self, feat_channel: int, cost_channel: int,
                 channels: Sequence[int] = (128, 128),
                 mlp: Sequence[int] = (128, 64), neighbors: int = 9,
                 clamp: float = 200.0, weightnet: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.neighbors = neighbors
        self.clamp = clamp
        widths = [feat_channel + cost_channel, *channels]
        self.convs = nn.ModuleList(
            PointConv(neighbors, a, b, weightnet=weightnet, bn=True,
                      generator=generator)
            for a, b in zip(widths, widths[1:]))
        self.mlp = MLP(widths[-1], mlp, generator)
        self.dense = Dense(mlp[-1], 3, generator)

    def forward(self, xyz, feats, cost_volume, flow=None):
        x = torch.cat([feats, cost_volume], dim=-1)
        idx = knn_point(self.neighbors, xyz, xyz)
        rel = group_points(xyz, idx) - xyz[:, :, None, :]
        for conv in self.convs:
            x = conv(xyz, x, knn_idx=idx, rel=rel)
        x = self.mlp(x)
        flow_local = torch.clamp(self.dense(x), -self.clamp, self.clamp)
        return x, flow_local if flow is None else flow_local + flow
