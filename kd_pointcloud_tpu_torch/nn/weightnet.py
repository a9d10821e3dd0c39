"""WeightNet: the continuous-convolution weight MLP of PointConv.

Port of kd_pointcloud_tpu/nn/weightnet.py: Dense 3 -> 8 -> 8 -> W over the
relative neighbour coordinates (B, N, K, 3), ReLU after every layer.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import Dense


class WeightNet(nn.Module):
    def __init__(self, out_channel: int, hidden: Sequence[int] = (8, 8),
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = [3, *hidden, out_channel]
        self.layers = nn.ModuleList(
            Dense(a, b, generator) for a, b in zip(widths, widths[1:]))

    def forward(self, rel_xyz: torch.Tensor) -> torch.Tensor:
        w = rel_xyz
        for layer in self.layers:
            w = torch.relu(layer(w))
        return w
