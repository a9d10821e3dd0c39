"""Basic building blocks on channels-last (B, N, C) tensors.

Port of kd_pointcloud_tpu/nn/blocks.py: Dense, leaky (ops.leaky, slope 1 at
0 as jax.nn.leaky_relu), PointwiseBlock, MLP. Weights follow torch's
Conv/Linear default init (kaiming_uniform(a=sqrt 5), i.e. U(+-1/sqrt(fan_in))
for kernel and bias), drawn from an explicit torch.Generator.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import leaky


class Dense(nn.Module):
    """Linear layer over the trailing axis; weight is (out, in)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        with torch.no_grad():
            for p in (self.weight, self.bias):
                p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound)
                        - bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class PointwiseBlock(nn.Module):
    """Dense + leaky (the reference's 1x1 Conv block, BN off)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dense = Dense(in_features, out_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky(self.dense(x))


class MLP(nn.Module):
    """Stack of PointwiseBlocks."""

    def __init__(self, in_features: int, features: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = [in_features, *features]
        self.layers = nn.ModuleList(
            PointwiseBlock(a, b, generator) for a, b in zip(widths, widths[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x
