"""Basic building blocks on channels-last (B, N, C) tensors.

Port of kd_pointcloud_tpu/nn/blocks.py: Dense, leaky (ops.leaky, slope 1 at
0 as jax.nn.leaky_relu), PointwiseBlock, MLP, the students' level block
BottleNeck with its DepthwiseReLU branch, and the inventory's point-axis
ConvGRU. Weights follow torch's
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


def _uniform_(p: torch.Tensor, fan_in: int,
              generator: torch.Generator | None) -> None:
    """U(+-1/sqrt(fan_in)) in place: torch's kaiming_uniform(a=sqrt 5)."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound)
                - bound)


class Dense(nn.Module):
    """Linear layer over the trailing axis; weight is (out, in); no bias
    where use_bias is False (flax's Dense(use_bias=False))."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator | None = None,
                 use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if use_bias
                     else None)
        for p in (self.weight, self.bias):
            if p is not None:
                _uniform_(p, in_features, generator)

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


class DepthwiseReLU(nn.Module):
    """The reference's ConvBNReLU (grouped 1x1 conv, groups = in channels,
    no bias) + ReLU: input channel c scales into output channels
    c * mult .. c * mult + mult - 1, mult = out // in. weight is (mult,
    in), the transpose of flax's (in, mult) kernel."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        if out_features % in_features:
            raise ValueError("grouped conv needs out % in == 0: "
                             f"{out_features} % {in_features}")
        self.weight = nn.Parameter(
            torch.empty(out_features // in_features, in_features))
        _uniform_(self.weight, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x[..., :, None] * self.weight.t()
        return torch.relu(y.reshape(*x.shape[:-1], -1))


class PointConv1d3(nn.Module):
    """A 3-tap convolution along the point axis of (B, N, C), zero padding
    1 (flax nn.Conv, padding SAME); weight (out, in, 3), torch's conv1d
    layout; a bias, zeros at init as flax's, where use_bias. Each batch row
    is convolved on its own, so clouds stacked on the batch axis never
    mix."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator | None = None,
                 use_bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features, 3))
        _uniform_(self.weight, 3 * in_features, generator)
        self.bias = (nn.Parameter(torch.zeros(out_features)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x.transpose(1, 2), self.weight, self.bias,
                        padding=1).transpose(1, 2)


class BottleNeck(nn.Module):
    """Residual bottleneck (the reference's pointconv_util3.py BottleNeck):
    Dense(mid), the 3-tap point-axis conv, Dense(features), no inner
    activations, then relu(h + x + DepthwiseReLU(x))."""

    def __init__(self, in_features: int, mid: int, features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        if in_features != features:
            raise ValueError("the identity branch needs in == out: "
                             f"{in_features} != {features}")
        self.dense = Dense(in_features, mid, generator)
        self.conv = PointConv1d3(mid, mid, generator)
        self.dense1 = Dense(mid, features, generator)
        self.depthwise = DepthwiseReLU(in_features, features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dense1(self.conv(self.dense(x)))
        return torch.relu(h + x + self.depthwise(x))


class ConvGRU(nn.Module):
    """Point-axis GRU cell of the experimental inventory (the reference's
    pointconv_util.py ConvGRU): z, r from the 3-tap convs convz / convr of
    [h, x], q from convq of [r h, x], each conv followed by leaky; returns
    (1 - z) h + z q. in_features: x's width."""

    def __init__(self, in_features: int, hidden: int = 128,
                 generator: torch.Generator | None = None):
        super().__init__()
        width = hidden + in_features
        self.convz = PointConv1d3(width, hidden, generator, use_bias=True)
        self.convr = PointConv1d3(width, hidden, generator, use_bias=True)
        self.convq = PointConv1d3(width, hidden, generator, use_bias=True)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([h, x], dim=-1)
        z = torch.sigmoid(leaky(self.convz(hx)))
        r = torch.sigmoid(leaky(self.convr(hx)))
        q = torch.tanh(leaky(self.convq(torch.cat([r * h, x], dim=-1))))
        return (1 - z) * h + z * q
