"""SO(3)-equivariant vector-neuron layers (the experimental inventory's).

Port of kd_pointcloud_tpu/nn/vn_layers.py, used by experimental.VNNConvD.
A vector feature is (..., F, 3): F vector channels of a 3-vector each.
Linear maps mix the F axis only (weight (F_out, F_in), the transpose of
flax's kernel), which keeps equivariance. BatchNorm statistics follow
flax's (nn/pointconv.py _BatchNorm).
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import _uniform_
from .pointconv import _BatchNorm

EPS = 1e-6


def _channel_weight(f_in: int, f_out: int,
                    generator: torch.Generator | None) -> nn.Parameter:
    p = nn.Parameter(torch.empty(f_out, f_in))
    _uniform_(p, f_in, generator)
    return p


def channel_linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Bias-free linear over the vector-channel axis (-2)."""
    return torch.einsum("...fc,gf->...gc", x, weight)


def vn_leaky(p: torch.Tensor, d: torch.Tensor,
             negative_slope: float = 0.2) -> torch.Tensor:
    """Direction-gated leaky nonlinearity: where p points against the
    learned direction d, its component along d is removed."""
    dot = (p * d).sum(-1, keepdim=True)
    mask = (dot >= 0).to(p.dtype)
    d_norm_sq = (d * d).sum(-1, keepdim=True)
    reflected = p - (dot / (d_norm_sq + EPS)) * d
    return negative_slope * p + (1 - negative_slope) * (
        mask * p + (1 - mask) * reflected)


class VNLinear(nn.Module):
    def __init__(self, in_features: int, features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = _channel_weight(in_features, features, generator)

    def forward(self, x):
        return channel_linear(x, self.weight)


class VNLeakyReLU(nn.Module):
    def __init__(self, in_features: int, share_nonlinearity: bool = False,
                 negative_slope: float = 0.2,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.negative_slope = negative_slope
        self.dir_weight = _channel_weight(
            in_features, 1 if share_nonlinearity else in_features, generator)

    def forward(self, x):
        return vn_leaky(x, channel_linear(x, self.dir_weight),
                        self.negative_slope)


class VNBatchNorm(nn.Module):
    """Normalises vector magnitudes with a BatchNorm over the per-channel
    norms, keeping directions; train or eval statistics by the module's
    mode. Its BatchNorm is a _BatchNorm, so on a data mesh
    (pointconv.batch_stats_over) the statistics are the global batch's."""

    def __init__(self, features: int):
        super().__init__()
        self.bn = _BatchNorm(features, eps=1e-5, momentum=0.1)

    def forward(self, x):
        norm = torch.linalg.norm(x, dim=-1) + EPS
        return x / norm[..., None] * self.bn(norm)[..., None]


class VNLinearLeakyReLU(nn.Module):
    def __init__(self, in_features: int, features: int,
                 share_nonlinearity: bool = False,
                 negative_slope: float = 0.2, use_batchnorm: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.negative_slope = negative_slope
        self.weight = _channel_weight(in_features, features, generator)
        self.bn = VNBatchNorm(features) if use_batchnorm else None
        self.dir_weight = _channel_weight(
            in_features, 1 if share_nonlinearity else features, generator)

    def forward(self, x):
        p = channel_linear(x, self.weight)
        if self.bn is not None:
            p = self.bn(p)
        return vn_leaky(p, channel_linear(x, self.dir_weight),
                        self.negative_slope)


class VNMaxPool(nn.Module):
    """Pool over the sample axis (-3) of (..., K, F, 3): per channel, the
    sample with the largest projection on a learned direction (the first
    such sample on a tie)."""

    def __init__(self, features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dir_weight = _channel_weight(features, features, generator)

    def forward(self, x):
        dot = (x * channel_linear(x, self.dir_weight)).sum(-1)  # (..., K, F)
        idx = dot.argmax(dim=-2, keepdim=True)                   # (..., 1, F)
        return torch.gather(x, -3, idx[..., None].expand(
            *idx.shape, 3)).squeeze(-3)


def vn_mean_pool(x: torch.Tensor, axis: int = -3) -> torch.Tensor:
    return x.mean(dim=axis)


class VNStdFeature(nn.Module):
    """Rotation-invariant features from a learned frame: two
    VNLinearLeakyReLU (F -> F/2 -> F/4), a channel linear to the frame's 3
    (or 2, completed by a cross product, where normalize_frame) vectors.
    Returns (x_std (..., F, 3 or 3), frame)."""

    def __init__(self, in_features: int, normalize_frame: bool = False,
                 share_nonlinearity: bool = False,
                 negative_slope: float = 0.2,
                 generator: torch.Generator | None = None):
        super().__init__()
        f = in_features
        self.normalize_frame = normalize_frame
        self.linear_leaky = VNLinearLeakyReLU(
            f, f // 2, share_nonlinearity, negative_slope,
            generator=generator)
        self.linear_leaky1 = VNLinearLeakyReLU(
            f // 2, f // 4, share_nonlinearity, negative_slope,
            generator=generator)
        self.frame_weight = _channel_weight(
            f // 4, 2 if normalize_frame else 3, generator)

    def forward(self, x):
        z = self.linear_leaky1(self.linear_leaky(x))
        z = channel_linear(z, self.frame_weight)
        if self.normalize_frame:
            v1 = z[..., 0, :]
            u1 = v1 / (torch.linalg.norm(v1, dim=-1, keepdim=True) + EPS)
            v2 = z[..., 1, :]
            v2 = v2 - (v2 * u1).sum(-1, keepdim=True) * u1
            u2 = v2 / (torch.linalg.norm(v2, dim=-1, keepdim=True) + EPS)
            frame = torch.stack([u1, u2, torch.linalg.cross(u1, u2)],
                                dim=-2)
        else:
            frame = z
        return torch.einsum("...fc,...gc->...fg", x, frame), frame
