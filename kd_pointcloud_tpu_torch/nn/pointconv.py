"""PointConv layers: WeightNet-weighted continuous convolutions.

Port of kd_pointcloud_tpu/nn/pointconv.py: group_knn, weighted_contract
(the experimental inventory's contraction), contract_dense, PointConv
(same resolution), PointConvD (FPS downsampling, with the nested-FPS
prefix and the blocked-FPS relaxation), PointConvNonLinear (its
depthwise + pointwise factorisation, non_linear's l3 and l4) and
PointConvDRand (the random-sampling ablation: the first npoint rows, no
preset uses it). The (C, W) pair is flattened c-major into the Dense
kernel, as the reference's .view(B, N, -1) does.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..ops import (furthest_point_sample, furthest_point_sample_blocked,
                   gather_points, group_points, knn_point)
from ..parallel.collectives import moments
from .blocks import Dense, _uniform_, leaky
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


def weighted_contract(grouped: torch.Tensor, weights: torch.Tensor
                      ) -> torch.Tensor:
    """(B, S, K, C) x (B, S, K, W) -> (B, S, C * W), flattened c-major."""
    B, S, _, C = grouped.shape
    return torch.einsum("bskc,bskw->bscw", grouped, weights).reshape(
        B, S, C * weights.shape[-1])


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
    """BatchNorm over the trailing channel axis of (B, N, C), with flax's
    nn.BatchNorm semantics: in train mode it normalises with the batch's
    biased variance and also moves running_var toward that biased variance
    (torch's own BatchNorm moves it toward the unbiased one). Eval mode is
    torch's, on the running statistics.

    Inside batch_stats_over(model, mesh) on a mesh of several ranks, train
    mode takes the mean and the biased variance over the global batch's
    rows, pad rows included, as the JAX package's sharded step does, and
    every rank moves its running statistics toward those same values."""

    mesh = None         # set by batch_stats_over for the step's forward

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1, x.shape[-1])
        if not self.training:
            return super().forward(flat).reshape(x.shape)
        if self.mesh is not None and self.mesh.size > 1:
            var, mean = moments(self.mesh, flat)
        else:
            var, mean = torch.var_mean(flat, dim=0, correction=0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        y = (flat - mean) * torch.rsqrt(var + self.eps) * self.weight
        return (y + self.bias).reshape(x.shape)


@contextlib.contextmanager
def batch_stats_over(model: nn.Module, mesh):
    """Within the block, every _BatchNorm of model (and so every BatchNorm
    of the port's models) takes its train-mode statistics over mesh's
    global batch; mesh None or of size 1 changes nothing."""
    if mesh is None or mesh.size == 1:
        yield
        return
    norms = [m for m in model.modules() if isinstance(m, _BatchNorm)]
    for m in norms:
        m.mesh = mesh
    try:
        yield
    finally:
        for m in norms:
            m.mesh = None


class FixedModeBatchNorm(_BatchNorm):
    """_BatchNorm held in one mode whatever train() or eval() asks: where
    the JAX package fixes use_running_average at the call (the inventory's
    heads and kernel aggregations)."""

    def __init__(self, num_features: int, train: bool, **kw):
        super().__init__(num_features, **kw)
        self.fixed_mode = train
        self.training = train

    def train(self, mode: bool = True):
        return super().train(self.fixed_mode)


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


def _prefix(xyz: torch.Tensor, npoint: int):
    """The leading npoint rows (contiguous) and their indices."""
    idx = torch.arange(npoint, dtype=torch.int32, device=xyz.device)
    return xyz[:, :npoint].contiguous(), idx.expand(xyz.shape[0], npoint)


def fps_or_prefix(xyz: torch.Tensor, npoint: int, prefix: bool,
                  fps_blocks: int = 1):
    """FPS-sample npoint rows, or take the leading npoint rows when prefix.

    Greedy FPS orderings are nested: on a cloud already in FPS-selection
    order, FPS of its first M rows selects exactly those rows in order
    (proof: kd_pointcloud_tpu/nn/pointconv.py _fps_or_prefix). So levels
    2-4 slice level 1's ordering and FPS runs once per pair. fps_blocks >
    1 samples with furthest_point_sample_blocked (exact FPS a block of rows,
    orderings interleaved)."""
    if prefix:
        return _prefix(xyz, npoint)
    if fps_blocks > 1:
        idx = furthest_point_sample_blocked(xyz, npoint, fps_blocks)
    else:
        idx = furthest_point_sample(xyz, npoint)
    return gather_points(xyz, idx), idx


class PointConvD(nn.Module):
    """FPS-downsampling PointConv. Returns (new_xyz, new_feat, fps_idx)."""

    def __init__(self, npoint: int, nsample: int, in_channel: int,
                 out_channel: int, weightnet: int = 16,
                 generator: torch.Generator | None = None,
                 fps_blocks: int = 1):
        super().__init__()
        self.npoint = npoint
        self.nsample = nsample
        self.fps_blocks = fps_blocks
        self.weightnet = WeightNet(weightnet, generator=generator)
        self.dense = Dense((3 + in_channel) * weightnet, out_channel,
                           generator)

    def forward(self, xyz, feats, prefix_sample: bool = False):
        new_xyz, fps_idx = fps_or_prefix(xyz, self.npoint, prefix_sample,
                                         self.fps_blocks)
        grouped, rel = group_knn(self.nsample, xyz, new_xyz, feats)
        y = contract_dense(grouped, self.weightnet(rel), self.dense)
        return new_xyz, leaky(y), fps_idx


class PointConvDRand(PointConvD):
    """The random-sampling ablation of PointConvD (the reference's
    pointconv_util.py PointConvDRand): the first npoint rows instead of
    FPS, as the JAX package takes them (the input clouds are already
    randomly sampled). Same parameters as PointConvD; no preset uses it.
    Returns (new_xyz, new_feat, idx)."""

    def forward(self, xyz, feats, prefix_sample: bool = False):
        return super().forward(xyz, feats, prefix_sample=True)


class PointConvNonLinear(nn.Module):
    """Depthwise + pointwise factorised downsampling conv (the reference's
    pointconv_util3.py PointConvNonLinear): the (C, W) contraction kept
    unflattened, a per-channel scale and bias over C = 3 + in_channel, a
    Dense C -> out_channel / W applied to each W slot, flattened back to
    out_channel (w-major), then leaky. No BatchNorm. Returns (new_xyz,
    new_feat, fps_idx) like PointConvD."""

    def __init__(self, npoint: int, nsample: int, in_channel: int,
                 out_channel: int, weightnet: int = 16,
                 generator: torch.Generator | None = None,
                 fps_blocks: int = 1):
        super().__init__()
        if out_channel % weightnet:
            raise ValueError(f"out_channel {out_channel} is not a multiple "
                             f"of weightnet {weightnet}")
        c = 3 + in_channel
        self.npoint = npoint
        self.nsample = nsample
        self.fps_blocks = fps_blocks
        self.weightnet = WeightNet(weightnet, generator=generator)
        self.depthwise = nn.Parameter(torch.empty(c, 1))
        _uniform_(self.depthwise, c, generator)
        self.depthwise_bias = nn.Parameter(torch.zeros(c))
        self.dense = Dense(c, out_channel // weightnet, generator)

    def forward(self, xyz, feats, prefix_sample: bool = False):
        new_xyz, fps_idx = fps_or_prefix(xyz, self.npoint, prefix_sample,
                                         self.fps_blocks)
        grouped, rel = group_knn(self.nsample, xyz, new_xyz, feats)
        y = torch.einsum("bskc,bskw->bscw", grouped, self.weightnet(rel))
        y = y * self.depthwise + self.depthwise_bias[:, None]
        y = self.dense(y.transpose(-1, -2))          # (B, S, W, out / W)
        return new_xyz, leaky(y.flatten(2)), fps_idx
