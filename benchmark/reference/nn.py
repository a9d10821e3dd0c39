"""Plain PyTorch modules of the reference, on channels-last (B, N, C).

Parameter names follow the measured model's state_dict, so one set of
seeded weights loads into both. Dense weights are (out, in).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .ops import (feature_knn, fps, gather_points, group_points, knn, leaky,
                  pool)


class Dense(nn.Module):
    def __init__(self, fan_in: int, fan_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(fan_out, fan_in))
        self.bias = nn.Parameter(torch.zeros(fan_out))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class PointwiseBlock(nn.Module):
    def __init__(self, fan_in: int, fan_out: int):
        super().__init__()
        self.dense = Dense(fan_in, fan_out)

    def forward(self, x):
        return leaky(self.dense(x))


class MLP(nn.Module):
    def __init__(self, fan_in: int, widths):
        super().__init__()
        w = [fan_in, *widths]
        self.layers = nn.ModuleList(PointwiseBlock(a, b)
                                    for a, b in zip(w, w[1:]))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class WeightNet(nn.Module):
    """Dense 3 -> 8 -> 8 -> W over relative coordinates, ReLU after each."""

    def __init__(self, width: int):
        super().__init__()
        w = [3, 8, 8, width]
        self.layers = nn.ModuleList(Dense(a, b) for a, b in zip(w, w[1:]))

    def forward(self, x):
        for layer in self.layers:
            x = torch.relu(layer(x))
        return x


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis with flax's train mode: normalise by the
    batch's biased variance and move running_var toward it."""

    def forward(self, x):
        flat = x.reshape(-1, x.shape[-1])
        if not self.training:
            return super().forward(flat).reshape(x.shape)
        var, mean = torch.var_mean(flat, dim=0, correction=0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        y = (flat - mean) * torch.rsqrt(var + self.eps) * self.weight
        return (y + self.bias).reshape(x.shape)


def contract(grouped, weights, dense: Dense):
    """Dense over the (channel, weight) contraction of grouped (B, S, K, C)
    and weights (B, S, K, W), flattened channel-major, as two parts: the 3
    coordinate channels and the features."""
    C, W = grouped.shape[-1], weights.shape[-1]
    kern = dense.weight.t().reshape(C, W, -1)

    def part(g, k3):
        y = torch.einsum("bskc,bskw->bscw", g, weights)
        return torch.einsum("bscw,cwo->bso", y, k3)

    out = part(grouped[..., :3], kern[:3])
    if C > 3:
        out = out + part(grouped[..., 3:], kern[3:])
    return out + dense.bias


def group(nsample, xyz, query, feats, idx=None, rel=None):
    if idx is None:
        idx = knn(nsample, xyz, query)[1]
    if rel is None:
        rel = group_points(xyz, idx) - query[:, :, None, :]
    return torch.cat([rel, group_points(feats, idx)], dim=-1), rel


class PointConv(nn.Module):
    def __init__(self, nsample, fan_in, fan_out, weightnet=16, bn=False):
        super().__init__()
        self.nsample = nsample
        self.weightnet = WeightNet(weightnet)
        self.dense = Dense((3 + fan_in) * weightnet, fan_out)
        self.bn = BatchNorm(fan_out, eps=1e-5, momentum=0.1) if bn else None

    def forward(self, xyz, feats, idx=None, rel=None):
        grouped, rel = group(self.nsample, xyz, xyz, feats, idx, rel)
        y = contract(grouped, self.weightnet(rel), self.dense)
        if self.bn is not None:
            y = self.bn(y)
        return leaky(y)


class PointConvD(nn.Module):
    """FPS downsampling (or the leading rows, on a cloud already in FPS
    order) and a PointConv around the sampled points."""

    def __init__(self, npoint, nsample, fan_in, fan_out, weightnet=16):
        super().__init__()
        self.npoint = npoint
        self.nsample = nsample
        self.weightnet = WeightNet(weightnet)
        self.dense = Dense((3 + fan_in) * weightnet, fan_out)

    def forward(self, xyz, feats, prefix=False):
        if prefix:
            new_xyz = xyz[:, :self.npoint].contiguous()
            idx = torch.arange(self.npoint, dtype=torch.int32,
                               device=xyz.device).expand(xyz.shape[0], -1)
        else:
            idx = fps(xyz, self.npoint)
            new_xyz = gather_points(xyz, idx)
        grouped, rel = group(self.nsample, xyz, new_xyz, feats)
        y = contract(grouped, self.weightnet(rel), self.dense)
        return new_xyz, leaky(y), idx


def bid_knn(nsample, pc1, pc2, search):
    """Both directions' neighbours, one search over the stacked clouds."""
    B = pc1.shape[0]
    idx = search(nsample, torch.cat([pc2, pc1]), torch.cat([pc1, pc2]))
    return idx[:B], idx[B:]


def _knn_idx(k, xyz, query):
    return knn(k, xyz, query)[1]


def cost_pool(xyz1, xyz2, f1, f2, pos: Dense, mlp: MLP, idx):
    """max over neighbours idx of mlp(f2[idx] + f1 + pos(xyz2[idx] - xyz1)),
    the position term split into a key table and a query term."""
    u = f2 + pos(xyz2)
    v = f1 - pos(xyz1) + pos(torch.zeros_like(xyz1[:, :1, :]))
    layer = mlp.layers[0].dense
    return pool(u, idx, v, layer.weight, layer.bias)


class CrossLayer(nn.Module):
    """Two-round bidirectional cost volume; with fg, a point's neighbours
    are its nsample / 2 nearest in feature space, then its nsample / 2
    nearest in 3-D."""

    def __init__(self, nsample, fan_in, width, fg=False):
        super().__init__()
        self.nsample = nsample
        self.fg = fg
        self.cross_t11 = Dense(fan_in, width)
        self.cross_t22 = Dense(fan_in, width)
        self.pos1 = Dense(3, width)
        self.mlp1 = MLP(width, (width,))
        self.cross_t1 = Dense(width, width)
        self.cross_t2 = Dense(width, width)
        self.pos2 = Dense(3, width)
        self.mlp2 = MLP(width, (width,))

    def feature_neighbours(self, g1, g2):
        return bid_knn(self.nsample // 2, g1, g2, feature_knn)

    def forward(self, pc1, pc2, feat1, feat2, feat_idx=None):
        if self.fg:
            f12, f21 = feat_idx
            e12, e21 = bid_knn(self.nsample // 2, pc1, pc2, _knn_idx)
            idx12 = torch.cat([f12, e12], -1)
            idx21 = torch.cat([f21, e21], -1)
        else:
            idx12, idx21 = bid_knn(self.nsample, pc1, pc2, _knn_idx)
        new2 = cost_pool(pc2, pc1, self.cross_t11(feat2),
                         self.cross_t22(feat1), self.pos1, self.mlp1, idx21)
        new1 = cost_pool(pc1, pc2, self.cross_t11(feat1),
                         self.cross_t22(feat2), self.pos1, self.mlp1, idx12)
        new1, new2 = self.cross_t1(new1), self.cross_t2(new2)
        final = cost_pool(pc1, pc2, new1, new2, self.pos2, self.mlp2, idx12)
        return new1, new2, final


class FlowHead(nn.Module):
    """[feats, cost] -> two BatchNorm PointConvs over one 9-NN -> MLP ->
    Dense to 3, clamped at +-200, plus the upsampled flow."""

    def __init__(self, feat, cost, channels=(128, 128), mlp=(128, 64),
                 weightnet=16):
        super().__init__()
        w = [feat + cost, *channels]
        self.convs = nn.ModuleList(PointConv(9, a, b, weightnet, bn=True)
                                   for a, b in zip(w, w[1:]))
        self.mlp = MLP(w[-1], mlp)
        self.dense = Dense(mlp[-1], 3)

    def forward(self, xyz, feats, cost, flow=None):
        x = torch.cat([feats, cost], dim=-1)
        idx = knn(9, xyz, xyz)[1]
        rel = group_points(xyz, idx) - xyz[:, :, None, :]
        for conv in self.convs:
            x = conv(xyz, x, idx, rel)
        x = self.mlp(x)
        local = torch.clamp(self.dense(x), -200.0, 200.0)
        return x, local if flow is None else local + flow
