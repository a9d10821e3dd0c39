"""Experimental / ablation modules of the reference ops library.

Port of kd_pointcloud_tpu/nn/experimental.py, class by class in that file's
order: the PointConv variants and down-samplers, the cross layers, the
flow-head variants, PointWarpingSimple and the omission ledger of the
reference's vote file. None is on a preset's path; they are the capability
surface for researchers coming from the reference.

FPS and the 3-D kNN run the hand-written kernels on the card (ops/fps.py,
ops/knn.py; up to k = 64, which CrossLocalTransLayer's 2 nsample reaches);
the groupings, maxes, attention einsums, softmaxes and Dense layers are
plain PyTorch on every device, as they are XLA in the JAX package.

Flax builds a module's layers at its first call; here each constructor
takes its inputs' widths. A layer flax creates once and calls twice (qk,
cross_conv, t1 / t2 / pos, the cross_t* projections) is one module called
twice here, so the parameter is shared, not copied. Layers keep flax's
names: a named one its name, flax's Dense_0, Dense_1, Dense_2 ... the
attributes dense, dense1, dense2 ... (models/jax_bridge.py maps them).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops import (furthest_point_sample, gather_points, group_points,
                   knn_point, upsample_idw)
from .blocks import MLP, Dense, leaky
from .pointconv import (FixedModeBatchNorm, PointConv, group_knn,
                        weighted_contract)
from .vn_layers import VNLinearLeakyReLU, VNMaxPool
from .weightnet import WeightNet


def _indexed(module: nn.Module, name: str, layers) -> list:
    """Register layers as name, name1, name2 ... (flax's Name_0, Name_1,
    Name_2 ...) on module; returns them as a list, in order."""
    layers = list(layers)
    for i, layer in enumerate(layers):
        module.add_module(name if i == 0 else f"{name}{i}", layer)
    return layers


def _dense_chain(in_features: int, widths: Sequence[int], g,
                 use_bias: bool = True) -> list:
    out = []
    for w in widths:
        out.append(Dense(in_features, w, g, use_bias))
        in_features = w
    return out


def _fps(xyz, npoint):
    fps_idx = furthest_point_sample(xyz, npoint)
    return gather_points(xyz, fps_idx), fps_idx


def _cross_group(nsample, xyz1, xyz2, points1, points2):
    """Each cloud-1 point's nsample nearest cloud-2 points: (idx, their
    xyz, direction from the query, [tiled points1, grouped points2])."""
    idx = knn_point(nsample, xyz2, xyz1)
    neighbor_xyz = group_points(xyz2, idx)
    direction = neighbor_xyz - xyz1[:, :, None, :]
    g2 = group_points(points2, idx)
    g1 = points1[:, :, None, :].expand(*g2.shape[:3], points1.shape[-1])
    return idx, neighbor_xyz, direction, torch.cat([g1, g2], dim=-1)


def _light_pool(nsample, xyz1, xyz2, p1, p2, pos, mlp=None):
    """The additive positional-encoding cost volume of CrossLayerLight:
    max_k mlp(leaky(g2 + p1 + pos(dxyz))); also the pre-pool tensor and
    the neighbours' positions."""
    idx = knn_point(nsample, xyz2, xyz1)
    neighbor_xyz = group_points(xyz2, idx)
    direction = neighbor_xyz - xyz1[:, :, None, :]
    h = leaky(group_points(p2, idx) + p1[:, :, None, :] + pos(direction))
    if mlp is not None:
        h = mlp(h)
    return h.amax(dim=2), h, neighbor_xyz


class PointConvSVD(nn.Module):
    """PointConv with a rank-factorised output linear (C W -> out / 2 ->
    out, no activation between)."""

    def __init__(self, nsample: int, in_channel: int, out_channel: int,
                 weightnet: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.nsample = nsample
        self.weightnet = WeightNet(weightnet, generator=g)
        self.dense = Dense((3 + in_channel) * weightnet, out_channel // 2, g)
        self.dense1 = Dense(out_channel // 2, out_channel, g)

    def forward(self, xyz, feats):
        grouped, rel = group_knn(self.nsample, xyz, xyz, feats)
        y = weighted_contract(grouped, self.weightnet(rel))
        return leaky(self.dense1(self.dense(y)))


class PointConvBias(nn.Module):
    """PointConv with a learned additive bias on the contracted (C, W)
    block (normal init), leaky, a Dense over C and a sum over W."""

    def __init__(self, nsample: int, in_channel: int, out_channel: int,
                 weightnet: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        c = 3 + in_channel
        self.nsample = nsample
        self.weightnet = WeightNet(weightnet, generator=g)
        self.bias = nn.Parameter(torch.randn((1, 1, c, weightnet),
                                             generator=g))
        self.dense = Dense(c, out_channel, g)

    def forward(self, xyz, feats):
        grouped, rel = group_knn(self.nsample, xyz, xyz, feats)
        y = torch.einsum("bskc,bskw->bscw", grouped, self.weightnet(rel))
        y = leaky(y + self.bias).transpose(-1, -2)        # (B, S, W, C)
        return leaky(self.dense(y).sum(-2))


class PointConvFactor(nn.Module):
    """Factorised PointConv: the contracted (C, W) block viewed as
    (2 C, W / 2) rows, mixed by Dense(2 C -> out / 2) and Dense(-> 32) over
    each of the W / 2 slots; output width 16 W."""

    def __init__(self, nsample: int, in_channel: int, out_channel: int,
                 weightnet: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.nsample = nsample
        self.half = weightnet // 2
        self.weightnet = WeightNet(weightnet, generator=g)
        self.dense = Dense(2 * (3 + in_channel), out_channel // 2, g)
        self.dense1 = Dense(out_channel // 2, 32, g)

    @staticmethod
    def out_channel(weightnet: int = 16) -> int:
        return weightnet // 2 * 32

    def forward(self, xyz, feats):
        grouped, rel = group_knn(self.nsample, xyz, xyz, feats)
        B, S, _, C = grouped.shape
        y = torch.einsum("bskc,bskw->bscw", grouped, self.weightnet(rel))
        y = y.reshape(B, S, 2 * C, self.half).transpose(-1, -2)
        y = leaky(self.dense1(leaky(self.dense(y))))
        return y.reshape(B, S, -1)


class _KernelAgg(nn.Module):
    """Shared body of PointConvK / SepConv: a per-neighbourhood learned
    kernel (C -> out, BatchNorm, leaky), the bilinear aggregation
    kernel^T feats -> (out, C), a 1-channel reduction over C (BatchNorm,
    leaky), an output Dense. Both BatchNorms use their running statistics
    in every mode, as the JAX package's use_running_average=True."""

    def __init__(self, nsample: int, in_channel: int, out_channel: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        c = 3 + in_channel
        self.nsample = nsample
        self.dense = Dense(c, out_channel, g, use_bias=False)
        self.bn = FixedModeBatchNorm(out_channel, train=False, eps=1e-5,
                                     momentum=0.1)
        self.dense1 = Dense(c, 1, g, use_bias=False)
        self.bn1 = FixedModeBatchNorm(1, train=False, eps=1e-5,
                                      momentum=0.1)
        self.dense2 = Dense(out_channel, out_channel, g)

    def forward(self, xyz, feats):
        grouped, _ = group_knn(self.nsample, xyz, xyz, feats)
        kernel = leaky(self.bn(self.dense(grouped)))
        agg = torch.einsum("bsko,bskc->bsoc", kernel, grouped)
        agg = leaky(self.bn1(self.dense1(agg)))[..., 0]
        return leaky(self.dense2(agg))


class PointConvK(_KernelAgg):
    """pointconv_util.py PointConvK."""


class SepConv(_KernelAgg):
    """pointconv_util.py SepConv (PointConvK's computation, its own
    weights)."""


class VNNConvD(nn.Module):
    """Vector-neuron downsampling conv: FPS, kNN group, the (3 + C) rows
    as (3 + C) / 3 vector channels, VN linear + leaky, VN max pool over the
    neighbourhood. Returns (new_xyz, (B, S, 3 out) features, fps_idx)."""

    def __init__(self, npoint: int, nsample: int, in_channel: int,
                 out_channel: int, generator: torch.Generator | None = None):
        super().__init__()
        if (3 + in_channel) % 3:
            raise ValueError(f"3 + in_channel = {3 + in_channel} is not a "
                             f"whole number of 3-vectors")
        self.npoint = npoint
        self.nsample = nsample
        self.linear_leaky = VNLinearLeakyReLU(
            (3 + in_channel) // 3, out_channel, use_batchnorm=False,
            generator=generator)
        self.max_pool = VNMaxPool(out_channel, generator=generator)

    def forward(self, xyz, feats):
        new_xyz, fps_idx = _fps(xyz, self.npoint)
        grouped, _ = group_knn(self.nsample, xyz, new_xyz, feats)
        B, S, K, D = grouped.shape
        v = self.linear_leaky(grouped.reshape(B, S, K, D // 3, 3))
        return new_xyz, self.max_pool(v).reshape(B, S, -1), fps_idx


class PointConvFlow(nn.Module):
    """PointPWC patch-to-patch cost volume: an MLP over [g1, g2, dxyz]
    weighted by WeightNet(dxyz) and summed over the cloud-2 neighbours,
    then a WeightNet-weighted sum over the cloud-1 self-neighbourhood.
    in_channel: each cloud's feature width."""

    def __init__(self, nsample: int, in_channel: int, mlp: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.nsample = nsample
        self.layers = _indexed(self, "dense",
                               _dense_chain(2 * in_channel + 3, mlp, g))
        self.weightnet1 = WeightNet(mlp[-1], generator=g)
        self.weightnet2 = WeightNet(mlp[-1], generator=g)

    def forward(self, xyz1, xyz2, points1, points2):
        _, _, direction, g12 = _cross_group(self.nsample, xyz1, xyz2,
                                            points1, points2)
        h = torch.cat([g12, direction], dim=-1)
        for layer in self.layers:
            h = leaky(layer(h))
        p2p = (self.weightnet1(direction) * h).sum(2)
        knn_self = knn_point(self.nsample, xyz1, xyz1)
        dir_self = group_points(xyz1, knn_self) - xyz1[:, :, None, :]
        return (self.weightnet2(dir_self)
                * group_points(p2p, knn_self)).sum(2)


class CrossLayerConcat(nn.Module):
    """Concat-style bidirectional cost volume (the reference's CrossLayer):
    [g1, g2, dxyz] -> MLP -> max, both directions with mlp1, then a fusion
    round with mlp2. Returns (f1, f2) or (f1, f2, f_final)."""

    def __init__(self, nsample: int, in_channel: int, mlp1: Sequence[int],
                 mlp2: Optional[Sequence[int]] = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.nsample = nsample
        chain1 = _dense_chain(2 * in_channel + 3, mlp1, g)
        chain2 = ([] if mlp2 is None
                  else _dense_chain(2 * mlp1[-1] + 3, mlp2, g))
        layers = _indexed(self, "dense", chain1 + chain2)
        self.mlp1_layers = layers[:len(chain1)]
        self.mlp2_layers = None if mlp2 is None else layers[len(chain1):]

    def _cross(self, xyz1, xyz2, points1, points2, layers):
        _, _, direction, g12 = _cross_group(self.nsample, xyz1, xyz2,
                                            points1, points2)
        h = torch.cat([g12, direction], dim=-1)
        for layer in layers:
            h = leaky(layer(h))
        return h.amax(dim=2)

    def forward(self, pc1, pc2, feat1, feat2):
        f1 = self._cross(pc1, pc2, feat1, feat2, self.mlp1_layers)
        f2 = self._cross(pc2, pc1, feat2, feat1, self.mlp1_layers)
        if self.mlp2_layers is None:
            return f1, f2
        return f1, f2, self._cross(pc1, pc2, f1, f2, self.mlp2_layers)


class CrossConvLayer(nn.Module):
    """WeightNet-weighted cross conv: [g1, g2] contracted with
    WeightNet(dxyz) weights, then a linear and leaky, both directions with
    weightnet1 / linear1, then a fusion round with weightnet2 / linear2."""

    def __init__(self, nsample: int, in_channel: int, mid_channel: int,
                 out_channel: Optional[int] = None, weightnet: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.nsample = nsample
        self.weightnet1 = WeightNet(weightnet, generator=g)
        self.linear1 = Dense(2 * in_channel * weightnet, mid_channel, g)
        self.second = out_channel is not None
        if self.second:
            self.weightnet2 = WeightNet(weightnet, generator=g)
            self.linear2 = Dense(2 * mid_channel * weightnet, out_channel, g)

    def _cross(self, xyz1, xyz2, points1, points2, wnet, linear):
        _, _, direction, g12 = _cross_group(self.nsample, xyz1, xyz2,
                                            points1, points2)
        return leaky(linear(weighted_contract(g12, wnet(direction))))

    def forward(self, pc1, pc2, feat1, feat2):
        f1 = self._cross(pc1, pc2, feat1, feat2, self.weightnet1,
                         self.linear1)
        f2 = self._cross(pc2, pc1, feat2, feat1, self.weightnet1,
                         self.linear1)
        if not self.second:
            return f1, f2
        return f1, f2, self._cross(pc1, pc2, f1, f2, self.weightnet2,
                                   self.linear2)


class FlowEmbeddingLayer(nn.Module):
    """FlowNet3D-style flow embedding: one direction, [g1, g2, dxyz] ->
    MLP -> max. in_channel: each cloud's feature width."""

    def __init__(self, nsample: int, in_channel: int, mlp: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        self.nsample = nsample
        self.mlp = MLP(2 * in_channel + 3, mlp, generator)

    def forward(self, pc1, pc2, feat1, feat2):
        _, _, direction, g12 = _cross_group(self.nsample, pc1, pc2, feat1,
                                            feat2)
        return self.mlp(torch.cat([g12, direction], dim=-1)).amax(dim=2)


class LocalFeatureAggregation(nn.Module):
    """RandLA-Net-style attentive aggregation: a positional encoding of
    [center, neighbour, dxyz, |dxyz|] beside the grouped projected
    features, softmax attention over the neighbourhood, an output Dense."""

    def __init__(self, nsample: int, in_channel: int, out_channel: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        half = out_channel // 2
        self.nsample = nsample
        self.dense = Dense(10, half, g)
        self.dense1 = Dense(in_channel, half, g)
        self.dense2 = Dense(2 * half, 2 * half, g, use_bias=False)
        self.dense3 = Dense(2 * half, out_channel, g)

    def forward(self, xyz, feats):
        idx = knn_point(self.nsample, xyz, xyz)
        neighbor_xyz = group_points(xyz, idx)
        rel = neighbor_xyz - xyz[:, :, None, :]
        dist = torch.linalg.norm(rel, dim=-1, keepdim=True)
        center = xyz[:, :, None, :].expand(neighbor_xyz.shape)
        pos_enc = leaky(self.dense(torch.cat(
            [center, neighbor_xyz, rel, dist], dim=-1)))
        h = torch.cat([pos_enc, group_points(leaky(self.dense1(feats)), idx)],
                      dim=-1)
        att = torch.softmax(self.dense2(h), dim=2)
        return leaky(self.dense3((att * h).sum(2)))


class SetAbstract(nn.Module):
    """PointNet++-style set abstraction at the same resolution: kNN group,
    pointwise MLP, max over the neighbourhood."""

    def __init__(self, nsample: int, in_channel: int, mlp: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        self.nsample = nsample
        self.mlp = MLP(3 + in_channel, mlp, generator)

    def forward(self, xyz, feats):
        grouped, _ = group_knn(self.nsample, xyz, xyz, feats)
        return self.mlp(grouped).amax(dim=2)


class SetAbstractD(nn.Module):
    """Downsampling set abstraction: FPS, group, MLP, max. Returns
    (new_xyz, features, fps_idx)."""

    def __init__(self, npoint: int, nsample: int, in_channel: int,
                 mlp: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        self.npoint = npoint
        self.nsample = nsample
        self.mlp = MLP(3 + in_channel, mlp, generator)

    def forward(self, xyz, feats):
        new_xyz, fps_idx = _fps(xyz, self.npoint)
        grouped, _ = group_knn(self.nsample, xyz, new_xyz, feats)
        return new_xyz, self.mlp(grouped).amax(dim=2), fps_idx


class CrossLayerLightUp(nn.Module):
    """Cross-resolution cross layer: each dense point against its sparse
    neighbours, leaky(g_sparse + t_dense + pos(dxyz)) -> MLP -> max."""

    def __init__(self, nsample: int, dense_channel: int, sparse_channel: int,
                 mlp1: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.nsample = nsample
        self.cross_td = Dense(dense_channel, mlp1[0], g)
        self.cross_ts = Dense(sparse_channel, mlp1[0], g)
        self.pos = Dense(3, mlp1[0], g)
        self.mlp = MLP(mlp1[0], mlp1[1:], g)

    def forward(self, pc_dense, pc_sparse, feat_dense, feat_sparse):
        return _light_pool(self.nsample, pc_dense, pc_sparse,
                           self.cross_td(feat_dense),
                           self.cross_ts(feat_sparse), self.pos,
                           self.mlp)[0]


class PointWarpingSimple:
    """xyz2 - flow1; callable, no parameters."""

    def __call__(self, xyz1, xyz2, flow1):
        return xyz2 - flow1


def _trans_rounds(module, in_channel, mlp, value_extra, g):
    """Register each round's shared qk (C -> C) and cross_conv
    (value_extra + C -> ch) as dense{2i}, dense{2i + 1}; the residual add
    needs ch == C."""
    layers = []
    for ch in mlp:
        if ch != in_channel:
            raise ValueError(f"the residual add needs mlp widths equal to "
                             f"the feature width {in_channel}: {tuple(mlp)}")
        layers += [Dense(in_channel, in_channel, g),
                   Dense(value_extra + in_channel, ch, g)]
    layers = _indexed(module, "dense", layers)
    return list(zip(layers[0::2], layers[1::2]))


class CrossTransLayer(nn.Module):
    """Global-attention cross layer: a shared q/k projection, full
    N1 x N2 attention both ways (softmax over the other cloud), value
    [xyz, feats], leaky(cross_conv(.)) added to the features; an optional
    FlowEmbeddingLayer fusion (mlp2). The second direction's einsum
    pairs the transposed attention with cloud 1's values as the JAX
    package does, which needs N1 == N2."""

    def __init__(self, nsample: int, in_channel: int, mlp: Sequence[int],
                 mlp2: Optional[Sequence[int]] = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.rounds = _trans_rounds(self, in_channel, mlp, 3, generator)
        self.flow_embedding = (None if mlp2 is None else FlowEmbeddingLayer(
            nsample, in_channel, mlp2, generator))

    def forward(self, pc1, pc2, feat1, feat2):
        f1, f2 = feat1, feat2
        for qk, cross_conv in self.rounds:
            q1, q2 = leaky(qk(f1)), leaky(qk(f2))
            atten = torch.einsum("bnc,bmc->bnm", q1, q2)
            a1 = torch.softmax(atten.transpose(1, 2), dim=-1)   # B, N2, N1
            a2 = torch.softmax(atten, dim=-1)                   # B, N1, N2
            v2 = torch.cat([pc2, f2], dim=-1)
            v1 = torch.cat([pc1, f1], dim=-1)
            f1 = leaky(cross_conv(torch.einsum("bnm,bmc->bnc", a2, v2))) + f1
            f2 = leaky(cross_conv(torch.einsum(
                "bmn,bnc->bmc", a1.transpose(1, 2), v1))) + f2
        if self.flow_embedding is None:
            return f1, f2
        return f1, f2, self.flow_embedding(pc1, pc2, f1, f2)


class CrossLocalTransLayer(nn.Module):
    """Local kNN-attention cross layer: each query attends over its
    2 nsample nearest points of the other cloud (the kNN kernel takes k up
    to 64), value [dxyz, neighbour feats], residual add; an optional
    FlowEmbeddingLayer fusion (mlp2, over nsample neighbours)."""

    def __init__(self, nsample: int, in_channel: int, mlp: Sequence[int],
                 mlp2: Optional[Sequence[int]] = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.nsample = nsample
        self.rounds = _trans_rounds(self, in_channel, mlp, 3, generator)
        self.flow_embedding = (None if mlp2 is None else FlowEmbeddingLayer(
            nsample, in_channel, mlp2, generator))

    def _attend(self, xyz_q, xyz_r, q_qk, r_qk, r_feat, cross_conv):
        idx = knn_point(2 * self.nsample, xyz_r, xyz_q)
        direction = group_points(xyz_r, idx) - xyz_q[:, :, None, :]
        att = torch.softmax(torch.einsum("bnkd,bnd->bnk",
                                         group_points(r_qk, idx), q_qk),
                            dim=-1)
        g_val = torch.cat([direction, group_points(r_feat, idx)], dim=-1)
        return leaky(cross_conv(torch.einsum("bnk,bnkc->bnc", att, g_val)))

    def forward(self, pc1, pc2, feat1, feat2):
        f1, f2 = feat1, feat2
        for qk, cross_conv in self.rounds:
            q1, q2 = leaky(qk(f1)), leaky(qk(f2))
            new1 = self._attend(pc1, pc2, q1, q2, f2, cross_conv) + f1
            new2 = self._attend(pc2, pc1, q2, q1, f1, cross_conv) + f2
            f1, f2 = new1, new2
        if self.flow_embedding is None:
            return f1, f2
        return f1, f2, self.flow_embedding(pc1, pc2, f1, f2)


# computationally identical to the concat CrossLayer: an alias
CrossPoolLayer = CrossLayerConcat


class CrossLayerPoolLight(nn.Module):
    """Multi-round additive-PE cross: each mlp1 round re-projects both
    clouds (t1, t2, pos shared by the two directions) and max-pools both
    ways; each mlp2 round one fusion direction."""

    def __init__(self, nsample: int, in_channel: int, mlp1: Sequence[int],
                 mlp2: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.nsample = nsample
        layers, width = [], in_channel
        for ch in mlp1:
            layers += [Dense(width, ch, g), Dense(width, ch, g),
                       Dense(3, ch, g)]
            width = ch
        final, f2_width = width, width
        for ch in mlp2:
            layers += [Dense(final, ch, g), Dense(f2_width, ch, g),
                       Dense(3, ch, g)]
            final = ch
        layers = _indexed(self, "dense", layers)
        triples = list(zip(layers[0::3], layers[1::3], layers[2::3]))
        self.rounds1, self.rounds2 = triples[:len(mlp1)], triples[len(mlp1):]

    def forward(self, pc1, pc2, feat1, feat2):
        f1, f2 = feat1, feat2
        for t1, t2, pos in self.rounds1:
            new1 = _light_pool(self.nsample, pc1, pc2, t1(f1), t2(f2), pos)[0]
            new2 = _light_pool(self.nsample, pc2, pc1, t1(f2), t2(f1), pos)[0]
            f1, f2 = new1, new2
        final = f1
        for t1, t2, pos in self.rounds2:
            final = _light_pool(self.nsample, pc1, pc2, t1(final), t2(f2),
                                pos)[0]
        return f1, f2, final


# conv type -> (neighbors, in, ch, weightnet, generator) -> (conv, out width)
_CONVS = dict(
    sep=lambda n, c, ch, w, g: (SepConv(n, c, ch, g), ch),
    bias=lambda n, c, ch, w, g: (PointConvBias(n, c, ch, w, g), ch),
    svd=lambda n, c, ch, w, g: (PointConvSVD(n, c, ch, w, g), ch),
    setconv=lambda n, c, ch, w, g: (SetAbstract(n, c, (ch,), g), ch),
    factor=lambda n, c, ch, w, g: (PointConvFactor(n, c, ch, w, g),
                                   PointConvFactor.out_channel(w)),
)


class _GenericFlowEstimator(nn.Module):
    """Template of the SceneFlowEstimator* variants: conv blocks of one
    type over [feats, cost], pointwise MLP, Dense to 3, clamp +-200,
    residual add."""

    def __init__(self, conv_type: str, feat_channel: int, cost_channel: int,
                 channels: Sequence[int] = (128, 128),
                 mlp: Sequence[int] = (128, 64), neighbors: int = 9,
                 clamp: float = 200.0, weightnet: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__()
        if conv_type not in _CONVS:
            raise ValueError(conv_type)
        g = generator
        self.clamp = clamp
        convs, width = [], feat_channel + cost_channel
        for ch in channels:
            conv, width = _CONVS[conv_type](neighbors, width, ch, weightnet,
                                            g)
            convs.append(conv)
        self.convs = nn.ModuleList(convs)
        self.mlp = MLP(width, mlp, g)
        self.dense = Dense(mlp[-1], 3, g)

    def forward(self, xyz, feats, cost_volume, flow=None):
        x = torch.cat([feats, cost_volume], dim=-1)
        for conv in self.convs:
            x = conv(xyz, x)
        x = self.mlp(x)
        flow_local = torch.clamp(self.dense(x), -self.clamp, self.clamp)
        return x, flow_local if flow is None else flow_local + flow


def SceneFlowEstimatorSepResidual(feat_channel, cost_channel, **kw):
    """pointconv_util.py SceneFlowEstimatorSepResidual."""
    return _GenericFlowEstimator("sep", feat_channel, cost_channel, **kw)


def SceneFlowEstimatorResidualBias(feat_channel, cost_channel, **kw):
    """pointconv_util.py SceneFlowEstimatorResidualBias."""
    return _GenericFlowEstimator("bias", feat_channel, cost_channel, **kw)


def SceneFlowEstimatorResidualSVD(feat_channel, cost_channel, **kw):
    """pointconv_util.py SceneFlowEstimatorResidualSVD."""
    return _GenericFlowEstimator("svd", feat_channel, cost_channel, **kw)


def SceneFlowEstimatorSetconvResidual(feat_channel, cost_channel, **kw):
    """pointconv_util.py SceneFlowEstimatorSetconvResidual."""
    return _GenericFlowEstimator("setconv", feat_channel, cost_channel, **kw)


def SceneFlowEstimatorResidualFactor(feat_channel, cost_channel, **kw):
    """pointconv_util.py SceneFlowEstimatorResidualFactor."""
    return _GenericFlowEstimator("factor", feat_channel, cost_channel, **kw)


def _fixed_bn(conv: PointConv, train: bool) -> PointConv:
    """conv with its BatchNorm held in train (batch statistics) or eval
    (running statistics) mode."""
    bn = conv.bn
    conv.bn = FixedModeBatchNorm(bn.num_features, train, eps=bn.eps,
                                 momentum=bn.momentum)
    return conv


class SceneFlowEstimatorResidualSmooth(nn.Module):
    """One 16-NN PointConv over [feats, bid, cost], a wider MLP, an
    unclamped residual. Its PointConv's BatchNorm normalises with the
    batch's statistics (and moves the running ones) in eval too, as the
    JAX package calls it with train=True."""

    def __init__(self, feat_channel: int, bid_channel: int,
                 cost_channel: int, channels: Sequence[int] = (128,),
                 mlp: Sequence[int] = (256, 128), neighbors: int = 16,
                 weightnet: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        widths = [feat_channel + bid_channel + cost_channel, *channels]
        self.convs = nn.ModuleList(
            _fixed_bn(PointConv(neighbors, a, b, weightnet, True, g), True)
            for a, b in zip(widths, widths[1:]))
        self.mlp = MLP(widths[-1], mlp, g)
        self.dense = Dense(mlp[-1], 3, g)

    def forward(self, xyz, feats, bid_feats, cost_volume, flow=None):
        x = torch.cat([feats, bid_feats, cost_volume], dim=-1)
        for conv in self.convs:
            x = conv(xyz, x)
        x = self.mlp(x)
        flow_local = self.dense(x)
        return x, flow_local if flow is None else flow_local + flow


class PointConvW(nn.Module):
    """Gated-attention downsampling conv: a kernel Dense over the grouped
    neighbourhood, its channel and point means fused into sigmoid gates,
    gated mean over the neighbourhood. Returns (new_xyz, features,
    fps_idx)."""

    def __init__(self, npoint: int, nsample: int, in_channel: int,
                 out_channel: int, generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.npoint = npoint
        self.nsample = nsample
        self.out_channel = out_channel
        self.dense = Dense(3 + in_channel, out_channel, g, use_bias=False)
        self.dense1 = Dense(out_channel + nsample, out_channel + nsample, g,
                            use_bias=False)
        self.dense2 = Dense(nsample, nsample, g, use_bias=False)
        self.dense3 = Dense(out_channel, out_channel, g, use_bias=False)

    def forward(self, xyz, feats):
        new_xyz, fps_idx = _fps(xyz, self.npoint)
        grouped, _ = group_knn(self.nsample, xyz, new_xyz, feats)
        h = leaky(self.dense(grouped))                     # (B, S, K, C)
        agg = leaky(self.dense1(torch.cat([h.mean(2), h.mean(3)], dim=-1)))
        w_point = torch.sigmoid(self.dense2(agg[..., self.out_channel:]))
        w_channel = torch.sigmoid(self.dense3(agg[..., :self.out_channel]))
        h = h * w_channel[:, :, None, :] * w_point[..., None]
        return new_xyz, h.mean(2), fps_idx


class _LightRounds(nn.Module):
    """The vote / occ / p2p / shift family's first round: cross_t11 /
    cross_t22 projections, pos1 and mlp1 shared by both directions; the
    second round's cross_t1 / cross_t2, pos2 and mlp2 where mlp2 is given.
    pos_in: the positional encoding's input width (3, or 10 for the
    attentive layer); t2_in: cross_t2's input width where it is not
    mlp1[-1]."""

    def __init__(self, nsample: int, in_channel: int, mlp1: Sequence[int],
                 mlp2: Optional[Sequence[int]],
                 generator: torch.Generator | None, pos_in: int = 3,
                 t1_in: Optional[int] = None, t2_in: Optional[int] = None):
        super().__init__()
        g = generator
        self.nsample = nsample
        self.cross_t11 = Dense(in_channel, mlp1[0], g)
        self.cross_t22 = Dense(in_channel, mlp1[0], g)
        self.pos1 = Dense(pos_in, mlp1[0], g)
        self.mlp1 = MLP(mlp1[0], mlp1[1:], g)
        if mlp2 is not None:
            width = mlp1[-1]
            self.cross_t1 = Dense(width if t1_in is None else t1_in,
                                  mlp2[0], g)
            self.cross_t2 = Dense(width if t2_in is None else t2_in,
                                  mlp2[0], g)
            self.pos2 = Dense(pos_in, mlp2[0], g)
            self.mlp2 = MLP(mlp2[0], mlp2[1:], g)


class CrossLayerLightVoteDouble(_LightRounds):
    """Vote cross layer whose final round can query a dense second cloud:
    cloud 2's round-1 features are upsampled (3-NN IDW) onto the dense
    cloud beside its own features, projected by cross_t2, and pooled
    against. dense_channel: the dense cloud's feature width, or None for
    the sparse-only final round. Returns (f1p, f2p, final)."""

    def __init__(self, nsample: int, in_channel: int, mlp1: Sequence[int],
                 mlp2: Sequence[int], dense_channel: Optional[int] = None,
                 generator: torch.Generator | None = None):
        super().__init__(nsample, in_channel, mlp1, mlp2, generator,
                         t2_in=None if dense_channel is None
                         else dense_channel + mlp1[-1])
        self.dense_input = dense_channel is not None

    def forward(self, pc1, pc2, feat1, feat2, pc2_dense=None,
                feat2_dense=None):
        if (pc2_dense is not None) != self.dense_input:
            raise ValueError("built for dense_channel="
                             f"{self.dense_input}; pc2_dense given: "
                             f"{pc2_dense is not None}")
        n = self.nsample
        f1 = _light_pool(n, pc1, pc2, self.cross_t11(feat1),
                         self.cross_t22(feat2), self.pos1, self.mlp1)[0]
        f2 = _light_pool(n, pc2, pc1, self.cross_t11(feat2),
                         self.cross_t22(feat1), self.pos1, self.mlp1)[0]
        f1p = self.cross_t1(f1)
        if pc2_dense is not None:
            f2p = self.cross_t2(torch.cat(
                [feat2_dense, upsample_idw(pc2_dense, pc2, f2)], dim=-1))
            final = _light_pool(n, pc1, pc2_dense, f1p, f2p, self.pos2,
                                self.mlp2)[0]
        else:
            f2p = self.cross_t2(f2)
            final = _light_pool(n, pc1, pc2, f1p, f2p, self.pos2,
                                self.mlp2)[0]
        return f1p, f2p, final


class CrossLayerLightVote1(_LightRounds):
    """Vote variant 1: a soft-argmax vote flow from the first round's
    direction-1 cost tensor (softmax of Dense(1) over the neighbours,
    weighted neighbour positions minus the query), appended to the final
    pooled features."""

    def __init__(self, nsample: int, in_channel: int, mlp1: Sequence[int],
                 mlp2: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__(nsample, in_channel, mlp1, mlp2, generator)
        self.vote = Dense(mlp1[-1], 1, generator)

    def forward(self, pc1, pc2, feat1, feat2):
        n = self.nsample
        f1, h, neighbor_xyz = _light_pool(n, pc1, pc2, self.cross_t11(feat1),
                                          self.cross_t22(feat2), self.pos1,
                                          self.mlp1)
        w = torch.softmax(self.vote(h), dim=2)
        flow = (w * neighbor_xyz).sum(2) - pc1
        f2 = _light_pool(n, pc2, pc1, self.cross_t11(feat2),
                         self.cross_t22(feat1), self.pos1, self.mlp1)[0]
        f1 = self.cross_t1(f1)
        f2 = self.cross_t2(f2)
        final = _light_pool(n, pc1, pc2, f1, f2, self.pos2, self.mlp2)[0]
        return f1, f2, torch.cat([final, flow], dim=-1)


class CrossLayerLightVote2(_LightRounds):
    """Vote variant 2: the final round's pre-pool tensor beside the
    neighbour positions feeds a 3-channel vote Dense, whose mean over the
    neighbours minus the query is the vote flow, appended to the pooled
    features."""

    def __init__(self, nsample: int, in_channel: int, mlp1: Sequence[int],
                 mlp2: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__(nsample, in_channel, mlp1, mlp2, generator)
        self.vote = Dense(mlp2[-1] + 3, 3, generator)

    def forward(self, pc1, pc2, feat1, feat2):
        n = self.nsample
        f1 = _light_pool(n, pc1, pc2, self.cross_t11(feat1),
                         self.cross_t22(feat2), self.pos1, self.mlp1)[0]
        f2 = _light_pool(n, pc2, pc1, self.cross_t11(feat2),
                         self.cross_t22(feat1), self.pos1, self.mlp1)[0]
        f1 = self.cross_t1(f1)
        f2 = self.cross_t2(f2)
        pooled, h, neighbor_xyz = _light_pool(n, pc1, pc2, f1, f2, self.pos2,
                                              self.mlp2)
        flow = self.vote(torch.cat([h, neighbor_xyz], dim=-1)).mean(2) - pc1
        return f1, f2, torch.cat([pooled, flow], dim=-1)


def _fuse_layers(module, in_channel, mlp, mlp2, g):
    """SetAbstractFuse's layers: pre (the first layer, no bias, over
    [xyz, feats]), dense .. over mlp[1:] then mlp2 (no bias), att."""
    module.pre = Dense(3 + in_channel, mlp[0], g, use_bias=False)
    chain1 = _dense_chain(mlp[0], mlp[1:], g, use_bias=False)
    chain2 = _dense_chain(mlp[-1], mlp2, g, use_bias=False)
    layers = _indexed(module, "dense", chain1 + chain2)
    module.att = Dense(mlp[-1], 1, g, use_bias=False)
    return layers[:len(chain1)], layers[len(chain1):]


def _fuse(module, xyz, feats, query_xyz, idx):
    """The fused abstraction around query_xyz over neighbours idx: the
    features projected by pre's feature rows before the gather, the
    relative coordinates by its xyz rows after; max plus softmax-attention
    pooling; the mlp2 layers."""
    first = module.pre
    pre = first(torch.cat([torch.zeros_like(xyz), feats], dim=-1))
    rel = group_points(xyz, idx) - query_xyz[:, :, None, :]
    h = group_points(pre, idx) + first(torch.cat(
        [rel, rel.new_zeros(*rel.shape[:-1], feats.shape[-1])], dim=-1))
    h = leaky(h)
    for layer in module.layers1:
        h = leaky(layer(h))
    att = torch.softmax(module.att(h), dim=2)
    out = h.amax(dim=2) + (att * h).sum(2)
    for layer in module.layers2:
        out = leaky(layer(out))
    return out


class SetAbstractFuse(nn.Module):
    """Fused set abstraction: the first MLP layer applied to the features
    before grouping (the relative coordinates through the same layer's xyz
    rows), the neighbourhood pooled by a softmax attention plus a max, then
    mlp2."""

    def __init__(self, nsample: int, in_channel: int, mlp: Sequence[int],
                 mlp2: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        self.nsample = nsample
        self.layers1, self.layers2 = _fuse_layers(self, in_channel, mlp, mlp2,
                                                  generator)

    @staticmethod
    def out_channel(mlp: Sequence[int], mlp2: Sequence[int]) -> int:
        return mlp2[-1] if len(mlp2) else mlp[-1]

    def forward(self, xyz, feats):
        return _fuse(self, xyz, feats, xyz, knn_point(self.nsample, xyz, xyz))


class SetAbstractFuseD(nn.Module):
    """Downsampling SetAbstractFuse (FPS first). Returns (new_xyz,
    features, fps_idx)."""

    def __init__(self, npoint: int, nsample: int, in_channel: int,
                 mlp: Sequence[int], mlp2: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        self.npoint = npoint
        self.nsample = nsample
        self.layers1, self.layers2 = _fuse_layers(self, in_channel, mlp, mlp2,
                                                  generator)

    def forward(self, xyz, feats):
        new_xyz, fps_idx = _fps(xyz, self.npoint)
        idx = knn_point(self.nsample, xyz, new_xyz)
        return new_xyz, _fuse(self, xyz, feats, new_xyz, idx), fps_idx


class _WeightedDown(nn.Module):
    """FPS (of sample_xyz), kNN group of xyz around the samples, WeightNet
    contraction, Dense (C W -> widths[0] [-> widths[1]]), leaky."""

    def __init__(self, npoint: int, nsample: int, in_channel: int,
                 widths: Sequence[int], weightnet: int,
                 generator: torch.Generator | None):
        super().__init__()
        g = generator
        self.npoint = npoint
        self.nsample = nsample
        self.weightnet = WeightNet(weightnet, generator=g)
        self.layers = _indexed(self, "dense", _dense_chain(
            (3 + in_channel) * weightnet, widths, g))

    def down(self, sample_xyz, xyz, feats):
        new_xyz, fps_idx = _fps(sample_xyz, self.npoint)
        grouped, rel = group_knn(self.nsample, xyz, new_xyz, feats)
        y = weighted_contract(grouped, self.weightnet(rel))
        for layer in self.layers:
            y = layer(y)
        return new_xyz, leaky(y), fps_idx


class PointConvSVDD(_WeightedDown):
    """FPS-downsampling PointConv with the rank-factorised output linear
    (C W -> out / 2 -> out). Returns (new_xyz, features, fps_idx)."""

    def __init__(self, npoint: int, nsample: int, in_channel: int,
                 out_channel: int, weightnet: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__(npoint, nsample, in_channel,
                         (out_channel // 2, out_channel), weightnet,
                         generator)

    def forward(self, xyz, feats):
        return self.down(xyz, xyz, feats)


class PointConvWeight(_WeightedDown):
    """The reference's v2-file PointConvWeight: operation for operation
    PointConvD (one Linear). Returns (new_xyz, features, fps_idx)."""

    def __init__(self, npoint: int, nsample: int, in_channel: int,
                 out_channel: int, weightnet: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__(npoint, nsample, in_channel, (out_channel,),
                         weightnet, generator)

    def forward(self, xyz, feats):
        return self.down(xyz, xyz, feats)


class NoCrossLayer(nn.Module):
    """One-directional concat cost volume: [g1, g2, dxyz] -> Dense +
    leaky stack -> max over the neighbours. With output_clue, also the
    channel sum of the max-masked activations (a channel counts at every
    neighbour equal to its max, ties included) and the kNN indices."""

    def __init__(self, nsample: int, in_channel: int, mlp1: Sequence[int],
                 output_clue: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.nsample = nsample
        self.output_clue = output_clue
        self.layers = _indexed(self, "dense", _dense_chain(
            2 * in_channel + 3, mlp1, generator))

    def forward(self, pc1, pc2, feat1, feat2):
        idx, _, direction, g12 = _cross_group(self.nsample, pc1, pc2, feat1,
                                              feat2)
        new_points = torch.cat([g12, direction], dim=-1)
        for layer in self.layers:
            new_points = leaky(layer(new_points))
        max_points = new_points.amax(dim=2)
        if not self.output_clue:
            return max_points
        mask = (new_points == max_points[:, :, None, :]).to(torch.float32)
        return max_points, (mask * new_points).sum(-1), idx


#: The vote file's classes not rebuilt, as the JAX package lists them:
#: name -> (reference file:line, why it is not rebuilt).
OMITTED_VOTE_CLASSES = {
    "CrossLayerLightAtten": (
        "pointconv_util_vote.py:726",
        "byte-level diff vs CrossLayerLight in the same file shows zero "
        "functional delta (only the class name differs); covered by "
        "nn/cross.py CrossLayerLight"),
    "CrossAttenLayer": (
        "pointconv_util_vote.py:632",
        "global QK attention + grouped local fusion; the global-attention "
        "math is rebuilt as CrossAtten (below) and CrossTransLayer (above), "
        "the grouped-fusion round is CrossLayerConcat's"),
    "CrossLayerLightAttentive2": (
        "pointconv_util_vote.py:907",
        "CrossLayerLightAttentive with tanh instead of softmax weights and "
        "an extra residual projection — weighting-function permutation of "
        "the rebuilt CrossLayerLightAttentive"),
    "CrossLayerLightAttentive3": (
        "pointconv_util_vote.py:995",
        "hybrid: round 1 = CrossLayerLightAttentive's attentive pool, "
        "round 2 = CrossLayerLight's max pool — wiring permutation of two "
        "rebuilt classes"),
    "CrossLayerLightDouble": (
        "pointconv_util_vote.py:1194",
        "CrossLayerLight with an inline flow head + warp between rounds — "
        "a composition of SceneFlowEstimatorResidual, PointWarping and "
        "CrossLayerLight, all built; no new math"),
    "CrossLayerLightS2D": (
        "pointconv_util_vote.py:1366",
        "sparse-to-dense final round; its non-default path is broken as "
        "committed (inverted `dense_channel is not None` check :1389-1391 "
        "selects the wrong conv, torch.cat missing dim= :1441) and its "
        "default path is exactly CrossLayerLight; the working "
        "sparse-to-dense round exists as CrossLayerLightVoteDouble"),
    "CrossLayerLightInterpolate": (
        "pointconv_util_vote.py:1699",
        "round 1 queries DENSE clouds, round 2 standard — input-wiring "
        "permutation of CrossLayerLight/CrossLayerLightUp"),
    "CrossLayerLightAsym": (
        "pointconv_util_vote.py:1773",
        "CrossLayerLight with per-direction (un-shared) projections/pos "
        "encoders — parameter-sharing permutation, no new math"),
    "CrossLayerLightOccout": (
        "pointconv_util_vote.py:1853",
        "occlusion mask applied multiplicatively to the grouped tensor "
        "(forward hardwires occ=None at both call sites :1926-1927, so the "
        "mask path is dead even internally); gating representative rebuilt "
        "as CrossLayerLightOcc"),
    "CrossLayerLightOcc2": (
        "pointconv_util_vote.py:2020",
        "CrossLayerLightOcc without the gated second round (returns after "
        "the occ estimate) — subset of the rebuilt CrossLayerLightOcc"),
    "CrossLayerLightOcc3": (
        "pointconv_util_vote.py:2105",
        "CrossLayerLightOcc2 with an occ_in channel concat — arity "
        "permutation of the rebuilt CrossLayerLightOcc"),
    "CrossLayerLightOcc4": (
        "pointconv_util_vote.py:2193",
        "CrossLayerLightOcc with the occ-residual input dropped — subset "
        "of the rebuilt CrossLayerLightOcc"),
    "CrossLayerLightSym": (
        "pointconv_util_vote.py:2275",
        "identical cost-volume math to CrossLayerLight; differs only in "
        "returning the pre-projection round-1 features"),
    "CrossLayerLightSym2": (
        "pointconv_util_vote.py:2347",
        "CrossLayerLightSym plus per-cloud 1x1 lift convs before round 2 — "
        "wiring permutation"),
    "CrossLayerLight2": (
        "pointconv_util_vote.py:2423",
        "runs the second round in BOTH directions (symmetric arity "
        "permutation of CrossLayerLight)"),
    "CrossLayerLight3": (
        "pointconv_util_vote.py:2496",
        "projects cat(x, x) — a duplicated-concat (degenerate doubling) "
        "in front of CrossLayerLight2's wiring"),
    "CrossLayerLightGroup": (
        "pointconv_util_vote.py:2570",
        "CrossLayerLight with groups= on every conv (grouped-conv "
        "hyperparameter, shuffle lines commented out in the reference); "
        "no new math"),
    "CrossLayerConvLight": (
        "pointconv_util_vote.py:2647",
        "cross pooled by WeightNet-weighted sum instead of MLP+max; the "
        "weighted-sum pooling math is rebuilt in CrossLayerP2PConvLight2 "
        "(below)"),
    "CrossLayerConvLight2": (
        "pointconv_util_vote.py:2719",
        "CrossLayerLight with WeightNet as the positional encoder — "
        "encoder-swap permutation (WeightNet itself is built)"),
    "CrossLayerP2PConvLight": (
        "pointconv_util_vote.py:2795",
        "two WeightNet pools per round (patch-to-point then point-to-"
        "patch); the p2p pooling round is rebuilt in "
        "CrossLayerP2PConvLight2"),
    "SetAbstractShuffle": (
        "pointconv_util_vote.py:408",
        "set abstraction with parallel pos/feat Conv1d towers summed "
        "before grouping — a factored re-wiring of SetAbstractFuse's "
        "pre-projection trick (built above); the channel-shuffle that "
        "named it is commented out in the reference"),
    "SceneFlowEstimatorResidualShuffle": (
        "pointconv_util_vote.py:3144",
        "_GenericFlowEstimator over SetAbstractShuffle blocks — "
        "composition of accounted parts"),
    "PointConvDS_vote_duplicates": (
        "pointconv_util_vote.py:19-289,3050-3143",
        "Conv1d/Conv2d/WeightNet/PointConv/PointConvD/PointConvFlow/"
        "CrossLayer/CrossLayerLight/PointWarping/UpsampleFlow/"
        "SceneFlowEstimatorResidual in the vote file are copies of the "
        "pointconv_util.py versions already built in nn/ and ops/"),
}


class PointConvDS(_WeightedDown):
    """PointConvD whose FPS runs on a separate sampling cloud xyz_s, the
    neighbourhoods on xyz / points. Returns (new_xyz, features,
    fps_idx)."""

    def __init__(self, npoint: int, nsample: int, in_channel: int,
                 out_channel: int, weightnet: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__(npoint, nsample, in_channel, (out_channel,),
                         weightnet, generator)

    def forward(self, xyz_s, xyz, points):
        return self.down(xyz_s, xyz, points)


class AdaptiveSampling(nn.Module):
    """Among each sparse pc1 point's nsample nearest pc2 points, the one
    whose feature has the largest cosine similarity with the pc1 feature
    (the first on a tie). No parameters; (B, N1) int32 indices into
    pc2."""

    def __init__(self, nsample: int):
        super().__init__()
        self.nsample = nsample

    def forward(self, pc1_sparse, feat1_sparse, pc2_dense, feat2_dense):
        idx = knn_point(self.nsample, pc2_dense, pc1_sparse)
        g2 = group_points(feat2_dense, idx)
        q = feat1_sparse[:, :, None, :]
        sim = (g2 * q).sum(-1) / (torch.linalg.norm(g2, dim=-1)
                                  * torch.linalg.norm(q, dim=-1) + 1e-8)
        return torch.gather(idx, -1, sim.argmax(dim=-1, keepdim=True))[..., 0]


class PointConv4D(nn.Module):
    """PointConv evaluated at another cloud's positions c_xyz, without FPS:
    neighbourhoods of c_xyz in xyz, the WeightNet contraction, Dense,
    leaky."""

    def __init__(self, nsample: int, in_channel: int, out_channel: int,
                 weightnet: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.nsample = nsample
        self.weightnet = WeightNet(weightnet, generator=g)
        self.dense = Dense((3 + in_channel) * weightnet, out_channel, g)

    def forward(self, c_xyz, xyz, points):
        grouped, rel = group_knn(self.nsample, xyz, c_xyz, points)
        return leaky(self.dense(weighted_contract(grouped,
                                                  self.weightnet(rel))))


class CrossAtten(nn.Module):
    """Global bidirectional attention: a shared bias-free q/k projection,
    scaled scores over the full N1 x N2 matrix, each side the other's
    projected features under the softmax over the other cloud."""

    def __init__(self, in_channel: int, out_channel: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.scale = math.sqrt(out_channel)
        self.qk_conv = Dense(in_channel, out_channel, generator,
                             use_bias=False)

    def forward(self, pc1, pc2, feat1, feat2):
        q, k = self.qk_conv(feat1), self.qk_conv(feat2)
        attn = torch.einsum("bnc,bmc->bnm", q, k) / self.scale
        attn12 = torch.softmax(attn, dim=1)                   # over N1
        attn21 = torch.softmax(attn, dim=2)                   # over N2
        return (torch.einsum("bnm,bmc->bnc", attn21, k),
                torch.einsum("bnm,bnc->bmc", attn12, q))


class CrossLayerLightOcc(_LightRounds):
    """Occlusion-gated two-round cross: round 1 CrossLayerLight's cost
    volume; Dense(1) + sigmoid estimates each point's occlusion
    (residual on an incoming logit where given); round 2 multiplies each
    side's projected features by its mask. Returns (f1p, f2p, occ1, occ2,
    final), or (f1, f2, occ1, occ2) with mlp2 None."""

    def __init__(self, nsample: int, in_channel: int, mlp1: Sequence[int],
                 mlp2: Optional[Sequence[int]] = None,
                 generator: torch.Generator | None = None):
        super().__init__(nsample, in_channel, mlp1, mlp2, generator)
        self.occ = Dense(mlp1[-1], 1, generator)
        self.second = mlp2 is not None

    def forward(self, pc1, pc2, feat1, feat2, occ1=None, occ2=None):
        n = self.nsample
        f1 = _light_pool(n, pc1, pc2, self.cross_t11(feat1),
                         self.cross_t22(feat2), self.pos1, self.mlp1)[0]
        f2 = _light_pool(n, pc2, pc1, self.cross_t11(feat2),
                         self.cross_t22(feat1), self.pos1, self.mlp1)[0]
        o1 = self.occ(f1) if occ1 is None else self.occ(f1) + occ1
        o2 = self.occ(f2) if occ2 is None else self.occ(f2) + occ2
        o1, o2 = torch.sigmoid(o1), torch.sigmoid(o2)
        if not self.second:
            return f1, f2, o1, o2
        f1p, f2p = self.cross_t1(f1), self.cross_t2(f2)
        final = _light_pool(n, pc1, pc2, f1p * o1, f2p * o2, self.pos2,
                            self.mlp2)[0]
        return f1p, f2p, o1, o2, final


class CrossLayerLightAttentive(_LightRounds):
    """Attentive-pool cross: the positional encoding of [neighbour xyz,
    center, dxyz, |dxyz|], the MLP'd cost tensor as per-channel softmax
    weights over the neighbours, which pool the raw grouped features
    (so mlp1[-1] and mlp2[-1] equal the feature width). Returns (f1, f2)
    or (f1, f2, final)."""

    def __init__(self, nsample: int, in_channel: int, mlp1: Sequence[int],
                 mlp2: Optional[Sequence[int]] = None,
                 generator: torch.Generator | None = None):
        super().__init__(nsample, in_channel, mlp1, mlp2, generator,
                         pos_in=10, t1_in=in_channel, t2_in=in_channel)
        self.second = mlp2 is not None

    def _pool(self, xyz1, xyz2, raw1, raw2, cross1, cross2, pos, mlp):
        idx = knn_point(self.nsample, xyz2, xyz1)
        neighbor_xyz = group_points(xyz2, idx)
        direction = neighbor_xyz - xyz1[:, :, None, :]
        norm = torch.linalg.norm(direction, dim=-1, keepdim=True)
        center = xyz1[:, :, None, :].expand(neighbor_xyz.shape)
        pe = pos(torch.cat([neighbor_xyz, center, direction, norm], dim=-1))
        h = leaky(group_points(cross2(raw2), idx)
                  + cross1(raw1)[:, :, None, :] + pe)
        w = torch.softmax(mlp(h), dim=2)
        return (w * group_points(raw2, idx)).sum(2)

    def forward(self, pc1, pc2, feat1, feat2):
        f1 = self._pool(pc1, pc2, feat1, feat2, self.cross_t11,
                        self.cross_t22, self.pos1, self.mlp1)
        f2 = self._pool(pc2, pc1, feat2, feat1, self.cross_t11,
                        self.cross_t22, self.pos1, self.mlp1)
        if not self.second:
            return f1, f2
        return f1, f2, self._pool(pc1, pc2, f1, f2, self.cross_t1,
                                  self.cross_t2, self.pos2, self.mlp2)


class CrossLayerP2PConvLight2(_LightRounds):
    """A cross layer whose final round re-aggregates its max-pooled
    features by a WeightNet (p2p2) over cloud 1's self-neighbourhood
    directions, summed over the neighbours. Returns (f1p, f2p, final)."""

    def __init__(self, nsample: int, in_channel: int, mlp1: Sequence[int],
                 mlp2: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__(nsample, in_channel, mlp1, mlp2, generator)
        self.p2p2 = WeightNet(mlp2[-1], generator=generator)

    def forward(self, pc1, pc2, feat1, feat2):
        n = self.nsample
        f1 = _light_pool(n, pc1, pc2, self.cross_t11(feat1),
                         self.cross_t22(feat2), self.pos1, self.mlp1)[0]
        f2 = _light_pool(n, pc2, pc1, self.cross_t11(feat2),
                         self.cross_t22(feat1), self.pos1, self.mlp1)[0]
        f1p, f2p = self.cross_t1(f1), self.cross_t2(f2)
        pooled = _light_pool(n, pc1, pc2, f1p, f2p, self.pos2, self.mlp2)[0]
        self_idx = knn_point(n, pc1, pc1)
        self_dir = group_points(pc1, self_idx) - pc1[:, :, None, :]
        final = (self.p2p2(self_dir) * group_points(pooled, self_idx)).sum(2)
        return f1p, f2p, final


class CrossLayerLightShift(_LightRounds):
    """Shifted-position cross: round 1 also soft-argmaxes a shifted pc2
    position per pc1 point (softmax of weights1 over the neighbours,
    weighted neighbour positions); feat2 is IDW-upsampled onto the shifted
    cloud, and the later rounds query it. Returns (f1, f2) or (f1p, f2p,
    final)."""

    def __init__(self, nsample: int, in_channel: int, mlp1: Sequence[int],
                 mlp2: Optional[Sequence[int]] = None,
                 generator: torch.Generator | None = None):
        super().__init__(nsample, in_channel, mlp1, mlp2, generator)
        self.weights1 = Dense(mlp1[-1], 1, generator)
        self.second = mlp2 is not None

    def forward(self, pc1, pc2, feat1, feat2):
        n = self.nsample
        f1, h, neighbor_xyz = _light_pool(n, pc1, pc2, self.cross_t11(feat1),
                                          self.cross_t22(feat2), self.pos1,
                                          self.mlp1)
        w = torch.softmax(self.weights1(h), dim=2)
        pc2_new = (w * neighbor_xyz).sum(2)
        feat2_up = upsample_idw(pc2_new, pc2, feat2)
        f2 = _light_pool(n, pc2_new, pc1, self.cross_t11(feat2_up),
                         self.cross_t22(feat1), self.pos1, self.mlp1)[0]
        if not self.second:
            return f1, f2
        f1p, f2p = self.cross_t1(f1), self.cross_t2(f2)
        final = _light_pool(n, pc1, pc2_new, f1p, f2p, self.pos2,
                            self.mlp2)[0]
        return f1p, f2p, final


class SceneFlowEstimatorSetconvFuseResidual(nn.Module):
    """Flow head over SetAbstractFuse blocks: [feats, cost] through each
    block (mlp = channels[i], no mlp2), pointwise MLP, Dense to 3, clamp,
    residual add."""

    def __init__(self, feat_channel: int, cost_channel: int,
                 channels: Sequence[Sequence[int]] = ((128, 128),
                                                      (128, 128)),
                 mlp: Sequence[int] = (128, 64), neighbors: int = 9,
                 clamp: float = 200.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.clamp = clamp
        convs, width = [], feat_channel + cost_channel
        for ch in channels:
            convs.append(SetAbstractFuse(neighbors, width, tuple(ch), (), g))
            width = SetAbstractFuse.out_channel(ch, ())
        self.convs = nn.ModuleList(convs)
        self.mlp = MLP(width, mlp, g)
        self.dense = Dense(mlp[-1], 3, g)

    def forward(self, xyz, feats, cost_volume, flow=None):
        x = torch.cat([feats, cost_volume], dim=-1)
        for conv in self.convs:
            x = conv(xyz, x)
        x = self.mlp(x)
        flow_local = torch.clamp(self.dense(x), -self.clamp, self.clamp)
        return x, flow_local if flow is None else flow_local + flow


class SceneFlowEstimatorResidualOcc(nn.Module):
    """Residual flow head threading an occlusion channel: occ (occ_channel
    wide, 0 for none) joins the conv stack's input, fc_occ re-estimates it
    from the final features. Its PointConvs' BatchNorms use the running
    statistics in every mode, as the JAX package calls them with
    train=False. Returns (feats, flow, occ)."""

    def __init__(self, feat_channel: int, cost_channel: int,
                 occ_channel: int = 0, channels: Sequence[int] = (128, 128),
                 mlp: Sequence[int] = (128, 64), neighbors: int = 9,
                 clamp: float = 200.0, weightnet: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.clamp = clamp
        widths = [feat_channel + cost_channel + occ_channel, *channels]
        self.convs = nn.ModuleList(
            _fixed_bn(PointConv(neighbors, a, b, weightnet, True, g), False)
            for a, b in zip(widths, widths[1:]))
        self.mlp = MLP(widths[-1], mlp, g)
        self.dense = Dense(mlp[-1], 3, g)
        self.fc_occ = Dense(mlp[-1], 1, g)

    def forward(self, xyz, feats, cost_volume, flow=None, occ=None):
        parts = [feats, cost_volume] + ([occ] if occ is not None else [])
        x = torch.cat(parts, dim=-1)
        for conv in self.convs:
            x = conv(xyz, x)
        x = self.mlp(x)
        flow_local = torch.clamp(self.dense(x), -self.clamp, self.clamp)
        return (x, flow_local if flow is None else flow_local + flow,
                self.fc_occ(x))
