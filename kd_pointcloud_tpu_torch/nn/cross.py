"""Bidirectional cross / cost-volume layers.

Port of kd_pointcloud_tpu/nn/cross.py: CrossLayerLight (production path),
CrossLayerLightFG (feature-grouping neighbours), NoCrossLayerLight (the
one-directional ablation) and CrossLayerLightVote (a soft-argmax vote
flow on the final round). CrossLayerLight, per direction: project
both feature sets (cross_t11 / cross_t22), take each cloud-1 point's K
nearest cloud-2 points, pool max_k mlp(leaky(g2 + g1 + pos(dxyz))). pos is
linear, so the grouped pre-activation factors into a per-key table
u = g2 + pos(xyz2) and a per-query term v = g1 - pos(xyz1) + pos(0): the
pool is u[idx] + v, which ops/pool_fused.py computes with the gather fused
into the kernel. One kNN per direction serves both rounds, and both
directions ride one search. The TPU's merged-gather schedule and lane
packing are layout devices and are not ported; the math and the order of
the rounds are.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import group_points, knn_features, knn_point, leaky, pool_mlp_max
from .blocks import MLP, Dense


def bid_knn(nsample: int, pc1: torch.Tensor, pc2: torch.Tensor,
            search=knn_point):
    """Both directions' kNN (pc1 in pc2, pc2 in pc1); one search over the
    batch-stacked clouds when they have equal size. search: knn_point (3-D
    points, the kernel) or knn_features (feature space)."""
    if pc1.shape == pc2.shape:
        B = pc1.shape[0]
        idx = search(nsample, torch.cat([pc2, pc1]), torch.cat([pc1, pc2]))
        return idx[:B], idx[B:]
    return search(nsample, pc2, pc1), search(nsample, pc1, pc2)


def cross_pool(xyz1, xyz2, points1, points2, pos: Dense, mlp: MLP,
               knn_idx: torch.Tensor) -> torch.Tensor:
    """One cost-volume direction: (B, N1, D) pooled over each cloud-1
    point's neighbours knn_idx (B, N1, K) in cloud 2."""
    u = points2 + pos(xyz2)
    v = points1 - pos(xyz1) + pos(torch.zeros_like(xyz1[:, :1, :]))
    layer = mlp.layers[0].dense
    return pool_mlp_max(u, knn_idx, v, layer.weight, layer.bias)


class CrossLayerLight(nn.Module):
    """Two-round bidirectional cost volume.

    forward(pc1, pc2, feat1, feat2) -> (feat1_new, feat2_new, feat1_final),
    cross_t1 / cross_t2 applied to the returned feat*_new."""

    def __init__(self, nsample: int, in_channel: int, mlp1: Sequence[int],
                 mlp2: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        if len(mlp1) != 2 or len(mlp2) != 2:
            raise ValueError("the fused pool takes a single-layer MLP: "
                             f"mlp1={tuple(mlp1)}, mlp2={tuple(mlp2)}")
        g = generator
        self.nsample = nsample
        self.cross_t11 = Dense(in_channel, mlp1[0], g)
        self.cross_t22 = Dense(in_channel, mlp1[0], g)
        self.pos1 = Dense(3, mlp1[0], g)
        self.mlp1 = MLP(mlp1[0], mlp1[1:], g)
        self.cross_t1 = Dense(mlp1[-1], mlp2[0], g)
        self.cross_t2 = Dense(mlp1[-1], mlp2[0], g)
        self.pos2 = Dense(3, mlp2[0], g)
        self.mlp2 = MLP(mlp2[0], mlp2[1:], g)

    def forward(self, pc1, pc2, feat1, feat2):
        return self.rounds(pc1, pc2, feat1, feat2,
                           *bid_knn(self.nsample, pc1, pc2))

    def rounds(self, pc1, pc2, feat1, feat2, idx12, idx21):
        """The two rounds over given neighbours: idx12 (B, N1, K) of each
        cloud-1 point in cloud 2, idx21 the other way."""
        feat1_new, feat2_new = self.first_round(pc1, pc2, feat1, feat2,
                                                idx12, idx21)
        feat1_final = cross_pool(pc1, pc2, feat1_new, feat2_new, self.pos2,
                                 self.mlp2, idx12)
        return feat1_new, feat2_new, feat1_final

    def first_round(self, pc1, pc2, feat1, feat2, idx12, idx21):
        """Round 1, both directions, then cross_t1 / cross_t2."""
        feat2_new = cross_pool(pc2, pc1, self.cross_t11(feat2),
                               self.cross_t22(feat1), self.pos1, self.mlp1,
                               idx21)
        feat1_new = cross_pool(pc1, pc2, self.cross_t11(feat1),
                               self.cross_t22(feat2), self.pos1, self.mlp1,
                               idx12)
        return self.cross_t1(feat1_new), self.cross_t2(feat2_new)


class CrossLayerLightFG(CrossLayerLight):
    """Feature-grouping cross layer: a point's neighbours are the union of
    its nsample / 2 nearest in feature space (over the base features
    fgfeat*) and its nsample / 2 nearest in 3-D, feature half first, in
    both directions; then CrossLayerLight's rounds over the union (K =
    nsample, one pool kernel launch a pool). The union can hold a point
    twice; the max ignores that.

    forward(pc1, pc2, feat1, feat2, fgfeat1, fgfeat2, feat_idx=None) ->
    (feat1_new, feat2_new, feat1_final). The feature half depends on the
    base features alone, so an iterative model computes it once a level
    (feature_knn) and passes it as feat_idx."""

    def feature_knn(self, fgfeat1, fgfeat2):
        """(idx12, idx21) of the feature half (knn_features: the feature
        kNN kernel on the card)."""
        return bid_knn(self.nsample // 2, fgfeat1, fgfeat2, knn_features)

    def forward(self, pc1, pc2, feat1, feat2, fgfeat1, fgfeat2,
                feat_idx=None):
        f12, f21 = feat_idx or self.feature_knn(fgfeat1, fgfeat2)
        e12, e21 = bid_knn(self.nsample // 2, pc1, pc2)
        return self.rounds(pc1, pc2, feat1, feat2, torch.cat([f12, e12], -1),
                           torch.cat([f21, e21], -1))


class NoCrossLayerLight(nn.Module):
    """One-directional ablation: one position-encoded pool of cloud 2
    around cloud 1, returning one tensor. BatchNorm-free, as the JAX
    package documents (the reference turns it on by a stray positional
    argument, models_bid_no_cross.py:26)."""

    def __init__(self, nsample: int, in_channel: int, mlp1: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        if len(mlp1) != 2:
            raise ValueError("the fused pool takes a single-layer MLP: "
                             f"mlp1={tuple(mlp1)}")
        g = generator
        self.nsample = nsample
        self.cross_t1 = Dense(in_channel, mlp1[0], g)
        self.cross_t2 = Dense(in_channel, mlp1[0], g)
        self.pos = Dense(3, mlp1[0], g)
        self.mlp = MLP(mlp1[0], mlp1[1:], g)

    def forward(self, pc1, pc2, feat1, feat2):
        return cross_pool(pc1, pc2, self.cross_t1(feat1),
                          self.cross_t2(feat2), self.pos, self.mlp,
                          knn_point(self.nsample, pc2, pc1))


class CrossLayerLightVote(CrossLayerLight):
    """CrossLayerLight with a soft-argmax vote on the final round: the
    round's pre-pool tensor (B, N1, K, C) is formed in full (plain
    PyTorch, as the JAX package's XLA), max-pooled, and a 1-channel Dense
    on it, softmaxed over K, weighs the neighbours' positions; their
    expectation minus the query is appended (C + 3 channels). The first
    round's two pools go through the pool kernel."""

    def __init__(self, nsample: int, in_channel: int, mlp1: Sequence[int],
                 mlp2: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__(nsample, in_channel, mlp1, mlp2, generator)
        self.vote = Dense(mlp2[-1], 1, generator)

    def forward(self, pc1, pc2, feat1, feat2):
        idx12, idx21 = bid_knn(self.nsample, pc1, pc2)
        feat1_new, feat2_new = self.first_round(pc1, pc2, feat1, feat2,
                                                idx12, idx21)
        neighbor_xyz = group_points(pc2, idx12)              # (B, N1, K, 3)
        pre_pool = self.mlp2(leaky(
            group_points(feat2_new, idx12) + feat1_new[:, :, None, :]
            + self.pos2(neighbor_xyz - pc1[:, :, None, :])))
        vote = torch.softmax(self.vote(pre_pool), dim=2)    # (B, N1, K, 1)
        flow = (vote * neighbor_xyz).sum(2) - pc1
        return feat1_new, feat2_new, torch.cat([pre_pool.amax(2), flow], -1)
