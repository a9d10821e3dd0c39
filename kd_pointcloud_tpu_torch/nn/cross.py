"""Bidirectional cross / cost-volume layer (production path).

Port of kd_pointcloud_tpu/nn/cross.py CrossLayerLight. Per direction: project
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

from ..ops import knn_point, pool_mlp_max
from .blocks import MLP, Dense


def bid_knn(nsample: int, pc1: torch.Tensor, pc2: torch.Tensor):
    """Both directions' kNN (pc1 in pc2, pc2 in pc1); one search over the
    batch-stacked clouds when they have equal size."""
    if pc1.shape == pc2.shape:
        B = pc1.shape[0]
        idx = knn_point(nsample, torch.cat([pc2, pc1]), torch.cat([pc1, pc2]))
        return idx[:B], idx[B:]
    return knn_point(nsample, pc2, pc1), knn_point(nsample, pc1, pc2)


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
        idx12, idx21 = bid_knn(self.nsample, pc1, pc2)
        feat2_new = cross_pool(pc2, pc1, self.cross_t11(feat2),
                               self.cross_t22(feat1), self.pos1, self.mlp1,
                               idx21)
        feat1_new = cross_pool(pc1, pc2, self.cross_t11(feat1),
                               self.cross_t22(feat2), self.pos1, self.mlp1,
                               idx12)
        feat1_new = self.cross_t1(feat1_new)
        feat2_new = self.cross_t2(feat2_new)
        feat1_final = cross_pool(pc1, pc2, feat1_new, feat2_new, self.pos2,
                                 self.mlp2, idx12)
        return feat1_new, feat2_new, feat1_final
