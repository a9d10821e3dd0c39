"""The reference network "pointflownet" (the default of a model entry
without a "reference" key): Bi-PointFlowNet and its feature-grouping
family, in plain PyTorch.

Coarse-to-fine and bidirectional: both clouds are encoded stacked on the
batch axis (shared weights) through an l0 encoder and four FPS PointConv
levels (FPS once a pair: levels 2-4 take the leading rows of level 1's
FPS order); the decoder upsamples l4 -> l3 and then, at l3 and each finer
level, warps the second cloud back along the upsampled flow, builds the
cross layer's cost volume and runs the residual flow head. With iters > 1
the levels l2..l0 refine their flow that many times. cross "fg" joins each
point's feature-space neighbours (over the encoder's features, once a
level) to its 3-D ones. KD-PointCloud's models_bid_pointconv.py
(encoder "conv", cross "light") and models_bid_FG.py / models_bifeat.py
(encoder "pointconv", cross "fg").

forward returns flows (fine -> coarse; per-iteration lists at l0-l2 when
iters > 1), fps_idx1 / fps_idx2 (l1..l3), feat1s / feat2s
(reference/outputs.py).

It builds the program's ModelConfig wirings with cross light / fg, encoder
conv / pointconv, conv level blocks, one flow_nei for every level, exact
FPS over the whole cloud and nested levels, the warp at every level and
scale 1: teacher, lighttoken_res, weight48, fg and bifeat. Set-up refuses
any other model entry (NetConfig.from_dict, naming the field): another
value of a field that changes the wiring (BUILDS), or a field it does not
know.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from benchmark.reference.nn import (CrossLayer, FlowHead, PointConv,
                                    PointConvD, PointwiseBlock)
from benchmark.reference.ops import knn, point_warp, upsample_idw

# what this network builds of each field that selects a wiring: the values
# it takes (cross, encoder) or the one value it builds (the rest); a
# model entry's other value of such a field is refused
BUILDS = dict(cross=("light", "fg"), encoder=("conv", "pointconv"),
              flow_nei_per_level=(None,), level_block=("conv",),
              nonlinear_downsample=(False,), coarse_warp=((),),
              swap_interlevel=(False,), scale=(1,), nested_fps=(True,),
              fps_blocks=(1,))
# fields that choose no wiring here: the model's name, the entry's network,
# the program's search and sampling back ends (its kNN and FPS are exact),
# and bottleneck_mids, read only with level_block "bottleneck"
IGNORED = ("name", "reference", "knn_method", "knn_recall", "knn_precision",
           "fps_backend", "fg_feat_knn_method", "fg_euclid_knn_method",
           "bottleneck_mids")


@dataclasses.dataclass(frozen=True)
class NetConfig:
    npoints: Tuple[int, ...]
    level_channels: Tuple[int, ...]
    lift_channels: Tuple[int, ...]
    flow_nei: int
    feat_nei: int
    weightnet: Tuple[int, ...]
    flow_weightnet: Tuple[int, ...]
    cross: str
    encoder: str
    iters: int
    deconv: Tuple[int, ...]
    flow0_channels: Tuple[int, ...]
    flow0_mlp: Tuple[int, ...]

    @classmethod
    def from_dict(cls, d: dict) -> "NetConfig":
        """The sizes of a model entry; raises ValueError naming each field
        whose value this network does not build, or that it does not
        know."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        bad = [f"{k}={v!r} (builds {' / '.join(map(repr, BUILDS[k]))})"
               for k, v in kw.items() if k in BUILDS and v not in BUILDS[k]]
        bad += [f"{k} (unknown field)" for k in kw
                if k not in names and k not in BUILDS and k not in IGNORED]
        if bad:
            raise ValueError("reference network pointflownet does not build "
                             + "; ".join(bad))
        return cls(**{k: v for k, v in kw.items() if k in names})


def Net(cfg: dict) -> "PointFlowNet":
    """The network of a model entry (a configuration file's sizes)."""
    return PointFlowNet(NetConfig.from_dict(cfg))


class PointFlowNet(nn.Module):
    def __init__(self, cfg: NetConfig):
        super().__init__()
        self.cfg = cfg
        C, L, D = cfg.level_channels, cfg.lift_channels, cfg.deconv
        if cfg.encoder == "conv":
            self.level0 = PointwiseBlock(3, C[0])
            self.level0_1 = PointwiseBlock(C[0], C[0])
            self.level0_2 = PointwiseBlock(C[0], L[0])
        else:
            self.level0_lift = PointwiseBlock(3, C[0])
            self.level0 = PointConv(cfg.feat_nei, C[0], C[0], cfg.weightnet[0])
            self.level0_1 = PointwiseBlock(C[0], L[0])
        for lvl in range(1, 5):
            setattr(self, f"level{lvl}", PointConvD(
                cfg.npoints[lvl], cfg.feat_nei, L[lvl - 1], C[lvl],
                cfg.weightnet[lvl]))
            if lvl < 4:
                setattr(self, f"level{lvl}_0", PointwiseBlock(C[lvl], C[lvl]))
                setattr(self, f"level{lvl}_1", PointwiseBlock(C[lvl], L[lvl]))
        self.deconv4_3 = PointwiseBlock(C[4], D[0])
        self.deconv3_2 = PointwiseBlock(C[3], D[1])
        self.deconv2_1 = PointwiseBlock(C[2], D[2])
        self.deconv1_0 = PointwiseBlock(C[1], D[3])
        for lvl in range(4):
            c = C[lvl]
            setattr(self, f"cross{lvl}", CrossLayer(
                cfg.flow_nei, c + D[3 - lvl], c, fg=cfg.cross == "fg"))
            feat_in = c if lvl == 3 else c + 64
            kw = (dict(channels=cfg.flow0_channels, mlp=cfg.flow0_mlp)
                  if lvl == 0 else {})
            setattr(self, f"flow{lvl}", FlowHead(
                feat_in, c, weightnet=cfg.flow_weightnet[lvl], **kw))

    def _encode(self, pc0, color):
        if self.cfg.encoder == "conv":
            f0 = self.level0_1(self.level0(color))
            lift = self.level0_2(f0)
        else:
            f0 = self.level0(pc0, self.level0_lift(color))
            lift = self.level0_1(f0)
        pcs, feats, lifts, idxs = [pc0], [f0], [lift], []
        pc = pc0
        for lvl in range(1, 5):
            pc, f, idx = getattr(self, f"level{lvl}")(pc, lift, lvl > 1)
            pcs.append(pc)
            if lvl < 4:
                f = getattr(self, f"level{lvl}_0")(f)
                lift = getattr(self, f"level{lvl}_1")(f)
                lifts.append(lift)
                idxs.append(idx)
            feats.append(f)
        return pcs, feats, lifts, idxs

    def forward(self, xyz1, xyz2, color1, color2):
        cfg = self.cfg
        B = xyz1.shape[0]
        cat = torch.cat
        pcs, feats, lifts, idxs = self._encode(cat([xyz1, xyz2]),
                                               cat([color1, color2]))
        pc1 = [p[:B] for p in pcs]
        pc2 = [p[B:] for p in pcs]
        f1 = [f[:B] for f in feats]
        f2 = [f[B:] for f in feats]

        def feature_idx(lvl):
            if cfg.cross != "fg":
                return None
            return getattr(self, f"cross{lvl}").feature_neighbours(
                f1[lvl], f2[lvl])

        up = self.deconv4_3(upsample_idw(pcs[3], pcs[4], feats[4]))
        new1, new2, cost = self.cross3(
            pc1[3], pc2[3], cat([f1[3], up[:B]], -1), cat([f2[3], up[B:]], -1),
            feature_idx(3))
        feat, flow = self.flow3(pc1[3], f1[3], cost)
        flows = [None, None, None, flow]
        inter = [None, None, None]
        deconvs = [self.deconv1_0, self.deconv2_1, self.deconv3_2]
        for lvl in (2, 1, 0):
            nn3 = knn(3, pcs[lvl + 1], pcs[lvl])
            both = deconvs[lvl](upsample_idw(pcs[lvl], pcs[lvl + 1],
                                             cat([new1, new2]), nn3))
            inter[lvl] = both
            c1 = cat([f1[lvl], both[:B]], -1)
            c2 = cat([f2[lvl], both[B:]], -1)
            up = upsample_idw(pc1[lvl], pc1[lvl + 1], cat([flow, feat], -1),
                              (nn3[0][:B], nn3[1][:B]))
            up_flow, feat_up = up[..., :3], up[..., 3:]
            fidx = feature_idx(lvl)
            level_flows = []
            for it in range(cfg.iters):
                warped = point_warp(pc1[lvl], pc2[lvl], up_flow)
                new1, new2, cost = getattr(self, f"cross{lvl}")(
                    pc1[lvl], warped, c1, c2, fidx)
                feat, flow = getattr(self, f"flow{lvl}")(
                    pc1[lvl], cat([f1[lvl], feat_up], -1), cost, up_flow)
                level_flows.append(flow)
                up_flow, feat_up = flow, feat
                c1 = cat([f1[lvl], new1], -1)
                c2 = cat([f2[lvl], new2], -1)
            flows[lvl] = level_flows if cfg.iters > 1 else flow

        l4 = [feats[4]] if cfg.encoder == "pointconv" else []
        tail = [inter[2], inter[1], inter[0]]
        return dict(
            flows=flows,
            fps_idx1=[i[:B] for i in idxs],
            fps_idx2=[i[B:] for i in idxs],
            feat1s=[x[:B] for x in lifts + l4 + tail],
            feat2s=[x[B:] for x in lifts + l4 + tail])

