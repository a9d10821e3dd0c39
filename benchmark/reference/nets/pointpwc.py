"""The reference network "pointpwc": PointPWC-Net (Wu et al., "PointPWC-Net:
Cost Volume on Point Clouds for (Self-)Supervised Scene Flow Estimation",
ECCV 2020; https://github.com/DylanWusee/PointPWC models.py
PointConvSceneFlowPWC8192selfglobalPointConv, pointconv_util.py
PointConvFlow) in plain PyTorch, float32.

A 5-level pyramid (an l0 encoder of pointwise blocks, then FPS PointConv
levels l1..l4) over both clouds; the decoder upsamples l4 -> l3 and then,
at l3 and each finer level, warps the second cloud back along the
upsampled flow, builds the patch-to-patch cost volume and runs the flow
head. The cost volume (CostVolume, recorded as the kind "cost_volume"):
each first-cloud point's nsample nearest second-cloud points, an MLP over
[f1, f2[idx], dxyz], each channel weighted by WeightNet(dxyz) and summed
over the neighbours; then the same weighted sum over the first cloud's own
nsample nearest points. Each cloud's own encoder features go on to the
next level's deconv. The heads predict the flow itself from [feats, cost,
upsampled flow] (no flow input at l3), clamped at +-200.

forward returns the dict of reference/outputs.py: flows (fine -> coarse),
fps_idx1 / fps_idx2 (l1..l3), feat1s / feat2s (the l0-l2 lifts and the
decoder's l2-l0 skips).

Where it departs from the published code, it follows the program's wiring
(the teacher's code, models/bid_pointflow.py cross="pwc"), so that one
set of seeded weights loads strictly into both:

* the heads' two PointConvs carry BatchNorm (train mode in training),
  where PointPWC's pointconv_util.py builds them with use_bn = False;
* the features a level hands to its cost volume, head and deconv are read
  after its same-width pointwise block (levelN_0), where models.py reads
  the PointConvD output;
* FPS runs once a cloud: levels 2-4 take the leading rows of level 1's FPS
  order (the same points as FPS over level 1, up to ties); both clouds go
  through the shared weights stacked on the batch axis;
* the kNN is exact, ties toward the lower index; weights are seeded.

Set-up refuses a model entry with another value of a field that changes
the wiring (BUILDS) or a field it does not know (NetConfig.from_dict,
naming the field).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from benchmark.reference.nn import (Dense, FlowHead, PointConvD,
                                    PointwiseBlock, WeightNet)
from benchmark.reference.ops import (group_points, knn, leaky, point_warp,
                                     record, upsample_idw)

# what this network builds of each field that selects a wiring: the one
# value it builds; a model entry's other value of such a field is refused
BUILDS = dict(cross=("pwc",), encoder=("conv",), iters=(1,),
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
        bad = [f"{k}={v!r} (builds {BUILDS[k][0]!r})"
               for k, v in kw.items() if k in BUILDS and v not in BUILDS[k]]
        bad += [f"{k} (unknown field)" for k in kw
                if k not in names and k not in BUILDS and k not in IGNORED]
        if bad:
            raise ValueError("reference network pointpwc does not build "
                             + "; ".join(bad))
        return cls(**{k: v for k, v in kw.items() if k in names})


def Net(cfg: dict) -> "PointPWCNet":
    """The network of a model entry (a configuration file's sizes)."""
    return PointPWCNet(NetConfig.from_dict(cfg))


class CostVolume(nn.Module):
    """PointConvFlow(nsample, 2 fan_in + 3, [width, width]): fan_in is each
    cloud's feature width. Parameter names are the program's."""

    def __init__(self, nsample: int, fan_in: int, width: int):
        super().__init__()
        self.nsample, self.width = nsample, width
        self.dense = Dense(2 * fan_in + 3, width)
        self.dense1 = Dense(width, width)
        self.weightnet1 = WeightNet(width)
        self.weightnet2 = WeightNet(width)

    def forward(self, xyz1, xyz2, f1, f2):
        B, N1, D = f1.shape
        K = self.nsample
        record("cost_volume", (B, N1, xyz2.shape[1], K, D, self.width))
        idx = knn(K, xyz2, xyz1)[1]
        rel = group_points(xyz2, idx) - xyz1[:, :, None, :]
        grouped = torch.cat([f1[:, :, None, :].expand(B, N1, K, D),
                             group_points(f2, idx), rel], dim=-1)
        h = leaky(self.dense1(leaky(self.dense(grouped))))
        point_to_patch = (self.weightnet1(rel) * h).sum(2)
        idx = knn(K, xyz1, xyz1)[1]
        rel = group_points(xyz1, idx) - xyz1[:, :, None, :]
        return (self.weightnet2(rel)
                * group_points(point_to_patch, idx)).sum(2)


class PointPWCNet(nn.Module):
    def __init__(self, cfg: NetConfig):
        super().__init__()
        self.cfg = cfg
        C, L, D = cfg.level_channels, cfg.lift_channels, cfg.deconv
        self.level0 = PointwiseBlock(3, C[0])
        self.level0_1 = PointwiseBlock(C[0], C[0])
        self.level0_2 = PointwiseBlock(C[0], L[0])
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
            setattr(self, f"cross{lvl}",
                    CostVolume(cfg.flow_nei, c + D[3 - lvl], c))
            # the feature input: the level's own features and, below l3,
            # the coarser head's 64-wide output upsampled; the cost input:
            # the cost and, below l3, the upsampled flow
            feat_in, cost_in = (c, c) if lvl == 3 else (c + 64, c + 3)
            kw = (dict(channels=cfg.flow0_channels, mlp=cfg.flow0_mlp)
                  if lvl == 0 else {})
            setattr(self, f"flow{lvl}", FlowHead(
                feat_in, cost_in, weightnet=cfg.flow_weightnet[lvl], **kw))

    def _encode(self, pc0, color):
        f0 = self.level0_1(self.level0(color))
        lift = self.level0_2(f0)
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
        B = xyz1.shape[0]
        cat = torch.cat
        pcs, feats, lifts, idxs = self._encode(cat([xyz1, xyz2]),
                                               cat([color1, color2]))
        pc1 = [p[:B] for p in pcs]
        pc2 = [p[B:] for p in pcs]
        f1 = [f[:B] for f in feats]
        f2 = [f[B:] for f in feats]

        up = self.deconv4_3(upsample_idw(pcs[3], pcs[4], feats[4]))
        cost = self.cross3(pc1[3], pc2[3], cat([f1[3], up[:B]], -1),
                           cat([f2[3], up[B:]], -1))
        feat, flow = self.flow3(pc1[3], f1[3], cost)
        flows = [None, None, None, flow]
        inter = [None, None, None]
        deconvs = [self.deconv1_0, self.deconv2_1, self.deconv3_2]
        for lvl in (2, 1, 0):
            nn3 = knn(3, pcs[lvl + 1], pcs[lvl])
            both = deconvs[lvl](upsample_idw(pcs[lvl], pcs[lvl + 1],
                                             feats[lvl + 1], nn3))
            inter[lvl] = both
            up = upsample_idw(pc1[lvl], pc1[lvl + 1], cat([flow, feat], -1),
                              (nn3[0][:B], nn3[1][:B]))
            up_flow, feat_up = up[..., :3], up[..., 3:]
            warped = point_warp(pc1[lvl], pc2[lvl], up_flow)
            cost = getattr(self, f"cross{lvl}")(
                pc1[lvl], warped, cat([f1[lvl], both[:B]], -1),
                cat([f2[lvl], both[B:]], -1))
            feat, flow = getattr(self, f"flow{lvl}")(
                pc1[lvl], cat([f1[lvl], feat_up], -1),
                cat([cost, up_flow], -1))
            flows[lvl] = flow

        tail = [inter[2], inter[1], inter[0]]
        return dict(
            flows=flows,
            fps_idx1=[i[:B] for i in idxs],
            fps_idx2=[i[B:] for i in idxs],
            feat1s=[x[:B] for x in lifts + tail],
            feat2s=[x[B:] for x in lifts + tail])
