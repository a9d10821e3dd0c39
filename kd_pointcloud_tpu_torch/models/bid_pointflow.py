"""BidPointFlowNet, teacher wiring.

Port of kd_pointcloud_tpu/models/bid_pointflow.py for the configurations
with encoder="conv", cross="light", level_block="conv", iters=1,
fps_blocks=1, no coarse_warp and no interlevel swap: the teacher and the
presets that share its architecture. Any other configuration raises.

Topology: a Conv1d-style l0 encoder, then an FPS PointConvD pyramid l1..l4
over both clouds stacked on the batch axis (shared weights); the decoder
upsamples l4 -> l3, then per level l3..l0 warps pc2, builds the
bidirectional cost volume and runs the residual flow head, the cross-refined
features feeding the next finer level. FPS runs once per pair (levels 2-4
slice level 1's ordering, nested_fps); one 3-NN search per decoder level
serves both upsamples.

Tensors are channels-last (B, N, C). The output is the JAX package's dict:
flows (fine -> coarse), fps_idx1/2, pc1/2, feat1s/2s, crosses.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..device import resolve_device
from ..nn import (CrossLayerLight, PointConvD, PointwiseBlock,
                  SceneFlowEstimatorResidual)
from ..ops import knn_point_dist, point_warp, upsample_idw
from .config import ModelConfig

_COVERED = dict(encoder="conv", cross="light", level_block="conv", iters=1,
                fps_blocks=1, nonlinear_downsample=False, coarse_warp=(),
                swap_interlevel=False)


def check_config(cfg: ModelConfig) -> None:
    """Raise on a configuration outside the teacher wiring."""
    wrong = {k: getattr(cfg, k) for k, v in _COVERED.items()
             if getattr(cfg, k) != v}
    if wrong:
        raise NotImplementedError(
            f"config {cfg.name!r}: the port covers the teacher wiring only "
            f"({_COVERED}); unsupported here: {wrong}")


class BidPointFlowNet(nn.Module):
    """Coarse-to-fine bidirectional PointConv scene-flow network.

    Args:
      cfg: the configuration (see check_config for what is covered).
      device: where the model lives; "cuda" by default, which raises when
        no card is present. Pass device="cpu" for the plain versions.
      generator: torch.Generator for the torch-default initialisation.
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        check_config(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        g = generator
        C, L, D = cfg.level_channels, cfg.lift_channels, cfg.deconv

        self.level0 = PointwiseBlock(3, C[0], g)
        self.level0_1 = PointwiseBlock(C[0], C[0], g)
        self.level0_2 = PointwiseBlock(C[0], L[0], g)
        for lvl in range(1, 5):
            setattr(self, f"level{lvl}", PointConvD(
                cfg.npoints[lvl], cfg.feat_nei, L[lvl - 1], C[lvl],
                weightnet=cfg.weightnet[lvl], generator=g))
            if lvl < 4:
                setattr(self, f"level{lvl}_0",
                        PointwiseBlock(C[lvl], C[lvl], g))
                setattr(self, f"level{lvl}_1",
                        PointwiseBlock(C[lvl], L[lvl], g))

        self.deconv4_3 = PointwiseBlock(C[4], D[0], g)
        self.deconv3_2 = PointwiseBlock(C[3], D[1], g)
        self.deconv2_1 = PointwiseBlock(C[2], D[2], g)
        self.deconv1_0 = PointwiseBlock(C[1], D[3], g)

        head_mlp = (128, 64)        # SceneFlowEstimatorResidual's default
        for lvl in range(4):
            nei = (cfg.flow_nei_per_level[lvl]
                   if cfg.flow_nei_per_level is not None else cfg.flow_nei)
            c = C[lvl]
            setattr(self, f"cross{lvl}", CrossLayerLight(
                nei, c + D[3 - lvl], (c, c), (c, c), generator=g))
            feat_in = c if lvl == 3 else c + head_mlp[-1]
            kw = (dict(channels=cfg.flow0_channels, mlp=cfg.flow0_mlp)
                  if lvl == 0 else dict(mlp=head_mlp))
            setattr(self, f"flow{lvl}", SceneFlowEstimatorResidual(
                feat_in, c, weightnet=cfg.flow_weightnet[lvl], generator=g,
                **kw))
        self.to(device)

    def _encode(self, pc0, color):
        f0 = self.level0_1(self.level0(color))
        lift = self.level0_2(f0)
        pcs, feats, lifts, idxs = [pc0], [f0], [lift], []
        pc = pc0
        for lvl in range(1, 5):
            pc, f, idx = getattr(self, f"level{lvl}")(
                pc, lift, prefix_sample=self.cfg.nested_fps and lvl > 1)
            pcs.append(pc)
            if lvl < 4:
                f = getattr(self, f"level{lvl}_0")(f)
                lift = getattr(self, f"level{lvl}_1")(f)
                lifts.append(lift)
                idxs.append(idx)
            feats.append(f)
        return dict(pc=pcs, feat=feats, lift=lifts, idx=idxs)

    def forward(self, xyz1, xyz2, color1, color2) -> Dict[str, Any]:
        cfg = self.cfg
        B = xyz1.shape[0]
        cat = torch.cat

        # both clouds encoded stacked on the batch axis (shared weights)
        e = self._encode(cat([xyz1, xyz2]), cat([color1, color2]))
        e1 = {k: [t[:B] for t in v] for k, v in e.items()}
        e2 = {k: [t[B:] for t in v] for k, v in e.items()}
        pc1, pc2 = e1["pc"], e2["pc"]

        # l4 -> l3 skip, both clouds stacked
        f_l4_3 = self.deconv4_3(upsample_idw(e["pc"][3], e["pc"][4],
                                             e["feat"][4]))
        c_feat1 = cat([e1["feat"][3], f_l4_3[:B]], -1)
        c_feat2 = cat([e2["feat"][3], f_l4_3[B:]], -1)
        f1_new, f2_new, cross3 = self.cross3(pc1[3], pc2[3], c_feat1, c_feat2)
        feat3, flow3 = self.flow3(pc1[3], e1["feat"][3], cross3)

        flows = [None, None, None, flow3]
        crosses = [None, None, None, cross3]
        inter1, inter2 = [None] * 3, [None] * 3
        up_feat, up_flow_src = feat3, flow3
        deconvs = [self.deconv1_0, self.deconv2_1, self.deconv3_2]

        for lvl in (2, 1, 0):
            # one 3-NN per level serves both upsamples: the deconv skip
            # (both clouds stacked) and the flow + feature upsample (the
            # cloud-1 half)
            d2_up, idx_up = knn_point_dist(3, e["pc"][lvl + 1], e["pc"][lvl])
            i_both = deconvs[lvl](upsample_idw(
                e["pc"][lvl], e["pc"][lvl + 1], cat([f1_new, f2_new]),
                knn=(d2_up, idx_up)))
            inter1[lvl], inter2[lvl] = i_both[:B], i_both[B:]
            c_feat1 = cat([e1["feat"][lvl], inter1[lvl]], -1)
            c_feat2 = cat([e2["feat"][lvl], inter2[lvl]], -1)

            both_up = upsample_idw(
                pc1[lvl], pc1[lvl + 1],
                cat([cfg.scale * up_flow_src, up_feat], -1),
                knn=(d2_up[:B], idx_up[:B]))
            up_flow, feat_up = both_up[..., :3], both_up[..., 3:]

            pc2_warp = point_warp(pc1[lvl], pc2[lvl], up_flow)
            f1_new, f2_new, cross_l = getattr(self, f"cross{lvl}")(
                pc1[lvl], pc2_warp, c_feat1, c_feat2)
            feat_l, flow_l = getattr(self, f"flow{lvl}")(
                pc1[lvl], cat([e1["feat"][lvl], feat_up], -1), cross_l,
                up_flow)
            flows[lvl], crosses[lvl] = flow_l, cross_l
            up_flow_src, up_feat = flow_l, feat_l

        return dict(
            flows=flows,
            fps_idx1=e1["idx"],
            fps_idx2=e2["idx"],
            pc1=pc1[:4],
            pc2=pc2[:4],
            feat1s=e1["lift"] + [inter1[2], inter1[1], inter1[0]],
            feat2s=e2["lift"] + [inter2[2], inter2[1], inter2[0]],
            crosses=crosses,
        )
