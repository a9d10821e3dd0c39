"""BidPointFlowNet, the whole model family of the JAX package, and
PointPWC-Net (preset pointpwc, cross="pwc"), which the port alone builds.

Port of kd_pointcloud_tpu/models/bid_pointflow.py for every preset: the
conv encoder with light cross layers (the teacher and the presets sharing
its architecture, serving_v3's coarse warp, the bottleneck students
student, student2 and non_linear), the feature-grouping family (fg, and
bifeat with two refinement iterations a level), no_cross and vote, and
fps_blocks > 1, the blocked-FPS relaxation (ops/fps.py
furthest_point_sample_blocked): under nested_fps it changes l1's FPS only,
and with nested_fps=False every level's.

Topology: an l0 encoder (Conv1d-style blocks, or for encoder="pointconv" a
lift then a same-resolution PointConv), then an FPS PointConvD pyramid
l1..l4 over both clouds stacked on the batch axis (shared weights); the
decoder upsamples l4 -> l3, then per level l3..l0 warps pc2, builds the
cost volume and runs the residual flow head, the cross-refined features
feeding the next finer level. cross="pwc" is PointPWC-Net (Wu et al., ECCV
2020) on the same encoder, decoder and warp: each level's cost volume is
PointConvFlow (nn/experimental.py, the patch-to-patch cost volume), the
base features go on to the next level, and the heads are
SceneFlowEstimatorPointConv, which predict the flow itself (clamped at
+-200) from [feats, cost, upsampled flow] (no flow input at l3). FPS runs
once per pair (levels 2-4 slice level 1's ordering, nested_fps); one 3-NN
search per decoder level serves both upsamples. level_block="bottleneck"
swaps the same-width level blocks for BottleNeck; nonlinear_downsample
swaps l3 and l4's PointConvD for PointConvNonLinear; a level in
coarse_warp warps pc2 (in its first iteration) with an inverse flow built
one level coarser and upsampled along the decoder's 3-NN. With iters > 1,
levels l2..l0 refine: each iteration warps with the last flow and feeds
the cross layer the base features beside the last cross output (c_feat*).
cross="fg" adds the base features' feature-space neighbours (computed once
a level); swap_interlevel feeds each cloud the other's upsampled features.

Tensors are channels-last (B, N, C). The output is the JAX package's dict:
flows (fine -> coarse; at iters > 1 the l0-l2 entries are per-iteration
lists), fps_idx1/2, pc1/2, feat1s/2s (8 entries with feat_l4 at index 4
for encoder="pointconv"), crosses, and for encoder="pointconv" c_feat1s/2s
(the cross layers' inputs at l0-l2, per-iteration lists at iters > 1).

The forward opens the spans model.encode (the encoder and pyramid),
model.cross (each cross layer, and the FG layer's feature half; under
it, cross="pwc"'s model.cost_volume),
model.flow_head (each flow head) and model.upsample (each level's deconv
skip and upsample); they are on only while a profiler records
(perf/trace.py).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..device import resolve_device
from ..nn import (BottleNeck, CrossLayerLight, CrossLayerLightFG,
                  CrossLayerLightVote, NoCrossLayerLight, PointConv,
                  PointConvD, PointConvNonLinear, PointwiseBlock,
                  SceneFlowEstimatorPointConv, SceneFlowEstimatorResidual)
from ..nn.experimental import PointConvFlow
from ..ops import knn_point_dist, point_warp, upsample_idw
from ..perf.trace import annotate
from .config import ModelConfig

_ENCODERS = ("conv", "pointconv")
_CROSSES = ("light", "fg", "nocross", "vote", "pwc")
_LEVEL_BLOCKS = ("conv", "bottleneck")
_COARSE_WARP_LEVELS = (0, 1, 2)


def check_config(cfg: ModelConfig) -> None:
    """Raise on a configuration outside the wiring the port covers."""
    wrong = {}
    for field, allowed in (("encoder", _ENCODERS), ("cross", _CROSSES),
                           ("level_block", _LEVEL_BLOCKS)):
        if getattr(cfg, field) not in allowed:
            wrong[field] = getattr(cfg, field)
    for field in ("iters", "fps_blocks"):
        if getattr(cfg, field) < 1:
            wrong[field] = getattr(cfg, field)
    if not set(cfg.coarse_warp) <= set(_COARSE_WARP_LEVELS):
        wrong["coarse_warp"] = cfg.coarse_warp
    if cfg.cross == "pwc":
        # the pwc wiring passes the base features on, so it has no
        # cross-refined features to iterate on or swap, and no c_feats
        for field, built in (("iters", cfg.iters == 1),
                             ("coarse_warp", not cfg.coarse_warp),
                             ("swap_interlevel", not cfg.swap_interlevel),
                             ("encoder", cfg.encoder == "conv")):
            if not built:
                wrong[field] = getattr(cfg, field)
    if wrong:
        raise NotImplementedError(
            f"config {cfg.name!r}: the port covers encoder in {_ENCODERS}, "
            f"cross in {_CROSSES}, level_block in {_LEVEL_BLOCKS}, "
            f"fps_blocks >= 1, iters >= 1 and coarse_warp within "
            f"{_COARSE_WARP_LEVELS}, and for cross 'pwc' iters 1, no "
            f"coarse_warp, no swap_interlevel and encoder 'conv'; "
            f"unsupported here: {wrong}")


class BidPointFlowNet(nn.Module):
    """Coarse-to-fine bidirectional PointConv scene-flow network.

    Args:
      cfg: the configuration (check_config says what is covered).
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

        if cfg.encoder == "conv":
            self.level0 = PointwiseBlock(3, C[0], g)
            self.level0_1 = self._level_block(0, C[0], g)
            self.level0_2 = PointwiseBlock(C[0], L[0], g)
        else:   # the FG family: lift, same-resolution PointConv, lift
            self.level0_lift = PointwiseBlock(3, C[0], g)
            self.level0 = PointConv(cfg.feat_nei, C[0], C[0],
                                    weightnet=cfg.weightnet[0], generator=g)
            self.level0_1 = PointwiseBlock(C[0], L[0], g)
        for lvl in range(1, 5):
            setattr(self, f"level{lvl}", self._downsample(lvl, g))
            if lvl < 4:
                setattr(self, f"level{lvl}_0",
                        self._level_block(lvl, C[lvl], g))
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
            head, kw = SceneFlowEstimatorResidual, {}
            if cfg.cross == "pwc":
                cross, cost = PointConvFlow(nei, c + D[3 - lvl], (c, c),
                                            generator=g), c
                head = SceneFlowEstimatorPointConv
                kw["flow_channel"] = 0 if lvl == 3 else 3
            else:
                cross_cls, cost = {"light": (CrossLayerLight, c),
                                   "fg": (CrossLayerLightFG, c),
                                   "vote": (CrossLayerLightVote, c + 3),
                                   "nocross": (NoCrossLayerLight, c)
                                   }[cfg.cross]
                mlps = (((c, c),) if cfg.cross == "nocross"
                        else ((c, c), (c, c)))
                cross = cross_cls(nei, c + D[3 - lvl], *mlps, generator=g)
            setattr(self, f"cross{lvl}", cross)
            feat_in = c if lvl == 3 else c + head_mlp[-1]
            kw.update(dict(channels=cfg.flow0_channels, mlp=cfg.flow0_mlp)
                      if lvl == 0 else dict(mlp=head_mlp))
            setattr(self, f"flow{lvl}", head(
                feat_in, cost, weightnet=cfg.flow_weightnet[lvl],
                generator=g, **kw))
        self.to(device)

    @property
    def host_sync_free(self) -> bool:
        """Whether the forward never waits on the card from the host, so
        that it can be captured as a CUDA graph (eval/graphs.py): no layer
        declares a host sync (SYNCS_HOST). Every configuration is."""
        return not any(getattr(m, "SYNCS_HOST", False)
                       for m in self.modules())

    def _level_block(self, idx: int, width: int, g):
        """The same-width block after level idx's downsample (after level0
        at l0): BottleNeck for level_block="bottleneck", else a
        PointwiseBlock."""
        if self.cfg.level_block == "bottleneck":
            return BottleNeck(width, self.cfg.bottleneck_mids[idx], width, g)
        return PointwiseBlock(width, width, g)

    def _downsample(self, lvl: int, g):
        """Level lvl's downsampling conv: PointConvNonLinear at l3 and l4
        with nonlinear_downsample, else PointConvD."""
        cfg = self.cfg
        cls = (PointConvNonLinear if cfg.nonlinear_downsample and lvl >= 3
               else PointConvD)
        return cls(cfg.npoints[lvl], cfg.feat_nei, cfg.lift_channels[lvl - 1],
                   cfg.level_channels[lvl], weightnet=cfg.weightnet[lvl],
                   generator=g, fps_blocks=cfg.fps_blocks)

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

    def _cross(self, lvl, e1, e2, pc2_lvl, c_feat1, c_feat2, feat_idx):
        """Level lvl's cross layer -> (f1_new, f2_new, cost volume);
        no_cross's and pwc's one-tensor layers pass the base features
        on."""
        layer = getattr(self, f"cross{lvl}")
        args = (e1["pc"][lvl], pc2_lvl, c_feat1, c_feat2)
        with annotate("model.cross"):
            if self.cfg.cross in ("nocross", "pwc"):
                return e1["feat"][lvl], e2["feat"][lvl], layer(*args)
            if self.cfg.cross == "fg":
                return layer(*args, e1["feat"][lvl], e2["feat"][lvl],
                             feat_idx=feat_idx)
            return layer(*args)

    def _feature_knn(self, lvl, e1, e2):
        """The FG layer's feature half of level lvl, once for all its
        iterations (it reads the base features only); None otherwise."""
        if self.cfg.cross != "fg":
            return None
        with annotate("model.cross"):
            return getattr(self, f"cross{lvl}").feature_knn(e1["feat"][lvl],
                                                            e2["feat"][lvl])

    def _c_feats(self, e1, e2, lvl, i1, i2):
        """The cross layer's inputs: base features beside the upsampled
        ones, each cloud's own or, with swap_interlevel, the other's."""
        if self.cfg.swap_interlevel:
            i1, i2 = i2, i1
        return (torch.cat([e1["feat"][lvl], i1], -1),
                torch.cat([e2["feat"][lvl], i2], -1))

    def forward(self, xyz1, xyz2, color1, color2) -> Dict[str, Any]:
        cfg = self.cfg
        B = xyz1.shape[0]
        cat = torch.cat

        # both clouds encoded stacked on the batch axis (shared weights)
        with annotate("model.encode"):
            e = self._encode(cat([xyz1, xyz2]), cat([color1, color2]))
        e1 = {k: [t[:B] for t in v] for k, v in e.items()}
        e2 = {k: [t[B:] for t in v] for k, v in e.items()}
        pc1, pc2 = e1["pc"], e2["pc"]

        # l4 -> l3 skip, both clouds stacked
        with annotate("model.upsample"):
            f_l4_3 = self.deconv4_3(upsample_idw(e["pc"][3], e["pc"][4],
                                                 e["feat"][4]))
            c_feat1, c_feat2 = self._c_feats(e1, e2, 3, f_l4_3[:B],
                                             f_l4_3[B:])
        f1_new, f2_new, cross3 = self._cross(
            3, e1, e2, pc2[3], c_feat1, c_feat2, self._feature_knn(3, e1, e2))
        with annotate("model.flow_head"):
            feat3, flow3 = self.flow3(pc1[3], e1["feat"][3], cross3)

        flows = [None, None, None, flow3]
        crosses = [None, None, None, cross3]
        c_feats1, c_feats2 = [None] * 3, [None] * 3
        inter1, inter2 = [None] * 3, [None] * 3
        up_feat, up_flow_src = feat3, flow3
        deconvs = [self.deconv1_0, self.deconv2_1, self.deconv3_2]

        for lvl in (2, 1, 0):
            # one 3-NN per level serves both upsamples: the deconv skip
            # (both clouds stacked) and the flow + feature upsample (the
            # cloud-1 half)
            with annotate("model.upsample"):
                d2_up, idx_up = knn_point_dist(3, e["pc"][lvl + 1],
                                               e["pc"][lvl])
                i_both = deconvs[lvl](upsample_idw(
                    e["pc"][lvl], e["pc"][lvl + 1], cat([f1_new, f2_new]),
                    knn=(d2_up, idx_up)))
                inter1[lvl], inter2[lvl] = i_both[:B], i_both[B:]
                c_feat1, c_feat2 = self._c_feats(e1, e2, lvl, inter1[lvl],
                                                 inter2[lvl])

                both_up = upsample_idw(
                    pc1[lvl], pc1[lvl + 1],
                    cat([cfg.scale * up_flow_src, up_feat], -1),
                    knn=(d2_up[:B], idx_up[:B]))
                up_flow, feat_up = both_up[..., :3], both_up[..., 3:]

            feat_idx = self._feature_knn(lvl, e1, e2)
            it_flows, it_c1, it_c2 = [], [], []
            for it in range(cfg.iters):
                it_c1.append(c_feat1)
                it_c2.append(c_feat2)
                if it == 0 and lvl in cfg.coarse_warp:
                    # the inverse flow built at lvl + 1, where the flow
                    # lives before its upsample, and carried to lvl along
                    # the pc2 half of the decoder's 3-NN: no lvl-resolution
                    # warp search
                    inv_coarse = pc2[lvl + 1] - point_warp(
                        pc1[lvl + 1], pc2[lvl + 1], cfg.scale * up_flow_src)
                    pc2_warp = pc2[lvl] - upsample_idw(
                        pc2[lvl], pc2[lvl + 1], inv_coarse,
                        knn=(d2_up[B:], idx_up[B:]))
                else:
                    pc2_warp = point_warp(pc1[lvl], pc2[lvl], up_flow)
                f1_new, f2_new, cross_l = self._cross(
                    lvl, e1, e2, pc2_warp, c_feat1, c_feat2, feat_idx)
                with annotate("model.flow_head"):
                    feat_l, flow_l = getattr(self, f"flow{lvl}")(
                        pc1[lvl], cat([e1["feat"][lvl], feat_up], -1),
                        cross_l, up_flow)
                it_flows.append(flow_l)
                # the next iteration refines from this one
                up_flow, feat_up = flow_l, feat_l
                if it + 1 < cfg.iters:
                    c_feat1 = cat([e1["feat"][lvl], f1_new], -1)
                    c_feat2 = cat([e2["feat"][lvl], f2_new], -1)
            many = cfg.iters > 1
            flows[lvl] = it_flows if many else flow_l
            c_feats1[lvl] = it_c1 if many else it_c1[0]
            c_feats2[lvl] = it_c2 if many else it_c2[0]
            crosses[lvl] = cross_l
            up_flow_src, up_feat = flow_l, feat_l

        def feats(enc, inter):
            # the FG family's contract inserts feat_l4 at index 4
            l4 = [enc["feat"][4]] if cfg.returns_c_feats else []
            return enc["lift"] + l4 + [inter[2], inter[1], inter[0]]

        out = dict(
            flows=flows,
            fps_idx1=e1["idx"],
            fps_idx2=e2["idx"],
            pc1=pc1[:4],
            pc2=pc2[:4],
            feat1s=feats(e1, inter1),
            feat2s=feats(e2, inter2),
            crosses=crosses,
        )
        if cfg.returns_c_feats:
            out["c_feat1s"], out["c_feat2s"] = c_feats1, c_feats2
        return out
