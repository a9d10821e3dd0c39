"""Bridge: the teacher-feature mixer of bridge distillation.

Port of kd_pointcloud_tpu/models/bridge.py (reference models_bridge.py:
10-29). It mixes both clouds' teacher features and re-projects each:
mixed = block(cat(src, tgt)), out_src = block(cat(src, mixed)), out_tgt =
block(cat(tgt, mixed)), each block a Dense + leaky. The reference applies
out_src to both branches (out_target is built but never used); like the
JAX package, each branch has its own projection here, and
tied_output=True reproduces the reference (no out_target module then).
State-dict names follow the flax module names (mixed_layer, out_src,
out_target), so params_from_jax carries a JAX Bridge's weights over.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..nn import PointwiseBlock


class Bridge(nn.Module):
    """forward(src_feat, target_feat) -> (final_src, final_tar), each
    (B, N, feat_ch), from two (B, N, in_ch) feature sets."""

    def __init__(self, in_ch: int, feat_ch: int = 512,
                 tied_output: bool = False, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.tied_output = tied_output
        self.mixed_layer = PointwiseBlock(2 * in_ch, feat_ch, g)
        self.out_src = PointwiseBlock(in_ch + feat_ch, feat_ch, g)
        if not tied_output:
            self.out_target = PointwiseBlock(in_ch + feat_ch, feat_ch, g)
        self.to(resolve_device(device))

    def forward(self, src_feat, target_feat):
        mixed = self.mixed_layer(torch.cat([src_feat, target_feat], -1))
        out_target = self.out_src if self.tied_output else self.out_target
        return (self.out_src(torch.cat([src_feat, mixed], -1)),
                out_target(torch.cat([target_feat, mixed], -1)))
