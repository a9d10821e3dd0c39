"""Model-family configuration: the port's copy of
kd_pointcloud_tpu/models/config.py (ModelConfig, PRESETS, tiny_config).

The fields and presets are the JAX package's, value for value, so a preset
names the same network in both packages; field comments there give each
field's source in the reference. The preset pointpwc (cross="pwc",
PointPWC-Net, Wu et al., ECCV 2020: models.py
PointConvSceneFlowPWC8192selfglobalPointConv) is the port's alone. The port
builds every preset and every fps_blocks >= 1 (models/bid_pointflow.py
check_config names the values it refuses). knn_method, knn_recall,
knn_precision and fps_backend select between the TPU's search and sampling
back ends; the port's kNN and FPS are exact and ignore them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Configuration of a BidPointFlowNet variant; defaults are the teacher
    (models_bid_pointconv.py == models_bid_lighttoken_res.py)."""

    name: str = "teacher"
    npoints: Tuple[int, ...] = (8192, 2048, 512, 256, 64)
    level_channels: Tuple[int, ...] = (32, 64, 128, 256, 256)
    lift_channels: Tuple[int, ...] = (64, 128, 256, 512)
    flow_nei: int = 32
    flow_nei_per_level: "Tuple[int, ...] | None" = None
    fps_blocks: int = 1
    fps_backend: str = "auto"
    feat_nei: int = 16
    weightnet: Tuple[int, ...] = (16, 16, 16, 16, 16)
    flow_weightnet: Tuple[int, ...] = (16, 16, 16, 16)
    cross: str = "light"
    encoder: str = "conv"
    level_block: str = "conv"
    bottleneck_mids: Tuple[int, ...] = (16, 32, 64, 64)
    nonlinear_downsample: bool = False
    iters: int = 1
    deconv: Tuple[int, ...] = (64, 64, 32, 32)
    flow0_channels: Tuple[int, ...] = (128, 128)
    flow0_mlp: Tuple[int, ...] = (128, 64)
    swap_interlevel: bool = False
    scale: float = 1.0
    knn_method: str = "approx"
    knn_recall: float = 0.95
    knn_precision: str = "highest"
    fg_feat_knn_method: "str | None" = None
    fg_euclid_knn_method: "str | None" = None
    coarse_warp: Tuple[int, ...] = ()
    nested_fps: bool = True

    @property
    def returns_c_feats(self) -> bool:
        return self.encoder == "pointconv"


PRESETS = {
    "teacher": ModelConfig(name="teacher"),
    "serving": ModelConfig(name="serving",
                           flow_nei_per_level=(16, 16, 32, 32)),
    "serving_v2": ModelConfig(name="serving_v2",
                              flow_nei_per_level=(16, 32, 32, 32)),
    "serving_v3": ModelConfig(name="serving_v3", coarse_warp=(0,)),
    "lighttoken_res": ModelConfig(name="lighttoken_res"),
    "weight48": ModelConfig(
        name="weight48",
        weightnet=(4, 4, 4, 8, 8),
        flow_weightnet=(4, 4, 4, 8),
    ),
    "fg": ModelConfig(
        name="fg", cross="fg", encoder="pointconv", feat_nei=32,
        weightnet=(8, 8, 8, 8, 8), flow_weightnet=(8, 8, 8, 8),
        deconv=(64, 128, 64, 32),
        flow0_channels=(64, 64), flow0_mlp=(64, 64),
    ),
    "bifeat": ModelConfig(
        name="bifeat", cross="fg", encoder="pointconv", feat_nei=32,
        weightnet=(8, 8, 8, 8, 8), flow_weightnet=(8, 8, 8, 8),
        deconv=(64, 128, 64, 32),
        flow0_channels=(64, 64), flow0_mlp=(64, 64),
        iters=2,
    ),
    "no_cross": ModelConfig(
        name="no_cross", cross="nocross",
        weightnet=(8, 8, 8, 8, 8), flow_weightnet=(8, 8, 8, 8),
        swap_interlevel=True,
    ),
    "non_linear": ModelConfig(
        name="non_linear", level_block="bottleneck",
        nonlinear_downsample=True,
    ),
    "vote": ModelConfig(
        name="vote", cross="vote",
        weightnet=(8, 8, 8, 8, 8), flow_weightnet=(8, 8, 8, 8),
    ),
    # PointPWC-Net at its published widths: the teacher's pyramid,
    # deconvs, flow-head stack and loss, with PointConvFlow cost volumes
    # (32-NN, MLP (c, c)) and heads that predict the flow
    "pointpwc": ModelConfig(name="pointpwc", cross="pwc"),
    "student": ModelConfig(
        name="student", level_block="bottleneck",
        level_channels=(16, 32, 64, 128, 128),
        lift_channels=(32, 64, 128, 256),
        bottleneck_mids=(8, 8, 16, 32),
        deconv=(32, 32, 32, 16),
    ),
    "student2": ModelConfig(
        name="student2", level_block="bottleneck",
        level_channels=(32, 64, 64, 128, 128),
        lift_channels=(64, 64, 128, 256),
        bottleneck_mids=(16, 16, 16, 32),
        deconv=(32, 32, 32, 32),
    ),
}


def tiny_config(base: str = "teacher",
                npoints=(256, 128, 64, 32, 16)) -> ModelConfig:
    """Small-shape variant of a preset for tests: neighbour counts shrink so
    every kNN has k <= the cloud size at its level."""
    return dataclasses.replace(PRESETS[base], name=f"tiny_{base}",
                               npoints=tuple(npoints),
                               flow_nei=min(16, npoints[3]),
                               flow_nei_per_level=None,
                               feat_nei=min(8, npoints[4]))
