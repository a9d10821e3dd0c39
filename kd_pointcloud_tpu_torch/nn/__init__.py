"""Neural modules of the port (the teacher and the student presets)."""

from .blocks import (MLP, BottleNeck, Dense, DepthwiseReLU, PointwiseBlock,
                     leaky)
from .cross import CrossLayerLight
from .flowhead import SceneFlowEstimatorResidual
from .pointconv import (PointConv, PointConvD, PointConvNonLinear,
                        contract_dense, group_knn)
from .weightnet import WeightNet

__all__ = [
    "MLP", "BottleNeck", "Dense", "DepthwiseReLU", "PointwiseBlock", "leaky",
    "CrossLayerLight", "SceneFlowEstimatorResidual", "PointConv",
    "PointConvD", "PointConvNonLinear",
    "contract_dense", "group_knn", "WeightNet",
]
