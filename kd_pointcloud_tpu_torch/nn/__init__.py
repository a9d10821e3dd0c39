"""Neural modules of the port (teacher path)."""

from .blocks import MLP, Dense, PointwiseBlock, leaky
from .cross import CrossLayerLight
from .flowhead import SceneFlowEstimatorResidual
from .pointconv import PointConv, PointConvD, contract_dense, group_knn
from .weightnet import WeightNet

__all__ = [
    "MLP", "Dense", "PointwiseBlock", "leaky", "CrossLayerLight",
    "SceneFlowEstimatorResidual", "PointConv", "PointConvD",
    "contract_dense", "group_knn", "WeightNet",
]
