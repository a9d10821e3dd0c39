"""Neural modules of the port (every preset of the model family, and the
experimental inventory: nn/experimental.py, nn/vn_layers.py)."""

from .blocks import (MLP, BottleNeck, ConvGRU, Dense, DepthwiseReLU,
                     PointwiseBlock, leaky)
from .cross import (CrossLayerLight, CrossLayerLightFG, CrossLayerLightVote,
                    NoCrossLayerLight)
from .flowhead import (SceneFlowEstimatorPointConv, SceneFlowEstimatorResidual,
                       SceneFlowEstimatorResidualIter)
from .pointconv import (PointConv, PointConvD, PointConvDRand,
                        PointConvNonLinear, contract_dense, group_knn,
                        weighted_contract)
from .weightnet import WeightNet

__all__ = [
    "MLP", "BottleNeck", "ConvGRU", "Dense", "DepthwiseReLU",
    "PointwiseBlock", "leaky",
    "CrossLayerLight", "CrossLayerLightFG", "CrossLayerLightVote",
    "NoCrossLayerLight",
    "SceneFlowEstimatorPointConv", "SceneFlowEstimatorResidual",
    "SceneFlowEstimatorResidualIter",
    "PointConv", "PointConvD", "PointConvDRand", "PointConvNonLinear",
    "contract_dense", "group_knn", "weighted_contract",
    "WeightNet",
]
