"""Neural modules of the port (every preset of the model family)."""

from .blocks import (MLP, BottleNeck, Dense, DepthwiseReLU, PointwiseBlock,
                     leaky)
from .cross import (CrossLayerLight, CrossLayerLightFG, CrossLayerLightVote,
                    NoCrossLayerLight)
from .flowhead import SceneFlowEstimatorResidual
from .pointconv import (PointConv, PointConvD, PointConvDRand,
                        PointConvNonLinear, contract_dense, group_knn)
from .weightnet import WeightNet

__all__ = [
    "MLP", "BottleNeck", "Dense", "DepthwiseReLU", "PointwiseBlock", "leaky",
    "CrossLayerLight", "CrossLayerLightFG", "CrossLayerLightVote",
    "NoCrossLayerLight", "SceneFlowEstimatorResidual", "PointConv",
    "PointConvD", "PointConvDRand", "PointConvNonLinear",
    "contract_dense", "group_knn", "WeightNet",
]
