"""Weight bridge: the JAX package's variables -> the port's state_dict.

``params_from_jax`` takes a {"params": ..., "batch_stats": ...} tree of
nested dicts of numpy arrays (flax's layout, for the whole BidPointFlowNet,
the Bridge, or any module of either) and returns the state_dict of the
port's counterpart; the Bridge's flax names (mixed_layer, out_src,
out_target) are the port's attribute names.
Flax module names map onto the port's attribute names; every kernel is
transposed: Dense kernels (in, out) become (out, in) weights, with the
PointConv kernel's c-major (C*W) input order kept, the BottleNeck's 3-tap
Conv kernel (3, in, out) becomes torch's conv1d (out, in, 3) and the
DepthwiseReLU kernel (in, mult) becomes (mult, in); BatchNorm scale, bias,
mean and var become weight, bias, running_mean and running_var;
PointConvNonLinear's depthwise (C, 1) and depthwise_bias keep their names
and shapes. The experimental inventory's leaves follow the same rules: the
ConvGRU's convz / convr / convq kernels (3, in, out) become (out, in, 3),
the vector-neuron kernel / dir_kernel / frame_kernel (F_in, F_out) become
weight / dir_weight / frame_weight (F_out, F_in), and PointConvBias's
(1, 1, C, W) bias, not a kernel, keeps its shape.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

# applied in order to the '/'-joined flax path of every leaf; an indexed
# flax name X_0, X_1, X_2 ... becomes x, x1, x2 ...
_RULES = (
    (re.compile(r"WeightNet_0/Dense_(\d+)"), r"weightnet/layers/\1"),
    # the experimental inventory's named WeightNets
    (re.compile(r"(weightnet\d+|p2p2)/Dense_(\d+)"), r"\1/layers/\2"),
    (re.compile(r"PointwiseBlock_(\d+)/Dense_0"), r"layers/\1/dense"),
    (re.compile(r"MLP_0"), "mlp"),
    (re.compile(r"PointConv_(\d+)"), r"convs/\1"),
    # the inventory's flow-head blocks
    (re.compile(r"(SepConv|PointConvBias|PointConvSVD|PointConvFactor"
                r"|SetAbstract|SetAbstractFuse)_(\d+)"), r"convs/\2"),
    (re.compile(r"FlowEmbeddingLayer_0"), "flow_embedding"),
    (re.compile(r"VNLinearLeakyReLU_0"), "linear_leaky"),
    (re.compile(r"VNLinearLeakyReLU_(\d+)"), r"linear_leaky\1"),
    (re.compile(r"VNMaxPool_0"), "max_pool"),
    (re.compile(r"VNBatchNorm_0"), "bn"),
    (re.compile(r"BatchNorm_0"), "bn"),
    (re.compile(r"BatchNorm_(\d+)"), r"bn\1"),
    (re.compile(r"Dense_0"), "dense"),
    (re.compile(r"Dense_(\d+)"), r"dense\1"),     # BottleNeck's Dense_1
    (re.compile(r"Conv_0"), "conv"),
    (re.compile(r"DepthwiseReLU_0"), "depthwise"),
)
_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight",
           "mean": "running_mean", "var": "running_var",
           "depthwise": "depthwise", "depthwise_bias": "depthwise_bias",
           "dir_kernel": "dir_weight", "frame_kernel": "frame_weight"}


def _flatten(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def torch_key(flax_path: str) -> str:
    """The port's state_dict key of one flax leaf path ('a/b/kernel')."""
    path = flax_path
    for pattern, repl in _RULES:
        path = pattern.sub(repl, path)
    head, _, leaf = path.rpartition("/")
    return f"{head}/{_LEAVES[leaf]}".strip("/").replace("/", ".")


def params_from_jax(variables: Mapping) -> dict:
    """state_dict for the port from flax variables (nested dicts of arrays)."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            arr = np.asarray(value, dtype=np.float32)
            if path.endswith("kernel"):
                arr = arr.T                  # reverses every axis
            state[torch_key(path)] = torch.tensor(arr)
    for key in [k for k in state if k.endswith(".running_mean")]:
        state[key[:-len("running_mean")] + "num_batches_tracked"] = \
            torch.tensor(0, dtype=torch.long)
    return state
