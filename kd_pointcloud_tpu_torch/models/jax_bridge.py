"""Weight bridge: the JAX package's variables -> the port's state_dict.

``params_from_jax`` takes a {"params": ..., "batch_stats": ...} tree of
nested dicts of numpy arrays (flax's layout, for the whole BidPointFlowNet
or any module of it) and returns the state_dict of the port's counterpart.
Flax module names map onto the port's attribute names; Dense kernels (in,
out) become (out, in) weights, with the PointConv kernel's c-major (C*W)
input order kept; BatchNorm scale, bias, mean and var become weight, bias,
running_mean and running_var.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

# applied in order to the '/'-joined flax path of every leaf
_RULES = (
    (re.compile(r"WeightNet_0/Dense_(\d+)"), r"weightnet/layers/\1"),
    (re.compile(r"PointwiseBlock_(\d+)/Dense_0"), r"layers/\1/dense"),
    (re.compile(r"MLP_0"), "mlp"),
    (re.compile(r"PointConv_(\d+)"), r"convs/\1"),
    (re.compile(r"BatchNorm_0"), "bn"),
    (re.compile(r"Dense_0"), "dense"),
)
_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight",
           "mean": "running_mean", "var": "running_var"}


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
    head, leaf = path.rsplit("/", 1)
    return f"{head}/{_LEAVES[leaf]}".replace("/", ".")


def params_from_jax(variables: Mapping) -> dict:
    """state_dict for the port from flax variables (nested dicts of arrays)."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            arr = np.asarray(value, dtype=np.float32)
            if path.endswith("kernel"):
                arr = arr.T
            state[torch_key(path)] = torch.tensor(arr)
    for key in [k for k in state if k.endswith(".running_mean")]:
        state[key[:-len("running_mean")] + "num_batches_tracked"] = \
            torch.tensor(0, dtype=torch.long)
    return state
