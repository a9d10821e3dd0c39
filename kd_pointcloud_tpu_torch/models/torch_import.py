"""Import the reference's PyTorch checkpoints into the port.

Port of kd_pointcloud_tpu/models/torch_import.py, its three families:
"teacher" (models_bid_pointconv.py / models_bid_lighttoken_res.py /
weight48: the architecture of the reference's released checkpoints), "fg"
(models_bid_FG.py / models_bifeat.py: a PointConv at level 0 after a
level0_lift block, and no level0_2) and "vote" (the teacher's keys and a
1x1 `vote` conv in each cross layer). The JAX package
turns a reference state_dict into flax trees; the port maps it straight
onto its own state_dict, with no transposes: the reference's 1x1 Conv
weights (O, I, 1[, 1]) become (O, I) Dense weights, its Linear weights are
the port's Dense weights as they are (the PointConv linear's c-major (C, W)
input order is the port's), and BatchNorm1d keeps weight, bias,
running_mean, running_var and num_batches_tracked.

Dead parameters of the reference are skipped, as in the JAX package: the
cross layers' bias1 / bias2 (never used) and the WeightNets' mlp_bns (built
but bypassed). Any other key left over is an error.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import torch

# the reference's plain Conv1d blocks (<name>.composed_module.0.*)
_CONV_BLOCKS = ("level0", "level0_1", "level0_2", "level1_0", "level1_1",
                "level2_0", "level2_1", "level3_0", "level3_1",
                "deconv4_3", "deconv3_2", "deconv2_1", "deconv1_0")
# the FG family's: level0 is a PointConv, fed by level0_lift
_CONV_BLOCKS_FG = ("level0_lift", "level0_1", "level1_0", "level1_1",
                   "level2_0", "level2_1", "level3_0", "level3_1",
                   "deconv4_3", "deconv3_2", "deconv2_1", "deconv1_0")
FAMILIES = ("teacher", "fg", "vote")
_CROSS_DENSE = ("cross_t11", "cross_t22", "cross_t1", "cross_t2", "pos1",
                "pos2")
_BN = ("weight", "bias", "running_mean", "running_var",
       "num_batches_tracked")
_DEAD = re.compile(r"(\.weightnet\.mlp_bns\.)|(\.bias[12]$)")


def convert_state_dict(state_dict: Dict[str, Any], family: str = "teacher"
                       ) -> Dict[str, torch.Tensor]:
    """The port's BidPointFlowNet state_dict from a reference state_dict
    (raw, or under "state_dict"; a DataParallel "module." prefix is
    dropped)."""
    if family not in FAMILIES:
        raise ValueError(f"family {family!r}: one of {FAMILIES}")
    if isinstance(state_dict.get("state_dict"), dict):
        state_dict = state_dict["state_dict"]
    sd = {k[7:] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    used = set()

    def take(src: str, dst: str, matrix: bool = False) -> None:
        used.add(src)
        t = torch.as_tensor(sd[src]).detach().cpu()
        if matrix:          # (O, I, 1[, 1]) conv weight -> (O, I)
            t = t.reshape(t.shape[0], t.shape[1])
        out[dst] = t.clone() if t.dtype == torch.long else \
            t.to(torch.float32).clone()

    def dense(src: str, dst: str, conv: bool = True) -> None:
        take(f"{src}.weight", f"{dst}.weight", matrix=conv)
        take(f"{src}.bias", f"{dst}.bias")

    def pointconv(src: str, dst: str) -> None:
        for j in range(3):
            dense(f"{src}.weightnet.mlp_convs.{j}",
                  f"{dst}.weightnet.layers.{j}")
        dense(f"{src}.linear", f"{dst}.dense", conv=False)

    for name in _CONV_BLOCKS_FG if family == "fg" else _CONV_BLOCKS:
        dense(f"{name}.composed_module.0", f"{name}.dense")
    for lvl in range(0 if family == "fg" else 1, 5):
        pointconv(f"level{lvl}", f"level{lvl}")
    for lvl in range(4):
        base = f"cross{lvl}"
        for t in _CROSS_DENSE:
            dense(f"{base}.{t}", f"{base}.{t}")
        for mlp in ("mlp1", "mlp2"):
            i = 0
            while f"{base}.{mlp}.{i}.composed_module.0.weight" in sd:
                dense(f"{base}.{mlp}.{i}.composed_module.0",
                      f"{base}.{mlp}.layers.{i}.dense")
                i += 1
        if family == "vote":
            dense(f"{base}.vote", f"{base}.vote")
    for lvl in range(4):
        base = f"flow{lvl}"
        i = 0
        while f"{base}.pointconv_list.{i}.linear.weight" in sd:
            pc = f"{base}.pointconv_list.{i}"
            pointconv(pc, f"{base}.convs.{i}")
            for leaf in _BN:
                take(f"{pc}.bn_linear.{leaf}", f"{base}.convs.{i}.bn.{leaf}")
            i += 1
        j = 0
        while f"{base}.mlp_convs.{j}.composed_module.0.weight" in sd:
            dense(f"{base}.mlp_convs.{j}.composed_module.0",
                  f"{base}.mlp.layers.{j}.dense")
            j += 1
        dense(f"{base}.fc", f"{base}.dense")     # a raw 1x1 Conv1d

    leftover = [k for k in sd if k not in used and not _DEAD.search(k)]
    if leftover:
        raise ValueError(f"unmapped checkpoint keys: {leftover[:10]}")
    return out


def load_torch_checkpoint(path: str, family: str = "teacher"
                          ) -> Dict[str, torch.Tensor]:
    """Read a reference .pth (tensors only: torch.load with
    weights_only=True) and convert it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_state_dict(sd, family=family)
