"""Command-line entries of the port, one module each, the counterparts of
the JAX package's scripts/{train,evaluate,distill,distill_bridge,
fast_distill}.py:

    python -m kd_pointcloud_tpu_torch.cli.<entry> <config>.yaml [--device cpu]

with the YAML files of kd_pointcloud_tpu/configs/. An entry runs on the
card, and refuses to run when no card is present, unless given
--device cpu. Each module's main(argv) returns what its loop returns.

Under torchrun an entry runs data-parallel, one rank a card (NCCL; gloo
with --device cpu):

    torchrun --nproc_per_node=N -m kd_pointcloud_tpu_torch.cli.train cfg.yaml
"""

from __future__ import annotations

import argparse

from ..device import resolve_device
from ..parallel import init_from_env
from ..utils import parse_args_from_yaml


def parse_config(argv, description: str):
    """(config, device) from the command line: the YAML path and
    --device (default cuda). Under torchrun it joins the process group
    (parallel.init_from_env), and device is this rank's card."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("config", help="YAML config, as kd_pointcloud_tpu/"
                    "configs/*.yaml")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for the plain versions")
    ns = ap.parse_args(argv)
    device = init_from_env(resolve_device(ns.device)).device
    return parse_args_from_yaml(ns.config), device


__all__ = ["parse_config"]
