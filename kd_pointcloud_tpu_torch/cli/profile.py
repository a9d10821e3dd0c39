"""Profile presets: python -m kd_pointcloud_tpu_torch.cli.profile [preset
...] [--points N] [--device cpu] (scripts/profile_model.py; the
reference's per-model profiling mains). For each preset (teacher when none
is named) it builds the model with seeded random weights and prints one
line: parameters, the operations of one eval forward at batch 1
(perf.profiling flop_count: dense matrix products plus the kernels' work),
its latency and pairs/s. --points scales every level's npoints as the JAX
script does. It runs on the card, and refuses to run when no card is
present, unless given --device cpu."""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..models import PRESETS, BidPointFlowNet
from ..perf import profile_model


def scaled(cfg, points: int):
    """cfg with npoints scaled to `points` at l0 (at least 8 a level)."""
    if points == cfg.npoints[0]:
        return cfg
    scale = points / cfg.npoints[0]
    return dataclasses.replace(cfg, npoints=tuple(
        max(8, int(p * scale)) for p in cfg.npoints))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("presets", nargs="*", default=None)
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.RandomState(0)
    results = {}
    for name in args.presets or ["teacher"]:
        cfg = scaled(PRESETS[name], args.points)
        model = BidPointFlowNet(cfg, device=device,
                                generator=torch.Generator().manual_seed(0))
        x1, x2 = (torch.from_numpy(rng.randn(1, cfg.npoints[0], 3).astype(
            np.float32)).to(device) for _ in range(2))
        stats = profile_model(model, x1, x2, x1, x2)
        results[name] = stats
        print(f"{name}: params={stats['params'] / 1e6:.2f}M "
              f"flops={stats['flops'] / 1e9:.2f}G "
              f"latency={stats['latency_ms']:.1f}ms "
              f"({stats['pairs_per_sec']:.1f} pairs/s) on {device}",
              flush=True)
    return results


if __name__ == "__main__":
    main()
