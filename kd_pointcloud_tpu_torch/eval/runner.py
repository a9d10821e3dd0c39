"""Evaluation: the model's eval forward and the 3-D metrics over a set of
scene pairs.

Port of the forward step of kd_pointcloud_tpu/eval/runner.py
(make_eval_forward / make_eval_metrics_step with with_2d=False): the 3-D
metrics and the eval loss (the per-sample multi-scale loss through the pc1
FPS chain). The 2-D metrics need the KITTI calibration, which the
repository does not hold. With no KITTI scenes on disk, ``synthetic_pairs``
makes seeded 8192-point pairs, as bench.py falls back to random clouds.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

from ..device import use_full_fp32
from ..losses import multi_scale_loss_per_sample
from .metrics import evaluate_3d_torch

METRIC_KEYS = ("epe3d", "acc3ds", "acc3dr", "outliers", "loss")


def flow0_of(out) -> torch.Tensor:
    """The model's finest flow: the last iteration's where l0 holds a
    per-iteration list (iters > 1)."""
    flow0 = out["flows"][0]
    return flow0[-1] if isinstance(flow0, (list, tuple)) else flow0


def make_eval_forward(model):
    """fn(pos1, pos2, norm1, norm2) -> flow0 (B, N, 3): the eval forward,
    without autograd, with the model in eval mode (BatchNorm from running
    statistics)."""
    use_full_fp32()
    model.eval()

    def fwd(pos1, pos2, norm1, norm2):
        with torch.inference_mode():
            return flow0_of(model(pos1, pos2, norm1, norm2))

    return fwd


def make_eval_metrics_step(model):
    """fn(pos1, pos2, norm1, norm2, flow) -> (B, 5) per-sample
    [epe3d, acc3ds, acc3dr, outliers, loss], computed on the model's
    device, in eval mode without autograd."""
    use_full_fp32()

    def step(pos1, pos2, norm1, norm2, flow):
        model.eval()
        with torch.inference_mode():
            out = model(pos1, pos2, norm1, norm2)
            loss = multi_scale_loss_per_sample(out["flows"], flow,
                                               out["fps_idx1"])
            return torch.stack([*evaluate_3d_torch(flow0_of(out), flow),
                                loss], dim=-1)

    return step


def evaluate_model(model, pairs: Iterable[Sequence[np.ndarray]]
                   ) -> Dict[str, float]:
    """Mean EPE3D / ACC3DS / ACC3DR / Outliers3D and eval loss over (pos1,
    pos2, norm1, norm2, flow) pairs of (N, 3) arrays, each run at batch 1 on
    the model's device; one host sync at the end."""
    device = next(model.parameters()).device
    step = make_eval_metrics_step(model)
    rows: List[torch.Tensor] = []
    for pair in pairs:
        t = [torch.as_tensor(np.asarray(a, np.float32))[None].to(device)
             for a in pair]
        rows.append(step(*t))
    mean = torch.cat(rows).mean(0).cpu().numpy()
    return dict(zip(METRIC_KEYS, (float(v) for v in mean)))


def synthetic_pairs(n: int, npoints: int = 8192, seed: int = 0):
    """n seeded scene pairs shaped like KITTI eval inputs: pc1 uniform in a
    60 x 3 x 35 m box in front of the sensor, pc2 a small rigid motion of pc1
    (yaw up to 0.05 rad, up to 1 m) plus 1 cm noise, flow = pc2 - pc1 row by
    row, and norms equal to positions as in the data pipeline."""
    rng = np.random.RandomState(seed)
    lo, hi = np.array([-30.0, -1.4, 0.0]), np.array([30.0, 1.6, 35.0])
    out = []
    for _ in range(n):
        pc1 = rng.uniform(lo, hi, size=(npoints, 3))
        yaw = rng.uniform(-0.05, 0.05)
        rot = np.array([[np.cos(yaw), 0.0, np.sin(yaw)], [0.0, 1.0, 0.0],
                        [-np.sin(yaw), 0.0, np.cos(yaw)]])
        shift = rng.uniform(-1.0, 1.0, size=3)
        pc2 = pc1 @ rot.T + shift + 0.01 * rng.standard_normal(pc1.shape)
        pc1, pc2 = pc1.astype(np.float32), pc2.astype(np.float32)
        out.append((pc1, pc2, pc1, pc2, pc2 - pc1))
    return out
