"""The licensing band for approximation rulings.

Port of kd_pointcloud_tpu/eval/licensing.py. Every relaxation of exact
reference semantics (coarse warp, cost-volume K, FPS blocking) is licensed
against one criterion: the directional six-metric band below, evaluated
on trained-regime weights over KITTI sweep scenes, with paired per-scene
deltas (variant - exact).

Metric order everywhere: [epe3d acc3ds acc3dr outliers epe2d acc2d]
(eval/metrics.py semantics).
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from ..data import KITTI, ProcessData
from .geometry import calib_dir_for, get_batch_2d_flow
from .metrics import evaluate_2d, evaluate_3d
from .runner import make_eval_forward

# Directional (degradation-only) tolerances: EPE and Outliers are lower
# better (a delta must not exceed +band), the ACCs higher better (a delta
# must not fall below -band). Improvements never fail the band.
BAND = (1e-3, 3e-3, 3e-3, 3e-3, 5e-2, 3e-3)
LOWER_BETTER = (True, False, False, True, True, False)
METRIC_NAMES = ("epe3d", "acc3ds", "acc3dr", "outliers", "epe2d", "acc2d")


def in_band(d) -> bool:
    """Directional band verdict for a six-metric delta vector (variant -
    exact). At 50 scenes the paired standard error of the ACC metrics is
    ~2e-3: report it beside any ruling."""
    return bool(all((x <= b) if lb else (x >= -b)
                    for x, b, lb in zip(d, BAND, LOWER_BETTER)))


def load_scenes(n_scenes: int, num_points: int, root: str):
    """The first n KITTI sweep scenes under data root `root` (the
    KITTI class's layout: <root>/kitti_processed, <root>/KITTI_mapping.txt)
    as (pc1, pc2, sf, path) tuples, through the deterministic eval
    transform every ruling uses."""
    ds = KITTI(train=False, transform=ProcessData(num_points=num_points),
               data_root=root)
    scenes = []
    for i in range(n_scenes):
        pc1s, pc2s, _, _, sf, path = ds[i]
        scenes.append((pc1s, pc2s, sf, path))
    return scenes


def sweep_rows(model, scenes, device, calib_dir: str | None = None
               ) -> np.ndarray:
    """Per-scene six-metric rows (S, 6) of `model` (on `device`) over
    load_scenes' tuples, at batch 1; an iterative model's list-valued flow
    scores its last iteration. KITTI's calibration comes from calib_dir,
    by default the reference layout's next to each scene's data root
    (eval.geometry.calib_dir_for)."""
    fwd = make_eval_forward(model)
    rows = []
    for pc1s, pc2s, sf, path in scenes:
        a, b = (torch.from_numpy(np.asarray(x, np.float32))[None].to(device)
                for x in (pc1s, pc2s))
        pred = fwd(a, b, a, b)[0].cpu().numpy()
        epe3d, a3s, a3r, outl = evaluate_3d(pred, sf)
        calib = calib_dir or calib_dir_for(osp.dirname(osp.dirname(path)))
        f2d_pred, f2d_gt = get_batch_2d_flow(
            pc1s[None], (pc1s + sf)[None], (pc1s + pred)[None], [path],
            calib)
        epe2d, a2d = evaluate_2d(f2d_pred[0], f2d_gt[0])
        rows.append([epe3d, a3s, a3r, outl, epe2d, a2d])
    return np.asarray(rows)
