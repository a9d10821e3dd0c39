"""Scene-flow metrics: EPE3D, ACC3DS, ACC3DR, Outliers3D, EPE2D, ACC2D.

Port of kd_pointcloud_tpu/eval/metrics.py (reference evaluation_utils.py):
``evaluate_3d`` and ``evaluate_2d`` are the numpy versions, copied;
``evaluate_3d_torch`` and ``evaluate_2d_torch`` the batched on-device ones.
ACC3DS: error < 0.05 m or < 5 % relative; ACC3DR: < 0.1 m or < 10 %;
Outliers3D: > 0.3 m or > 10 %; ACC2D: < 3 px or < 5 %.
"""

from __future__ import annotations

import numpy as np
import torch


def evaluate_3d(sf_pred: np.ndarray, sf_gt: np.ndarray):
    """Args: (N, 3) arrays. Returns (EPE3D, ACC3DS, ACC3DR, outliers)."""
    l2 = np.linalg.norm(sf_gt - sf_pred, axis=-1)
    epe3d = l2.mean()
    sf_norm = np.linalg.norm(sf_gt, axis=-1)
    rel = l2 / (sf_norm + 1e-4)
    acc_s = np.logical_or(l2 < 0.05, rel < 0.05).astype(np.float64).mean()
    acc_r = np.logical_or(l2 < 0.1, rel < 0.1).astype(np.float64).mean()
    outlier = np.logical_or(l2 > 0.3, rel > 0.1).astype(np.float64).mean()
    return epe3d, acc_s, acc_r, outlier


def evaluate_2d(flow_pred: np.ndarray, flow_gt: np.ndarray):
    """Args: (N, 2) pixel flows. Returns (EPE2D, ACC2D)."""
    epe2d = np.linalg.norm(flow_gt - flow_pred, axis=-1)
    flow_gt_norm = np.linalg.norm(flow_gt, axis=-1)
    rel = epe2d / (flow_gt_norm + 1e-5)
    acc2d = np.logical_or(epe2d < 3.0, rel < 0.05).astype(np.float64).mean()
    return epe2d.mean(), acc2d


def evaluate_3d_torch(sf_pred: torch.Tensor, sf_gt: torch.Tensor):
    """(B, N, 3) -> per-sample (B,) EPE3D, ACC3DS, ACC3DR, Outliers3D."""
    l2 = torch.linalg.vector_norm(sf_gt - sf_pred, dim=-1)
    rel = l2 / (torch.linalg.vector_norm(sf_gt, dim=-1) + 1e-4)
    acc_s = ((l2 < 0.05) | (rel < 0.05)).float().mean(-1)
    acc_r = ((l2 < 0.1) | (rel < 0.1)).float().mean(-1)
    outlier = ((l2 > 0.3) | (rel > 0.1)).float().mean(-1)
    return l2.mean(-1), acc_s, acc_r, outlier


def evaluate_2d_torch(flow_pred: torch.Tensor, flow_gt: torch.Tensor):
    """(B, N, 2) pixel flows -> per-sample (B,) EPE2D, ACC2D."""
    epe2d = torch.linalg.vector_norm(flow_gt - flow_pred, dim=-1)
    rel = epe2d / (torch.linalg.vector_norm(flow_gt, dim=-1) + 1e-5)
    acc2d = ((epe2d < 3.0) | (rel < 0.05)).float().mean(-1)
    return epe2d.mean(-1), acc2d
