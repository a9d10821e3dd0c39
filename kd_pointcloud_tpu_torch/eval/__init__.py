"""Evaluation of the port: the six metrics, the projection to pixels and
the loader-driven eval sweep."""

from .geometry import (FT3D_INTRINSICS, calib_dir_for, get_batch_2d_flow,
                       project_3d_to_2d, read_kitti_intrinsics)
from .metrics import (evaluate_2d, evaluate_2d_torch, evaluate_3d,
                      evaluate_3d_torch)
from .runner import (METRIC_KEYS, evaluate_model, make_eval_forward,
                     make_eval_metrics_step, pairs_loader, project_points,
                     synthetic_pairs)

__all__ = ["FT3D_INTRINSICS", "calib_dir_for", "get_batch_2d_flow",
           "project_3d_to_2d", "read_kitti_intrinsics", "evaluate_2d",
           "evaluate_2d_torch", "evaluate_3d", "evaluate_3d_torch",
           "METRIC_KEYS", "evaluate_model", "make_eval_forward",
           "make_eval_metrics_step", "pairs_loader", "project_points",
           "synthetic_pairs"]
