"""Self-supervised Chamfer + smoothness + curvature loss.

Port of kd_pointcloud_tpu/losses/selfsup.py (the reference's
multiScaleChamferSmoothCurvature and its helpers, models_bid_pointconv.py
:565-677). Channels-last (B, N, 3). Every neighbour search goes through
ops.knn_point_dist, so on the card it launches the kNN kernel (k = 10 for
the curvatures, 9 for smoothness, 5 for the curvature interpolation, which
weights by the search's distances and takes their gradient). chamfer's full
square_distance and its two minima are plain torch, as they are XLA in the
JAX package.
"""

from __future__ import annotations

import torch

from ..ops import group_points, knn_point_dist, square_distance
from .multiscale import ALPHA, safe_norm


def curvature(pc, k: int = 10):
    """Mean offset to the 10-NN (self included) / 9."""
    _, idx = knn_point_dist(k, pc, pc)
    grouped = group_points(pc, idx)
    return (grouped - pc[:, :, None, :]).sum(2) / (k - 1)


def curvature_of_warped(pc, warped_pc, k: int = 10):
    """Curvature of warped_pc over pc's neighbourhood graph."""
    _, idx = knn_point_dist(k, pc, pc)
    grouped = group_points(warped_pc, idx)
    return (grouped - warped_pc[:, :, None, :]).sum(2) / (k - 1)


def chamfer(pc1, pc2):
    """Two-sided nearest squared distances, (B, N1) and (B, N2); the
    minima's gradient splits among equal distances, as jnp.min's does."""
    d = square_distance(pc1, pc2)
    return torch.amin(d, dim=2), torch.amin(d, dim=1)


def smoothness(pc1, flow, k: int = 9):
    """Mean 9-NN flow deviation; the query is its own neighbour (a zero
    difference), where safe_norm keeps the gradient finite."""
    _, idx = knn_point_dist(k, pc1, pc1)
    grouped = group_points(flow, idx)
    return safe_norm(grouped - flow[:, :, None, :]).sum(2) / (k - 1)


def interpolate_curvature(pc1, pc2, pc2_curv, k: int = 5):
    """pc2's curvature at pc1 by inverse-squared-distance weights over the
    5-NN in pc2."""
    d2, idx = knn_point_dist(k, pc2, pc1)
    grouped = group_points(pc2_curv, idx)
    inv = 1.0 / (d2 + 1e-8)
    w = inv / inv.sum(2, keepdim=True)
    return (w[..., None] * grouped).sum(2)


def multi_scale_chamfer_smooth_curvature(pc1, pc2, pred_flows, alpha=ALPHA,
                                         f_curvature=0.3, f_smoothness=1.0,
                                         f_chamfer=1.0):
    """pc1, pc2 and pred_flows are per-level lists (fine -> coarse).
    Returns (total, chamfer, curvature, smoothness) scalars."""
    zero = torch.zeros((), dtype=torch.float32, device=pc1[0].device)
    chamfer_l = smooth_l = curv_l = zero
    for i in range(len(pred_flows)):
        cur_pc1, cur_pc2, cur_flow = pc1[i], pc2[i], pred_flows[i]
        cur_pc2_curv = curvature(cur_pc2)
        warped = cur_pc1 + cur_flow
        d1, d2 = chamfer(warped, cur_pc2)
        moved_curv = curvature_of_warped(cur_pc1, warped)

        chamfer_l = chamfer_l + alpha[i] * (d1.sum(1).mean()
                                            + d2.sum(1).mean())
        smooth_l = smooth_l + alpha[i] * smoothness(cur_pc1,
                                                    cur_flow).sum(1).mean()
        inter_curv = interpolate_curvature(warped, cur_pc2, cur_pc2_curv)
        curv_l = curv_l + alpha[i] * ((inter_curv - moved_curv) ** 2).sum(
            -1).sum(1).mean()

    total = f_chamfer * chamfer_l + f_curvature * curv_l \
        + f_smoothness * smooth_l
    return total, chamfer_l, curv_l, smooth_l
