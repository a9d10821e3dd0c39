"""Multi-scale supervised flow loss.

Port of kd_pointcloud_tpu/losses/multiscale.py (reference multiScaleLoss,
loss_functions.py:6-25). Ground-truth flow is downsampled through the
model's FPS index chain, then per-level L2 norms are summed over points,
averaged over the batch, and alpha-weighted. Channels-last: predicted flows
and ground truth are (B, N, 3).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops import gather_points

ALPHA = (0.02, 0.04, 0.08, 0.16)
SCALE = 1.0


def safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """sqrt(max(sum x^2, 1e-20)): the L2 norm with a finite gradient (0) at
    x = 0, as the JAX package's; torch.linalg.norm's gradient there differs.
    The forward differs from the exact norm by at most 1e-10."""
    return torch.sqrt(torch.clamp((x * x).sum(dim), min=1e-20))


def downsample_gt(gt_flow: torch.Tensor, fps_idxs: Sequence[torch.Tensor],
                  scale: float = SCALE):
    """Ground-truth flow pyramid via the FPS index chain."""
    gt_flows = [gt_flow]
    for idx in fps_idxs:
        gt_flows.append(gather_points(gt_flows[-1], idx) / scale)
    return gt_flows


def multi_scale_loss(pred_flows, gt_flow, fps_idxs,
                     alpha: Sequence[float] = ALPHA) -> torch.Tensor:
    """sum_l alpha[l] * mean_B sum_N ||pred_l - gt_l||_2."""
    return multi_scale_loss_per_sample(pred_flows, gt_flow, fps_idxs,
                                       alpha).mean()


def multi_scale_loss_per_sample(pred_flows, gt_flow, fps_idxs,
                                alpha: Sequence[float] = ALPHA
                                ) -> torch.Tensor:
    """Per-sample (B,) multi_scale_loss; its batch mean is the loss, and
    eval loops weight uneven or padded batches with it.

    A level's entry may be a list of per-iteration flows (iterative
    teachers); each scores fully against that level's ground truth with
    that level's alpha."""
    num_scale = len(pred_flows)
    offset = len(fps_idxs) - num_scale + 1
    gt_flows = downsample_gt(gt_flow, fps_idxs)

    first = pred_flows[0]
    first = first[0] if isinstance(first, (list, tuple)) else first
    total = torch.zeros(first.shape[0], dtype=torch.float32,
                        device=first.device)
    for i in range(num_scale):
        entry = pred_flows[i]
        flows_i = entry if isinstance(entry, (list, tuple)) else [entry]
        for f in flows_i:
            l2 = safe_norm(f - gt_flows[i + offset])          # (B, N)
            total = total + alpha[i] * l2.sum(dim=1)
    return total
