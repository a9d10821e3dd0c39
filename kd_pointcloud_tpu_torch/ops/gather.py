"""Index-gather primitives over point clouds, forward only.

Port of kd_pointcloud_tpu/ops/gather.py gather_points / group_points. Indices
come from FPS and kNN and are in range by construction; the JAX package
clamps them on its hot path. Here an out-of-range index raises (index_select
checks it on the CPU; on the card it is a device-side assertion).
"""

from __future__ import annotations

import torch


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather per-point rows: (B, N, C) x (B, S) -> (B, S, C)."""
    B, N, C = points.shape
    flat = idx.long() + torch.arange(B, device=idx.device)[:, None] * N
    return points.reshape(B * N, C).index_select(0, flat.reshape(-1)).reshape(
        B, idx.shape[1], C)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather neighbourhoods: (B, N, C) x (B, S, K) -> (B, S, K, C)."""
    B, S, K = idx.shape
    return gather_points(points, idx.reshape(B, S * K)).reshape(
        B, S, K, points.shape[-1])
