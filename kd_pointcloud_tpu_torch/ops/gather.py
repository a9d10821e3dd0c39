"""Index-gather primitives over point clouds, forward only.

Port of kd_pointcloud_tpu/ops/gather.py gather_points / group_points, and
the JAX package's k-major layout helpers group_points_kmajor and
group_points_kmajor_packed (its pool kernel's input layouts; the port's
pool gathers inside the kernel and does not use them). Indices
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


def group_points_kmajor(points: torch.Tensor, idx: torch.Tensor
                        ) -> torch.Tensor:
    """Gather neighbourhoods k-major: (B, N, C) x (B, S, K) -> (B, K, S, C)."""
    B, S, K = idx.shape
    flat = gather_points(points, idx.transpose(1, 2).reshape(B, K * S))
    return flat.reshape(B, K, S, points.shape[-1])


def group_points_kmajor_packed(points: torch.Tensor, idx: torch.Tensor,
                               pack: int) -> torch.Tensor:
    """K-major gather with ``pack`` consecutive queries a row: (B, N, C) x
    (B, S, K) -> (B, K, S / pack, pack C); row q holds queries q pack ..
    q pack + pack - 1 side by side."""
    B, S, K = idx.shape
    C = points.shape[-1]
    idx_t = idx.transpose(1, 2)
    return torch.cat([
        gather_points(points, idx_t[:, :, p::pack].reshape(B, K * (S // pack)))
        .reshape(B, K, S // pack, C) for p in range(pack)], dim=-1)
