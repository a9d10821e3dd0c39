"""Radius-bounded fixed-K neighbour search (the pointnet2 API's ball query).

Port of kd_pointcloud_tpu/ops/ball_query.py. The JAX version is XLA, with no
Pallas kernel, so this is plain PyTorch on every device. Semantics: for
each query, the first k points of ``xyz`` strictly inside the radius in
index order (d2 < r^2 on the square_distance expansion), unfilled slots
repeating the first hit, all zeros for a query with no hit.
"""

from __future__ import annotations

import torch

from .distance import square_distance

_CHUNK = 2048


def ball_query(radius: float, k: int, xyz: torch.Tensor,
               query: torch.Tensor) -> torch.Tensor:
    """(B, S, k) int32 indices of xyz (B, N, 3) around query (B, S, 3).

    Queries go in chunks of 2048, so one (chunk, N) distance matrix is
    alive at a time. r^2 is formed in float32, as the JAX package's jitted
    version forms it from its traced radius."""
    N = xyz.shape[1]
    if not 0 < k <= N:
        raise ValueError(f"ball_query takes 0 < k <= N, got k={k}, N={N}")
    r = torch.tensor(radius, dtype=torch.float32)
    r2 = (r * r).to(xyz.device)
    arange = torch.arange(N, dtype=torch.int32, device=xyz.device)
    out = []
    for q in torch.split(query, _CHUNK, dim=1):
        # in-ball points keyed by their index, the rest by N: the k
        # smallest keys are the first k hits in index order
        key = torch.where(square_distance(q, xyz) < r2, arange,
                          torch.tensor(N, dtype=torch.int32,
                                       device=xyz.device))
        first_k = torch.topk(key, k, dim=-1, largest=False).values
        hit = first_k < N
        idx = torch.where(hit, first_k, first_k[..., :1])
        out.append(torch.where(hit[..., :1], idx, 0))
    return torch.cat(out, dim=1)
