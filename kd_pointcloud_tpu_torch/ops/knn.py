"""Exact k-nearest-neighbour search over point clouds.

Port of the exact path of kd_pointcloud_tpu/ops/knn.py (knn_point /
knn_point_dist with method="exact"). ``knn_plain`` is the plain version: a
stable sort of the square_distance expansion, in query chunks of 2048 as
the JAX package chunks it. The CUDA kernel is csrc/knn.cu: one thread per
query and a sorted register list, ranking keys by the same expansion. Both
break ties toward the lower key index, as lax.top_k does; torch.topk
promises no tie order, and at metric scale (|x|^2 ~ 1e3, so the expansion
moves in steps of ~6e-5) equal distances among near neighbours are common.

The TPU's approximate selection (lax.approx_min_k and the fused kernel's
float-float mode) is not reproduced: the port's search is exact.
"""

from __future__ import annotations

import torch

from . import kernels
from .distance import square_distance

KERNEL_K = (3, 9, 16, 32)
_CHUNK = 2048


def knn_plain(k: int, xyz: torch.Tensor, query: torch.Tensor):
    """(d2, idx): (B, S, k) float32 expansion distances, ascending, and
    int32 indices into xyz."""
    ds, idxs = [], []
    for q in torch.split(query, _CHUNK, dim=1):
        d, i = torch.sort(square_distance(q, xyz), dim=-1, stable=True)
        ds.append(d[..., :k])
        idxs.append(i[..., :k].int())
    return torch.cat(ds, dim=1), torch.cat(idxs, dim=1)


def _check(k: int, xyz: torch.Tensor, query: torch.Tensor) -> None:
    kernels.check_tensor("knn keys", xyz, torch.float32, 3)
    kernels.check_tensor("knn query", query, torch.float32, 3)
    if (xyz.shape[2] != 3 or query.shape[2] != 3
            or query.shape[0] != xyz.shape[0] or not 0 < k <= xyz.shape[1]):
        raise ValueError(f"knn takes 3-D points, equal batches and "
                         f"0 < k <= N; got keys {tuple(xyz.shape)}, queries "
                         f"{tuple(query.shape)}, k={k}")


def _knn_cuda(k: int, xyz: torch.Tensor, query: torch.Tensor):
    _check(k, xyz, query)
    kernels.check_on_card("knn", xyz, query)
    if k not in KERNEL_K:
        raise ValueError(f"knn kernel takes k in {KERNEL_K}, got {k}")
    B, N, _ = xyz.shape
    S = query.shape[1]
    idx = torch.empty(B, S, k, dtype=torch.int32, device=xyz.device)
    d2 = torch.empty(B, S, k, dtype=torch.float32, device=xyz.device)
    kernels.launch("knn", query.data_ptr(), xyz.data_ptr(), B, S, N, k,
                   idx.data_ptr(), d2.data_ptr())
    return d2, idx


def knn_point_dist(k: int, xyz: torch.Tensor, query: torch.Tensor):
    """k nearest points of xyz (B, N, 3) around each query (B, S, 3).

    Returns (d2, idx), each (B, S, k), sorted by ascending d2: the selection
    distances (the expansion, like the JAX exact path) and int32 indices.
    A CUDA tensor goes through the kernel, a CPU tensor through the plain
    version."""
    _check(k, xyz, query)
    if xyz.device.type == "cuda":
        return _knn_cuda(k, xyz, query)
    if xyz.device.type == "cpu":
        return knn_plain(k, xyz, query)
    raise ValueError(f"no kNN for device {xyz.device}")


def knn_point(k: int, xyz: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Indices (B, S, k) int32 of the k nearest points; see knn_point_dist."""
    return knn_point_dist(k, xyz, query)[1]
