"""Furthest-point sampling.

Port of kd_pointcloud_tpu/ops/fps.py. ``fps_plain`` is the plain version,
the port of ``_furthest_point_sample_xla``; the CUDA kernel is csrc/fps.cu.
Both seed at index 0 and take, each round, the argmax of the running minimum
squared distance with a first-index tie-break, and both select bit-identical
indices. FPS has no gradient.
"""

from __future__ import annotations

import torch

from . import kernels


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, npoint) int32, one torch op chain a round."""
    B, N, _ = xyz.shape
    xyz = xyz.float()
    idxs = torch.zeros(B, npoint, dtype=torch.int32, device=xyz.device)
    temp = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = xyz[:, 0, :]
    for j in range(1, npoint):
        diff = xyz - last[:, None, :]
        d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
             + diff[..., 2] * diff[..., 2])
        temp = torch.minimum(temp, d)
        far = torch.argmax(temp, dim=-1)            # first maximum
        idxs[:, j] = far.int()
        last = xyz[rows, far]
    return idxs


def _check(xyz: torch.Tensor, npoint: int) -> None:
    kernels.check_tensor("fps xyz", xyz, torch.float32, 3)
    if xyz.shape[2] != 3 or not 0 < npoint <= xyz.shape[1]:
        raise ValueError(f"fps takes (B, N, 3) and 0 < npoint <= N, got "
                         f"{tuple(xyz.shape)}, {npoint}")


def _fps_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    _check(xyz, npoint)
    kernels.check_on_card("fps", xyz)
    B, N, _ = xyz.shape
    if N > 32 * 1024:
        raise ValueError(f"fps kernel takes N <= 32768, got {N}")
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    kernels.launch("fps", xyz.data_ptr(), B, N, npoint, out.data_ptr())
    return out


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative furthest-point sampling: (B, N, 3) -> (B, npoint) int32.

    A CUDA tensor goes through the kernel, a CPU tensor through the plain
    version."""
    _check(xyz, npoint)
    if xyz.device.type == "cuda":
        return _fps_cuda(xyz, npoint)
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint)
    raise ValueError(f"no FPS for device {xyz.device}")
