"""Cost-volume pool: out[b, n] = max_k leaky(leaky(u[b, idx[b, n, k]] +
v[b, n]) @ W^T + bias), forward.

Port of kd_pointcloud_tpu/ops/pallas/pool_fused.py pool_mlp_max for the
single-layer MLP every cross layer builds. ``pool_plain`` is the plain
version (the math of ``_pool_ref``); the CUDA kernel is csrc/pool_fused.cu,
which gathers the rows of the key table u itself, so the grouped
(B, N, K, C) tensor never reaches device memory. The TPU's k-major layout and
lane packing are not ported.

The kernel has no backward yet: a CUDA call whose result needs a gradient
raises in backward instead of silently taking another path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels
from .gather import group_points

KERNEL_C = (32, 64, 128, 256)
LEAKY_RATE = 0.1


def pool_plain(u: torch.Tensor, idx: torch.Tensor, v: torch.Tensor,
               weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """u (B, N2, C), idx (B, N1, K), v (B, N1, C), weight (C, C) in
    (out, in) layout, bias (C,) -> (B, N1, C)."""
    h = F.leaky_relu(group_points(u, idx) + v[:, :, None, :], LEAKY_RATE)
    h = F.leaky_relu(F.linear(h, weight, bias), LEAKY_RATE)
    return h.amax(dim=2)


def _check(u, idx, v, weight, bias) -> None:
    for name, t, dtype, ndim in (("u", u, torch.float32, 3),
                                 ("idx", idx, torch.int32, 3),
                                 ("v", v, torch.float32, 3),
                                 ("weight", weight, torch.float32, 2),
                                 ("bias", bias, torch.float32, 1)):
        kernels.check_tensor(f"pool {name}", t, dtype, ndim)
    B, _, C = u.shape
    _, N1, K = idx.shape
    if (idx.shape[0] != B or v.shape != (B, N1, C) or K < 1
            or weight.shape != (C, C) or bias.shape != (C,)):
        raise ValueError(
            f"pool takes matching shapes; got u {tuple(u.shape)}, idx "
            f"{tuple(idx.shape)}, v {tuple(v.shape)}, weight "
            f"{tuple(weight.shape)}, bias {tuple(bias.shape)}")


def _pool_cuda(u, idx, v, weight, bias):
    _check(u, idx, v, weight, bias)
    kernels.check_on_card("pool", u, idx, v, weight, bias)
    B, N2, C = u.shape
    _, N1, K = idx.shape
    if C not in KERNEL_C:
        raise ValueError(f"pool kernel takes C in {KERNEL_C}, got {C}")
    out = torch.empty(B, N1, C, dtype=torch.float32, device=u.device)
    kernels.launch("pool", u.data_ptr(), idx.data_ptr(), v.data_ptr(),
                   weight.data_ptr(), bias.data_ptr(), B, N1, N2, K, C,
                   out.data_ptr())
    return out


class _PoolFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, idx, v, weight, bias):
        return _pool_cuda(u, idx, v, weight, bias)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the cost-volume pool kernel has no backward yet; it comes with "
            "the teacher train-step slice")


def pool_mlp_max(u: torch.Tensor, idx: torch.Tensor, v: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Fused cost-volume pool; see the module docstring for the math.

    A CUDA tensor goes through the kernel, a CPU tensor through the plain
    version."""
    _check(u, idx, v, weight, bias)
    if u.device.type == "cuda":
        return _PoolFunction.apply(u, idx, v, weight, bias)
    if u.device.type == "cpu":
        return pool_plain(u, idx, v, weight, bias)
    raise ValueError(f"no pool for device {u.device}")
