"""Cost-volume pool with an L-layer MLP and the gather fused in.

Port of attic/cross_pool.py cross_pool_fused (a kept negative result: the
TPU could not gather rows inside a Pallas kernel, so it ran in interpret
mode only):

    out[b, n] = max_k mlp_L(leaky(u[b, idx[b, n, k]] + v[b, n]))

with mlp_L = L >= 1 layers h -> leaky(h W^T + bias), each W (C, C). At
L = 1 it is ops/pool_fused.py pool_mlp_max's function, and its kernel
(csrc/cross_pool.cu) keeps that kernel's operation order, so the two agree
bit for bit; L > 1 is what it adds. Weights are in the port's (out, in)
layout, as pool_mlp_max's (the JAX function takes (in, out)). u (B, N2, C)
and v (B, N1, C) float32, idx (B, N1, K) int32; the JAX function's N1 ==
N2 restriction (its gather's) does not apply. Forward only, as the JAX
function: inputs that need a gradient are refused.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..ops import kernels
from ..ops.gather import group_points
from ..ops.pool_fused import leaky

# the widths csrc/cross_pool.cu instantiates
KERNEL_C = (32, 64, 128, 256)


@kernels.plain("cross_pool")
def cross_pool_plain(u, v, idx, weights: Sequence[torch.Tensor],
                     biases: Sequence[torch.Tensor]) -> torch.Tensor:
    h = leaky(group_points(u, idx) + v[:, :, None, :])
    for w, b in zip(weights, biases):
        h = leaky(F.linear(h, w, b))
    return h.amax(dim=2)


def _check(u, v, idx, weights, biases) -> None:
    for name, t, dtype, ndim in (("u", u, torch.float32, 3),
                                 ("v", v, torch.float32, 3),
                                 ("idx", idx, torch.int32, 3)):
        kernels.check_tensor(f"cross_pool {name}", t, dtype, ndim)
    B, _, C = u.shape
    _, N1, K = idx.shape
    if (idx.shape[0] != B or v.shape != (B, N1, C) or K < 1
            or len(weights) < 1 or len(weights) != len(biases)
            or any(tuple(w.shape) != (C, C) for w in weights)
            or any(tuple(b.shape) != (C,) for b in biases)):
        raise ValueError(
            f"cross_pool takes u (B, N2, C), v (B, N1, C), idx (B, N1, K) "
            f"and L >= 1 weights (C, C) with biases (C,); got u "
            f"{tuple(u.shape)}, v {tuple(v.shape)}, idx {tuple(idx.shape)}, "
            f"weights {[tuple(w.shape) for w in weights]}, biases "
            f"{[tuple(b.shape) for b in biases]}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, v, *weights, *biases)):
        raise RuntimeError("cross_pool is forward only (no gradient), as "
                           "the JAX function")


def _cross_pool_cuda(u, v, idx, weights, biases):
    _check(u, v, idx, weights, biases)
    B, N2, C = u.shape
    _, N1, K = idx.shape
    if C not in KERNEL_C:
        raise ValueError(f"cross_pool kernel takes C in {KERNEL_C}, got {C}")
    # (L, C_in, C_out) and (L, C): each layer's weights transposed
    wt = torch.stack([w.t() for w in weights]).float().contiguous()
    bias = torch.stack(list(biases)).float().contiguous()
    kernels.check_on_card("cross_pool", u, v, idx, wt, bias)
    out = torch.empty(B, N1, C, dtype=torch.float32, device=u.device)
    kernels.launch("cross_pool", u.data_ptr(), idx.data_ptr(), v.data_ptr(),
                   wt.data_ptr(), bias.data_ptr(), B, N1, N2, K, C,
                   len(weights), out.data_ptr())
    kernels.report("cross_pool", u, v, idx, weights, biases)
    return out


def cross_pool_fused(u: torch.Tensor, v: torch.Tensor, idx: torch.Tensor,
                     weights: Sequence[torch.Tensor],
                     biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """max over K of mlp(leaky(u[idx] + v)): (B, N1, C). A CUDA tensor
    goes through the kernel, a CPU tensor through the plain version."""
    _check(u, v, idx, weights, biases)
    if u.device.type == "cuda":
        return _cross_pool_cuda(u, v, idx, weights, biases)
    if u.device.type == "cpu":
        return cross_pool_plain(u, v, idx, weights, biases)
    raise ValueError(f"no cross_pool for device {u.device}")
