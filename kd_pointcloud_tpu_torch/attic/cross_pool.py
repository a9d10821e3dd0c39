"""Cost-volume pool with an L-layer MLP and the gather fused in.

Port of attic/cross_pool.py cross_pool_fused (a kept negative result: the
TPU could not gather rows inside a Pallas kernel, so it ran in interpret
mode only):

    out[b, n] = max_k mlp_L(leaky(u[b, idx[b, n, k]] + v[b, n]))

with mlp_L = L >= 1 layers h -> leaky(h W^T + bias), each W (C, C). At
L = 1 it is ops/pool_fused.py pool_mlp_max's function, and its kernel
(csrc/cross_pool.cu) keeps that kernel's operation order, so the two agree
bit for bit; L > 1 is what it adds. ``cross_pool_tiled`` is the kernel's
walk in torch (its passes, i-tiles and layers written back over their
rows), for the tests, as ops/pool_fused.py pool_tiled is the pool
kernel's. Weights are in the port's (out, in) layout, as pool_mlp_max's
(the JAX function takes (in, out)). u (B, N2, C) and v (B, N1, C)
float32, idx (B, N1, K) int32, C in the pool kernel's widths (16-256) on
the card; the JAX function's N1 == N2 restriction (its gather's) does not
apply. Forward only, as the JAX function: inputs that need a gradient are
refused.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..ops import kernels
from ..ops.gather import group_points
from ..ops.pool_fused import (KERNEL_C, LEAKY_RATE, POOL_SLOTS, leaky,
                              pool_shape)

# dynamic shared memory a block may use on an H100
MAX_SMEM = 227 * 1024


@kernels.plain("cross_pool")
def cross_pool_plain(u, v, idx, weights: Sequence[torch.Tensor],
                     biases: Sequence[torch.Tensor]) -> torch.Tensor:
    h = leaky(group_points(u, idx) + v[:, :, None, :])
    for w, b in zip(weights, biases):
        h = leaky(F.linear(h, w, b))
    return h.amax(dim=2)


def cross_pool_shape(C: int, n_layers: int) -> dict:
    """The kernel's tiles at width C and L layers (csrc/cross_pool.cu
    Shape<C, kStream>): the pool kernel's passes (``queries`` x POOL_SLOTS
    rows, all C channels), the L weights resident in shared memory where
    they fit beside the rows (``resident``), else streamed in tiles of
    ``i_tile`` input channels (a whole layer at C <= 64) through two
    buffers; and the dynamic shared memory a block asks for (its launch
    bounds aim at one block an SM, for up to 255 registers a thread)."""
    base = pool_shape(C)
    rows = base["rows"]
    i_tile = 16 if C == 256 else (32 if C > 64 else C)
    floats = rows * (C + 4) + rows
    resident = C <= 64 and 4 * (floats + n_layers * C * C) <= MAX_SMEM
    w = n_layers * C * C if resident else 2 * i_tile * C
    return dict(queries=base["queries"], rows=rows, resident=resident,
                i_tile=C if resident else i_tile,
                smem_bytes=4 * (floats + w))


def cross_pool_tiled(u, v, idx, weights: Sequence[torch.Tensor],
                     biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """The kernel's walk in torch, for the tests: passes of
    cross_pool_shape's ``queries`` queries of one cloud x POOL_SLOTS slots
    (K in chunks of POOL_SLOTS; a slot past K or a query past N1 is a zero
    row, left out of the max), h_0 = leaky(u[idx] + v) formed once a row,
    each layer summed over i-tiles in ascending order, + bias, leaky, each
    layer but the last written over the rows it read, the last folded into
    the running max. At L = 1 it is ops/pool_fused.py pool_tiled, op for
    op; it equals cross_pool_plain to float32 rounding (other summation
    order)."""
    B, _, C = u.shape
    _, N1, K = idx.shape
    L = len(weights)
    shape = cross_pool_shape(C, L)
    QP, IT = shape["queries"], shape["i_tile"]
    q = torch.arange(QP)[:, None]
    out = torch.empty(B, N1, C, dtype=u.dtype)
    with torch.no_grad():
        for b in range(B):
            for q0 in range(0, N1, QP):
                nq = min(QP, N1 - q0)
                n = (q0 + q).clamp(max=N1 - 1)
                best = torch.full((QP, C), float("-inf"), dtype=u.dtype)
                for k0 in range(0, K, POOL_SLOTS):
                    s = k0 + torch.arange(POOL_SLOTS)[None, :]
                    ok = (q < nq) & (s < K)                   # (QP, slots)
                    ids = torch.where(ok, idx[b, n, s.clamp(max=K - 1)], -1)
                    h = F.leaky_relu(u[b, ids.clamp(min=0)] + v[b, n],
                                     LEAKY_RATE)
                    h = torch.where(ok[..., None], h, 0.0)
                    for w, bias in zip(weights, biases):
                        acc = torch.zeros(QP, POOL_SLOTS, C, dtype=u.dtype)
                        for i0 in range(0, C, IT):
                            acc = acc + h[..., i0:i0 + IT] @ w[:, i0:i0 + IT].T
                        h = F.leaky_relu(acc + bias, LEAKY_RATE)
                    val = torch.where(ok[..., None], h, float("-inf"))
                    best = torch.maximum(best, val.amax(dim=1))
                out[b, q0:q0 + nq] = best[:nq]
    return out


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
    if u.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("cross_pool kernel reads u and v as float4: their "
                         "data must be 16-byte aligned")
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
