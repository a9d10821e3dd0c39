"""Cost-volume pool: out[b, n] = max_k leaky(leaky(u[b, idx[b, n, k]] +
v[b, n]) @ W^T + bias), forward and backward.

Port of kd_pointcloud_tpu/ops/pallas/pool_fused.py pool_mlp_max for the
single-layer MLP every cross layer builds. ``pool_plain`` is the plain
version (the math of ``_pool_ref``), and its autograd is the plain version
of the backward; ``pool_tiled`` walks the forward as the forward kernel
does (``pool_shape`` gives its tiles), and ``pool_bwd_masked`` forms the
backward from the max mask as the backward kernels do. The CUDA kernels are
csrc/pool_fused.cu (forward) and csrc/pool_fused_bwd.cu (backward, as the
JAX package's custom VJP): both
gather the rows of the key table u themselves, so the grouped (B, N, K, C)
tensor never reaches device memory, and the backward recomputes the
activations instead of saving them. The TPU's k-major layout and lane
packing are not ported.

``leaky`` is jax.nn.leaky_relu's: slope 1 at exactly 0, as the JAX kernel's
``_leaky`` (F.leaky_relu's gradient there is 0.1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels
from .gather import group_points

KERNEL_C = (32, 64, 128, 256)
KERNEL_BWD_K = 32     # the backward kernel's neighbour slots a query
POOL_SLOTS = 32       # the forward kernel's neighbour slots a pass
POOL_THREADS = 256    # the forward kernel's threads a block
LEAKY_RATE = 0.1


class _Leaky(torch.autograd.Function):
    """F.leaky_relu's forward (one kernel) with jax.nn.leaky_relu's
    gradient, where(x >= 0, g, 0.1 g)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.leaky_relu(x, LEAKY_RATE)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, LEAKY_RATE * g)


def leaky(x: torch.Tensor) -> torch.Tensor:
    """leaky_relu(x, 0.1) with JAX's gradient 1 at x == 0; without autograd
    it is F.leaky_relu itself."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Leaky.apply(x)
    return F.leaky_relu(x, LEAKY_RATE)


def pool_plain(u: torch.Tensor, idx: torch.Tensor, v: torch.Tensor,
               weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """u (B, N2, C), idx (B, N1, K), v (B, N1, C), weight (C, C) in
    (out, in) layout, bias (C,) -> (B, N1, C)."""
    h = leaky(group_points(u, idx) + v[:, :, None, :])
    return leaky(F.linear(h, weight, bias)).amax(dim=2)


def pool_shape(C: int) -> dict:
    """The forward kernel's tiles at width C (csrc/pool_fused.cu Shape<C>):
    a thread of 256 holds 8 slots x 8 output channels; ``queries`` a pass
    (all C output channels of POOL_SLOTS slots each), w resident or
    streamed in tiles of ``i_tile`` input channels through two buffers,
    the dynamic shared memory a block asks for (h0, w and the pass's
    neighbour indices), and the blocks an SM its launch bounds aim at (two
    at C <= 64; one with up to 255 registers above)."""
    cg = min(C // 8, 8)                  # channel lanes of a warp
    qw = 32 // (4 * cg)                  # queries a warp
    warps_q = C // (8 * cg)              # warps a query
    queries = POOL_THREADS // 32 * qw // warps_q
    rows = queries * POOL_SLOTS
    tiled = C > 64
    i_tile = 16 if C == 256 else (32 if tiled else C)
    bufs = 2 if tiled else 1
    smem = 4 * (rows * (C + 4) + bufs * C * (i_tile + 4) + rows)
    return dict(queries=queries, rows=rows, w_tiled=tiled, i_tile=i_tile,
                smem_bytes=smem, blocks_sm=1 if tiled else 2)


def pool_tiled(u: torch.Tensor, idx: torch.Tensor, v: torch.Tensor,
               weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The forward kernel's walk in torch, for the tests: passes of
    pool_shape(C)["queries"] queries of one cloud x POOL_SLOTS slots (K in
    chunks of POOL_SLOTS; a slot past K or a query past N1 is a zero row,
    left out of the max), h0 = leaky(u[idx] + v) formed once a row, p
    summed over i-tiles of ``i_tile`` input channels in ascending order,
    + bias, leaky, and the running max over the chunks. Same shapes as
    pool_plain, which it equals to float32 rounding (other summation
    order)."""
    B, _, C = u.shape
    _, N1, K = idx.shape
    shape = pool_shape(C)
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
                    acc = torch.zeros(QP, POOL_SLOTS, C, dtype=u.dtype)
                    for i0 in range(0, C, IT):
                        acc = acc + h[..., i0:i0 + IT] @ weight[:, i0:i0 + IT].T
                    val = F.leaky_relu(acc + bias, LEAKY_RATE)
                    val = torch.where(ok[..., None], val, float("-inf"))
                    best = torch.maximum(best, val.amax(dim=1))
                out[b, q0:q0 + nq] = best[:nq]
    return out


def pool_bwd_masked(u: torch.Tensor, idx: torch.Tensor, v: torch.Tensor,
                    weight: torch.Tensor, bias: torch.Tensor,
                    ct: torch.Tensor):
    """(d_u, d_v, d_weight, d_bias) of pool_plain for the cotangent ct,
    formed as the backward kernels form them, for the tests: the max mask
    by == on the recomputed leaky(p), the cotangent split evenly among its
    tied slots, and d_p used only at the mask's (query, slot, output
    channel) entries -- d_h0 adds, for each entry in ascending output
    channel, d_p times that channel's row of w into the slot's row (C^2 a
    query, not the dense 2 K C^2), d_w adds d_p times the slot's h0 into
    the channel's row, d_bias adds d_p."""
    B, N2, C = u.shape
    _, N1, K = idx.shape
    with torch.no_grad():
        pre_h = group_points(u, idx) + v[:, :, None, :]      # (B, N1, K, C)
        h0 = F.leaky_relu(pre_h, LEAKY_RATE)
        pre_p = F.linear(h0, weight, bias)
        val = F.leaky_relu(pre_p, LEAKY_RATE)
        hit = val == val.amax(dim=2, keepdim=True)
        share = ct / hit.sum(dim=2)                          # (B, N1, C)
        d_p = torch.where(pre_p >= 0, share[:, :, None, :],
                          LEAKY_RATE * share[:, :, None, :])
        b, n, s, o = hit.nonzero(as_tuple=True)   # (b, n, s) rows, o last
        g = d_p[b, n, s, o]
        rows = (b * N1 + n) * K + s
        d_h0 = torch.zeros(B * N1 * K, C, dtype=u.dtype).index_add_(
            0, rows, g[:, None] * weight[o])
        d_g = d_h0.view(B, N1, K, C) * torch.where(pre_h >= 0, 1.0,
                                                   LEAKY_RATE)
        d_v = d_g.sum(dim=2)
        d_u = torch.zeros(B * N2, C, dtype=u.dtype).index_add_(
            0, (idx.long() + N2 * torch.arange(B)[:, None, None]).view(-1),
            d_g.reshape(-1, C)).view(B, N2, C)
        d_w = torch.zeros(C, C, dtype=u.dtype).index_add_(
            0, o, g[:, None] * h0[b, n, s])
        d_b = torch.zeros(C, dtype=u.dtype).index_add_(0, o, g)
    return d_u, d_v, d_w, d_b


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
    if u.data_ptr() % 16 or v.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("pool kernel reads u, v and weight as float4: "
                         "their data must be 16-byte aligned")
    out = torch.empty(B, N1, C, dtype=torch.float32, device=u.device)
    kernels.launch("pool", u.data_ptr(), idx.data_ptr(), v.data_ptr(),
                   weight.data_ptr(), bias.data_ptr(), B, N1, N2, K, C,
                   out.data_ptr())
    return out


def _pool_bwd_cuda(u, idx, v, weight, bias, ct, need=(True,) * 4):
    """(d_u, d_v, d_weight, d_bias) of pool_plain at these inputs for the
    cotangent ct (B, N1, C), by the backward kernel; an entry whose flag in
    need is False comes back None. d_u, d_weight and d_bias are sums of
    float atomics: equal to the plain version's up to float32 rounding in
    another order of summation."""
    _check(u, idx, v, weight, bias)
    kernels.check_tensor("pool_bwd ct", ct, torch.float32, 3)
    kernels.check_on_card("pool_bwd", u, idx, v, weight, bias, ct)
    B, N2, C = u.shape
    _, N1, K = idx.shape
    if C not in KERNEL_C or K > KERNEL_BWD_K or ct.shape != v.shape:
        raise ValueError(f"pool backward kernel takes C in {KERNEL_C}, "
                         f"K <= {KERNEL_BWD_K} and ct shaped like v; got "
                         f"C={C}, K={K}, ct {tuple(ct.shape)}")
    if u.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("pool backward kernel reads u and v as float4: "
                         "their data must be 16-byte aligned")
    need_u, need_v, need_w, need_b = need
    f32 = dict(dtype=torch.float32, device=u.device)
    i32 = dict(dtype=torch.int32, device=u.device)
    d_u = torch.zeros(B, N2, C, **f32) if need_u else None
    d_v = torch.empty(B, N1, C, **f32) if need_v else None
    want_wb = need_w or need_b
    d_w = torch.zeros(C, C, **f32) if want_wb else None
    d_b = torch.zeros(C, **f32) if want_wb else None
    # per (query, output channel) the max mask's slot bits, their p < 0
    # bits and the cotangent's share; per (query, slot) the sign bits of
    # h0's pre-activation, 32 channels a word
    sel = torch.empty(B, N1, C, 2, **i32)
    share = torch.empty(B, N1, C, **f32)
    hsign = torch.empty(B, N1, C, **i32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    kernels.launch("pool_bwd", u.data_ptr(), idx.data_ptr(), v.data_ptr(),
                   weight.data_ptr(), bias.data_ptr(), ct.data_ptr(), B, N1,
                   N2, K, C, ptr(d_u), ptr(d_v), ptr(d_w), ptr(d_b),
                   sel.data_ptr(), share.data_ptr(), hsign.data_ptr())
    return (d_u, d_v, d_w if need_w else None, d_b if need_b else None)


class _PoolFunction(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, u, idx, v, weight, bias):
        ctx.save_for_backward(u, idx, v, weight, bias)
        return _pool_cuda(u, idx, v, weight, bias)

    @staticmethod
    def backward(ctx, grad_out):
        u, idx, v, weight, bias = ctx.saved_tensors
        nu, _, nv, nw, nb = ctx.needs_input_grad
        # autograd may hand over a view (a slice or a cat's part); the
        # kernel takes contiguous rows
        d_u, d_v, d_w, d_b = _pool_bwd_cuda(
            u, idx, v, weight, bias, grad_out.contiguous(),
            need=(nu, nv, nw, nb))
        return d_u, None, d_v, d_w, d_b


def _pool_card(u, idx, v, weight, bias):
    """The pool on the card: forward kernel, backward kernel."""
    return _PoolFunction.apply(u, idx, v, weight, bias)


def pool_mlp_max(u: torch.Tensor, idx: torch.Tensor, v: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Fused cost-volume pool; see the module docstring for the math.

    A CUDA tensor goes through the kernels, a CPU tensor through the plain
    version."""
    _check(u, idx, v, weight, bias)
    if u.device.type == "cuda":
        return _pool_card(u, idx, v, weight, bias)
    if u.device.type == "cpu":
        return pool_plain(u, idx, v, weight, bias)
    raise ValueError(f"no pool for device {u.device}")
