"""Morton-order (Z-curve) block kNN: a locality-restricted neighbour search.

Port of attic/morton.py, a kept negative result of the JAX package: both
clouds are sorted along one Morton curve, and each block of ``block``
consecutive sorted queries scores only the ``window`` consecutive sorted
keys centred on its median code (found by searchsorted), so the distance
and selection work shrinks from N2 keys a query to ``window``. A true
neighbour is missed when it lies outside its block's window; on seeded
normal clouds the recall at k = 16, window 256, block 128, 1024^2 is far
below the exact search's, which is why no path of either package runs it.

Plain torch on the inputs' device, no kernel (the JAX module has no Pallas
kernel either). Codes are int64 here (uint32 in JAX: the same values).
Distances use the JAX module's |q|^2 - 2 q.x + |x|^2 expansion; selection
within a window is exact (the JAX module's approx_min_k is exact on the
CPU): the k smallest distances in ascending order, ties to the lower
window position.
"""

from __future__ import annotations

import torch


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so that consecutive bits land 3 apart."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(xyz: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
                 ) -> torch.Tensor:
    """30-bit Morton codes (int64) of (B, N, 3) points quantized to the box
    [lo, hi] ((B, 1, 3) each): query and key clouds must share the box, or
    their codes are not comparable."""
    # a rounded division, as XLA's (a Python number over a tensor is taken
    # as a reciprocal times the number, another rounding)
    scale = torch.full_like(hi, 1023.0) / torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp((xyz - lo) * scale, 0.0, 1023.0).to(torch.int64)
    return (_part1by2(q[..., 0]) | (_part1by2(q[..., 1]) << 1)
            | (_part1by2(q[..., 2]) << 2))


def joint_bounds(query: torch.Tensor, xyz: torch.Tensor):
    """The (B, 1, 3) corners of the box around both clouds."""
    both = torch.cat([query, xyz], dim=1)
    return both.amin(dim=1, keepdim=True), both.amax(dim=1, keepdim=True)


def window_starts(code_q: torch.Tensor, code_k: torch.Tensor, window: int,
                  block: int) -> torch.Tensor:
    """(B, S / block) first sorted-key position of each query block's
    window: its median code located among the sorted key codes, clamped so
    that the window stays inside the N2 keys."""
    cq = code_q.sort(dim=1, stable=True).values
    ck = code_k.sort(dim=1, stable=True).values
    pos = torch.searchsorted(ck, cq[:, block // 2::block].contiguous())
    return torch.clamp(pos - window // 2, 0, code_k.shape[1] - window)


def knn_block_dist(k: int, xyz: torch.Tensor, query: torch.Tensor, *,
                   window: int = 1024, block: int = 256):
    """Morton-block kNN: (squared distances (B, S, k), indices (B, S, k)
    int32 into the original key order). xyz (B, N2, 3) keys, query
    (B, S, 3), float32 on one device; S % block == 0 and k <= window <= N2
    (callers use the dense kNN otherwise)."""
    B, S, _ = query.shape
    N2 = xyz.shape[1]
    if xyz.device != query.device:
        raise ValueError(f"keys on {xyz.device}, queries on {query.device}")
    if S % block or not k <= window <= N2:
        raise ValueError(f"knn_block_dist takes S % block == 0 and k <= "
                         f"window <= N2, got S={S}, block={block}, k={k}, "
                         f"window={window}, N2={N2}")
    nb = S // block
    lo, hi = joint_bounds(query, xyz)
    code_q = morton_codes(query, lo, hi)                  # (B, S)
    code_k = morton_codes(xyz, lo, hi)                    # (B, N2)
    perm_q = torch.argsort(code_q, dim=1, stable=True)
    perm_k = torch.argsort(code_k, dim=1, stable=True)
    q_sorted = torch.gather(query, 1, perm_q[..., None].expand(B, S, 3))
    k_sorted = torch.gather(xyz, 1, perm_k[..., None].expand(B, N2, 3))
    start = window_starts(code_q, code_k, window, block)  # (B, nb)

    widx = start[..., None] + torch.arange(window, device=xyz.device)
    kwin = torch.gather(k_sorted, 1, widx.reshape(B, nb * window, 1).expand(
        B, nb * window, 3)).reshape(B, nb, window, 3)
    qb = q_sorted.reshape(B, nb, block, 3)
    # d[q, j] = |q|^2 - 2 q.x + |x|^2, the JAX module's expansion
    cross = torch.einsum("bnqc,bnwc->bnqw", qb, kwin)
    d = ((qb * qb).sum(-1)[..., None] - 2.0 * cross
         + (kwin * kwin).sum(-1)[:, :, None, :])          # (B, nb, block, W)
    dist, local = d.sort(dim=-1, stable=True)
    dist = dist[..., :k].reshape(B, S, k)
    sorted_pos = (local[..., :k] + start[:, :, None, None]).reshape(B, S * k)
    idx = torch.gather(perm_k, 1, sorted_pos).reshape(B, S, k).to(torch.int32)
    # back to the caller's query order
    inv_q = torch.argsort(perm_q, dim=1)
    dist = torch.gather(dist, 1, inv_q[..., None].expand(B, S, k))
    idx = torch.gather(idx, 1, inv_q[..., None].expand(B, S, k))
    return dist, idx
