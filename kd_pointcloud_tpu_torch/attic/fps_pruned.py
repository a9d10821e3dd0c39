"""Exact furthest-point sampling with bounding-sphere pruning.

Port of attic/fps_pruned.py furthest_point_sample_pruned (a kept negative
result: on the TPU it was about 2x slower than the unpruned kernel, because
exact FPS is bound by its serial chain of rounds, not by its distance
work). It selects the same indices as ops/fps.py furthest_point_sample,
bit for bit: (B, N, 3) float32 -> (B, npoint) int32, N % 1024 == 0.

``spatial_permutation`` is the JAX package's 2-level equal-count sort in
plain torch ops (XLA ran it outside the Pallas kernel too): each cloud is
sorted along its widest axis into N/1024 slabs, each slab along its own
widest axis into 8 sub-blocks of 128 points, with a bounding sphere per
sub-block, and the sub-blocks are ordered as the JAX package's slots (the 8
fattest first, the rest by centre along the first axis). Within a
sub-block the points are kept in ascending original index, so the first
maximum of a sub-block is its smallest original index.

``fps_pruned_plain`` makes the kernel's decisions in torch: a round
updates the running minima of a sub-block only when dist(c, centre) <
(r + sqrt(bm)) * 1.0001 + 1e-6 (bm: the sub-block's cached max of its
minima), refreshes (bm, first argmax) only there, and takes the argmax over
the cached maxima. A skipped update that was not a no-op would change the
indices, so the CPU tests hold the pruning itself against the JAX kernel
run in interpret mode. The kernel is csrc/fps_pruned.cu: a block of 8
warps a cloud, the cloud split over a cluster of ``fps_pruned_plan``
blocks above 8192 points; ``fps_pruned_split`` is its split and its folds
in torch, for the tests. The TPU kernel's interpret, unroll and restrict_scan options
are TPU mechanics (Pallas's interpreter, loop unrolling, the winner-window
scan) and are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import kernels
from ..ops.fps import _check as _check_fps

SUB = 128              # points a sub-block
SLOP_MUL = 1.0001      # multiplicative slop on the prune threshold
SLOP_ADD = 1e-6        # additive slop (sqrt-space)
MAX_N = 32 * 1024
BLOCK_SUB = 64         # sub-blocks a block of the kernel holds at most
POINT_BYTES = 20       # a point in the kernel's shared memory


class Layout(NamedTuple):
    """A cloud batch in sub-block order: planes (B, 3, N) coordinates,
    pidx (B, N) int32 original indices, centers (B, N/128, 3), radii
    (B, N/128)."""
    planes: torch.Tensor
    pidx: torch.Tensor
    centers: torch.Tensor
    radii: torch.Tensor


def _along(x: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """x[..., m, axis] for every m: x (..., M, 3), axis (...) long."""
    return torch.gather(x, -1, axis[..., None, None].expand(
        *x.shape[:-1], 1))[..., 0]


def _widest(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The axis of x (..., M, 3) along which dim spans the most."""
    lo, hi = torch.aminmax(x, dim=dim)
    return (hi - lo).argmax(-1)


def spatial_permutation(xyz: torch.Tensor) -> Layout:
    """The sub-block layout of (B, N, 3) float32 clouds, N % 1024 == 0.
    Written in few torch ops: on the card the kernel's wrapper spends its
    host time launching them."""
    B, N, _ = xyz.shape
    n_slab = N // 1024                 # the JAX package's W windows
    K = 8 * n_slab                     # sub-blocks a cloud
    ax0 = _widest(xyz, 1)                                        # (B,)
    o1 = torch.argsort(_along(xyz, ax0), dim=1, stable=True)     # rank->orig
    slabs = torch.gather(xyz, 1, o1[..., None].expand(B, N, 3)).reshape(
        B, n_slab, N // n_slab, 3)
    o2 = torch.argsort(_along(slabs, _widest(slabs, 2)), dim=-1, stable=True)
    sub = torch.gather(o1.reshape(B, n_slab, N // n_slab), 2, o2).reshape(
        B, K, SUB)
    sub = sub.sort(-1).values          # ascending original index
    sub_xyz = torch.gather(xyz, 1, sub.reshape(B, N, 1).expand(B, N, 3)
                           ).reshape(B, K, SUB, 3)
    centers = sub_xyz.mean(2)
    radii = ((sub_xyz - centers[:, :, None]) ** 2).sum(-1).amax(-1).sqrt() \
        * 1.00001
    # the JAX package's slot order: the 8 fattest first, then by centre
    # along the first axis
    fat_rank = torch.argsort(torch.argsort(radii, dim=1, descending=True,
                                           stable=True), dim=1, stable=True)
    ckey = _along(centers, ax0)
    lo, hi = torch.aminmax(ckey, dim=1, keepdim=True)
    span = hi - lo + 1.0
    key = torch.where(fat_rank < 8, lo - 10.0 * span + fat_rank.float(), ckey)
    order = torch.argsort(key, dim=1, stable=True)
    sub = torch.gather(sub, 1, order[..., None].expand(B, K, SUB))
    planes = torch.gather(xyz.transpose(1, 2), 2,
                          sub.reshape(B, 1, N).expand(B, 3, N))
    return Layout(planes, sub.reshape(B, N).to(torch.int32),
                  torch.gather(centers, 1, order[..., None].expand(B, K, 3)),
                  torch.gather(radii, 1, order))


def _check(xyz: torch.Tensor, npoint: int) -> None:
    _check_fps(xyz, npoint)
    N = xyz.shape[1]
    if N % 1024 != 0 or N > MAX_N:
        raise ValueError(f"pruned fps takes N % 1024 == 0 and N <= {MAX_N}, "
                         f"got {N}")


def fps_pruned_plain(xyz: torch.Tensor, npoint: int,
                     return_dirty: bool = False):
    """(B, N, 3) float32 -> (B, npoint) int32, with the kernel's pruning;
    with return_dirty, also the (B,) count of sub-block updates made
    (rounds x sub-blocks, less those skipped). Inside kernels.counting()
    it reports its kernel's work on these inputs."""
    _check(xyz, npoint)
    with kernels.uncounted():
        idxs, dirty_count = _pruned_rounds(xyz, npoint)
    if kernels.is_counting():
        kernels.report("fps_pruned", xyz, npoint, int(dirty_count.sum()))
    return (idxs, dirty_count) if return_dirty else idxs


def fps_pruned_plan(n: int) -> tuple:
    """(blocks a cloud, sub-blocks a block) of csrc/fps_pruned.cu at n
    points: the fewest of 1, 2, 4 blocks whose equal shares of the n / 128
    sub-blocks fit a block (BLOCK_SUB, 160 kB of shared memory)."""
    n_sub = n // SUB
    g = 1 if n_sub <= BLOCK_SUB else (2 if n_sub <= 2 * BLOCK_SUB else 4)
    return g, n_sub // g


def fps_pruned_split(xyz: torch.Tensor, npoint: int,
                     blocks: int | None = None):
    """The kernel's walk in torch, for the tests: (indices, sub-block
    updates a cloud). The cloud's sub-blocks, in layout order, go to
    ``blocks`` blocks (fps_pruned_plan's by default) of equal shares; each
    sub-block caches its winner (bm, the smallest original index attaining
    it, its coordinates) and its squared threshold, refreshed only where it
    was dirty; each block folds its cached winners (largest bm, then the
    smallest index; the kernel folds its warps' and then their slots, the
    same fold in two steps), the cluster folds the blocks' winners the same
    way, and the next round's pick is the cached coordinates of the winner.
    Equal to fps_pruned_plain, bit for bit, for every split."""
    _check(xyz, npoint)
    B, N, _ = xyz.shape
    G = fps_pruned_plan(N)[0] if blocks is None else blocks
    K = N // SUB
    if K % G:
        raise ValueError(f"{K} sub-blocks do not split over {G} blocks")
    lay = spatial_permutation(xyz)
    pts = lay.planes.transpose(1, 2).reshape(B, G, K // G, SUB, 3)
    pidx = lay.pidx.reshape(B, G, K // G, SUB).long()
    cen = lay.centers.reshape(B, G, K // G, 3)
    rad = lay.radii.reshape(B, G, K // G)
    big = torch.iinfo(torch.int64).max

    def threshold2(bm):
        thr = (rad + torch.sqrt(bm)) * SLOP_MUL + SLOP_ADD
        return thr * thr

    dmin = torch.full((B, G, K // G, SUB), 1e10, device=xyz.device)
    bm = torch.full((B, G, K // G), 1e10, device=xyz.device)
    bi = pidx[..., 0].clone()
    bxyz = pts[..., 0, :].clone()
    thr2 = threshold2(bm)
    idxs = torch.zeros(B, npoint, dtype=torch.int32, device=xyz.device)
    dirty_count = torch.zeros(B, dtype=torch.int64, device=xyz.device)
    last = xyz[:, 0, :]
    for j in range(1, npoint):
        lc = last[:, None, None, :]
        dc = cen - lc
        d2c = dc[..., 0] * dc[..., 0] + dc[..., 1] * dc[..., 1] \
            + dc[..., 2] * dc[..., 2]
        dirty = d2c < thr2                                  # (B, G, K/G)
        dirty_count += dirty.sum((1, 2))
        dp = pts - lc[..., None, :]
        d = dp[..., 0] * dp[..., 0] + dp[..., 1] * dp[..., 1] \
            + dp[..., 2] * dp[..., 2]
        dmin = torch.where(dirty[..., None], torch.minimum(dmin, d), dmin)
        pos = dmin.argmax(-1, keepdim=True)                 # first max
        bm = torch.where(dirty, dmin.gather(-1, pos)[..., 0], bm)
        bi = torch.where(dirty, pidx.gather(-1, pos)[..., 0], bi)
        bxyz = torch.where(dirty[..., None], pts.gather(
            -2, pos[..., None].expand(B, G, K // G, 1, 3))[..., 0, :], bxyz)
        thr2 = torch.where(dirty, threshold2(bm), thr2)
        # each block's winner, then the cluster's
        wk = bm.amax(-1)                                    # (B, G)
        wi = torch.where(bm == wk[..., None], bi, big).amin(-1)
        ck = wk.amax(-1, keepdim=True)
        pick = torch.where(wk == ck, wi, big).amin(-1)      # (B,)
        idxs[:, j] = pick.int()
        at = (bi == pick[:, None, None]).reshape(B, K).float().argmax(-1)
        last = bxyz.reshape(B, K, 3)[torch.arange(B, device=xyz.device), at]
    return idxs, dirty_count


def _pruned_rounds(xyz: torch.Tensor, npoint: int):
    """fps_pruned_plain's rounds: (indices, sub-block updates a cloud)."""
    B, N, _ = xyz.shape
    lay = spatial_permutation(xyz)
    K = N // SUB
    px, py, pz = (lay.planes[:, i].reshape(B, K, SUB) for i in range(3))
    pidx = lay.pidx.reshape(B, K, SUB).long()
    cx, cy, cz = lay.centers.unbind(-1)
    big = torch.iinfo(torch.int64).max
    temp = torch.full((B, K, SUB), 1e10, device=xyz.device)
    bm = torch.full((B, K), 1e10, device=xyz.device)
    bi = pidx[..., 0].clone()            # smallest original index
    idxs = torch.zeros(B, npoint, dtype=torch.int32, device=xyz.device)
    dirty_count = torch.zeros(B, dtype=torch.int64, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = xyz[:, 0, :]
    for j in range(1, npoint):
        lx, ly, lz = (last[:, i:i + 1] for i in range(3))
        dcx, dcy, dcz = cx - lx, cy - ly, cz - lz
        d2c = dcx * dcx + dcy * dcy + dcz * dcz
        thr = (lay.radii + torch.sqrt(bm)) * SLOP_MUL + SLOP_ADD
        dirty = d2c < thr * thr                                  # (B, K)
        dirty_count += dirty.sum(1)
        dx, dy, dz = px - lx[..., None], py - ly[..., None], pz - lz[..., None]
        d = dx * dx + dy * dy + dz * dz
        temp = torch.where(dirty[..., None], torch.minimum(temp, d), temp)
        pos = temp.argmax(-1, keepdim=True)                      # first max
        bm = torch.where(dirty, temp.gather(-1, pos)[..., 0], bm)
        bi = torch.where(dirty, pidx.gather(-1, pos)[..., 0], bi)
        far = torch.where(bm == bm.amax(1, keepdim=True), bi, big).amin(1)
        idxs[:, j] = far.int()
        last = xyz[rows, far]
    return idxs, dirty_count


def _fps_pruned_cuda(xyz: torch.Tensor, npoint: int,
                     return_dirty: bool = False):
    _check(xyz, npoint)
    kernels.check_on_card("fps_pruned", xyz)
    B, N, _ = xyz.shape
    lay = spatial_permutation(xyz)
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    dirty = torch.zeros(B, dtype=torch.int32, device=xyz.device)
    kernels.launch("fps_pruned", lay.planes.data_ptr(), lay.pidx.data_ptr(),
                   lay.centers.data_ptr(), lay.radii.data_ptr(),
                   xyz.data_ptr(), B, N, npoint, out.data_ptr(),
                   dirty.data_ptr())
    if kernels.is_counting():
        kernels.report("fps_pruned", xyz, npoint, int(dirty.sum()))
    return (out, dirty.long()) if return_dirty else out


def furthest_point_sample_pruned(xyz: torch.Tensor, npoint: int
                                 ) -> torch.Tensor:
    """Pruned exact FPS: (B, N, 3) -> (B, npoint) int32, the indices of
    ops.furthest_point_sample. A CUDA tensor goes through the kernel, a CPU
    tensor through the plain version."""
    _check(xyz, npoint)
    if xyz.device.type == "cuda":
        return _fps_pruned_cuda(xyz, npoint)
    if xyz.device.type == "cpu":
        return fps_pruned_plain(xyz, npoint)
    raise ValueError(f"no pruned FPS for device {xyz.device}")
