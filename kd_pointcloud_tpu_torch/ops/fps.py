"""Furthest-point sampling.

Port of kd_pointcloud_tpu/ops/fps.py. ``fps_plain`` is the plain version,
the port of ``_furthest_point_sample_xla``; the CUDA kernel is csrc/fps.cu,
which splits a cloud over a thread-block cluster of G blocks (``fps_plan``
picks G) and reduces each round's candidates by lane, warp and cluster on
packed keys (``fps_cluster`` is that split and order in torch, for the
tests).
Both seed at index 0 and take, each round, the argmax of the running
minimum squared distance with a first-index tie-break, and both select
bit-identical indices. FPS has no gradient.

``furthest_point_sample_blocked`` is the port of the JAX package's
``furthest_point_sample_blocked``, the relaxation behind
``ModelConfig.fps_blocks``: exact FPS on each contiguous block of rows,
all blocks in one call (one kernel launch on the card).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import kernels

CLOUD_THREADS = 1024             # threads a cloud (csrc/fps.cu kCloudThreads)
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # blocks a cloud the kernel is built for
MAX_POINTS = 32 * CLOUD_THREADS
ONE_BLOCK_POINTS = 16 * CLOUD_THREADS  # G = 1 holds its slice in 192 kB
SMS = 132                        # streaming multiprocessors of an H100
MAX_CLUSTER = 8                  # the largest G the plan picks
INT_MAX = 2**31 - 1


@kernels.plain("fps")
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


def points_a_thread(N: int) -> int:
    """Points a thread holds: the smallest of 1, 2, 4, ..., 32 whose 1024
    threads cover N."""
    ppt = 1
    while ppt * CLOUD_THREADS < N:
        ppt *= 2
    return ppt


def fps_plan(B: int, N: int, clusters) -> int:
    """G, the blocks of one cloud's cluster, for B clouds of N points:
    the largest G in CLUSTER_SIZES up to MAX_CLUSTER whose B clusters are
    resident at once -- one wave, B * G <= SMS and B <= clusters(G), the
    card's count of clusters of G blocks that fit (one block an SM) -- and
    at least 2 above ONE_BLOCK_POINTS, where one block's slice of the
    cloud would not fit its shared memory. A larger G shortens a round's
    distance pass; every G keeps the cloud's 32 warps and one barrier a
    round."""
    if not 0 < N <= MAX_POINTS:
        raise ValueError(f"fps kernel takes 0 < N <= {MAX_POINTS}, got {N}")
    least = 1 if N <= ONE_BLOCK_POINTS else 2
    pick = least
    for g in CLUSTER_SIZES:
        if least <= g <= MAX_CLUSTER and B * g <= SMS and B <= clusters(g):
            pick = g
    return pick


@functools.lru_cache(maxsize=None)
def card_clusters(g: int) -> int:
    """Clusters of g blocks of the FPS kernel that the current card holds
    at once (cudaOccupancyMaxActiveClusters)."""
    count = ctypes.c_int(0)
    err = kernels.lib().kdpc_fps_clusters(g, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"fps cluster occupancy at G={g}: cudaError {err}")
    return count.value


def fps_cluster(xyz: torch.Tensor, npoint: int, blocks: int) -> torch.Tensor:
    """The kernel's split and reduction order in torch, for the tests:
    block g of the cluster holds points g * NB .. (g + 1) * NB - 1 (NB =
    points_a_thread(N) * 1024 / blocks), its warp w the next 32 *
    points_a_thread(N) of them, point w0 + 32 j + lane in slot j of the
    lane; padding where the index reaches N. Each round a lane keeps its
    first largest running minimum, a packed key (the float's bits as an
    int; -1 for padding) with its index; a warp takes the largest key and
    the smallest index that holds it into slot g * W + w of the cluster
    (W = 32 / blocks warps a block), and the cluster the first slot with
    the largest key. Returns (B, npoint) int32 like fps_plain, which it
    equals bit for bit."""
    B, N, _ = xyz.shape
    ppt = points_a_thread(N)
    W = CLOUD_THREADS // 32 // blocks
    g, w, j, lane = torch.meshgrid(torch.arange(blocks), torch.arange(W),
                                   torch.arange(ppt), torch.arange(32),
                                   indexing="ij")
    pidx = (g * W * 32 * ppt + w * 32 * ppt + j * 32 + lane).reshape(
        blocks * W, ppt, 32)                    # (slot, slot j, lane)
    valid = pidx < N
    pts = xyz.float()[:, pidx.clamp(max=N - 1)]   # (B, slots, PPT, 32, 3)
    pts = torch.where(valid[..., None], pts, 0.0)
    dmin = torch.where(valid, 1e10, -1.0).expand(B, -1, -1, -1).clone()
    base = pidx[:, 0, 0][:, None]               # a slot's first point
    lanes = torch.arange(32)
    idxs = torch.zeros(B, npoint, dtype=torch.int32)
    rows = torch.arange(B)
    last = xyz[:, 0, :].float()
    for r in range(1, npoint):
        diff = pts - last[:, None, None, None, :]
        d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
             + diff[..., 2] * diff[..., 2])
        dmin = torch.minimum(dmin, d)       # padding stays -1 (d >= 0)
        bv, bj = dmin.max(dim=2)            # a lane's first maximum
        real = bv >= 0
        key = torch.where(real, bv.view(torch.int32), -1)   # (B, slots, 32)
        gi = torch.where(real, base + 32 * bj + lanes, INT_MAX)
        wk = key.amax(dim=-1)
        wi = torch.where(key == wk[..., None], gi, INT_MAX).amin(dim=-1)
        first = (wk == wk.amax(dim=-1, keepdim=True)).int().argmax(dim=-1)
        bi = wi[rows, first]
        idxs[:, r] = bi.int()
        last = xyz[rows, bi].float()
    return idxs


def _check(xyz: torch.Tensor, npoint: int) -> None:
    kernels.check_tensor("fps xyz", xyz, torch.float32, 3)
    if xyz.shape[2] != 3 or not 0 < npoint <= xyz.shape[1]:
        raise ValueError(f"fps takes (B, N, 3) and 0 < npoint <= N, got "
                         f"{tuple(xyz.shape)}, {npoint}")


def _fps_cuda(xyz: torch.Tensor, npoint: int,
              blocks: int | None = None) -> torch.Tensor:
    """The kernel; blocks (G) from fps_plan unless given."""
    _check(xyz, npoint)
    kernels.check_on_card("fps", xyz)
    B, N, _ = xyz.shape
    if N > MAX_POINTS:
        raise ValueError(f"fps kernel takes N <= {MAX_POINTS}, got {N}")
    g = fps_plan(B, N, card_clusters) if blocks is None else blocks
    if g not in CLUSTER_SIZES or (g == 1 and N > ONE_BLOCK_POINTS):
        raise ValueError(f"fps kernel takes G in {CLUSTER_SIZES}, and G > 1 "
                         f"above {ONE_BLOCK_POINTS} points; got G={g}, N={N}")
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    kernels.launch("fps", xyz.data_ptr(), B, N, npoint, g, out.data_ptr())
    kernels.report("fps", xyz, npoint)
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


def furthest_point_sample_blocked(xyz: torch.Tensor, npoint: int,
                                  blocks: int) -> torch.Tensor:
    """FPS with a blocks-times shorter serial chain: (B, N, 3) -> (B,
    npoint) int32.

    The N rows split into `blocks` contiguous blocks of N / blocks; exact
    FPS selects npoint / blocks rows of each, the B * blocks blocks as
    clouds of one furthest_point_sample call; offsets make the indices
    global, and the block orderings interleave (entry j * blocks + b is
    block b's j-th pick), so any prefix holds about as many picks of every
    block. Exact FPS when blocks <= 1, N % blocks or npoint % blocks."""
    _check(xyz, npoint)
    B, N, _ = xyz.shape
    if blocks <= 1 or N % blocks or npoint % blocks:
        return furthest_point_sample(xyz, npoint)
    nb, sb = N // blocks, npoint // blocks
    idx = furthest_point_sample(xyz.reshape(B * blocks, nb, 3), sb)
    off = torch.arange(blocks, dtype=torch.int32, device=xyz.device) * nb
    idx = idx.reshape(B, blocks, sb) + off[None, :, None]
    return idx.transpose(1, 2).reshape(B, npoint)
