"""Exact k-nearest-neighbour search over point clouds.

Port of the exact path of kd_pointcloud_tpu/ops/knn.py (knn_point /
knn_point_dist with method="exact"). ``knn_plain`` is the plain version: a
stable sort of the square_distance expansion, in query chunks of 2048 as
the JAX package chunks it. The CUDA kernel is csrc/knn.cu: L lanes a query
scan stripes of each key tile and keep one sorted list a group, one entry a
lane (two at L = 32 for k > 32), merging each step's candidates lowest index
first (``knn_striped`` is that rule in torch, for the tests; ``knn_plan``
picks L and the queries a block). It takes every k up to 64, as the TPU
kernel (knn_fused) does. Both break ties toward the lower key index, as
lax.top_k does; torch.topk promises no tie order, and at metric scale
(|x|^2 ~ 1e3, so the expansion moves in steps of ~6e-5) equal distances
among near neighbours are common.

The TPU's approximate selection (lax.approx_min_k and the fused kernel's
float-float mode) is not reproduced: the port's search is exact.

``knn_features`` is the search in feature space (D = 32-256, the FG cross
layer's feature half). The JAX package runs it as XLA, no Pallas kernel
(its fused kernel takes 3-D points only). Its plain version,
``knn_features_plain``, is the expansion with its cross term as one
float32 matrix product (``feature_distance``) and a stable sort of each
row. On the card it is csrc/knn_features.cu: the distances in registers,
each query's list in shared memory, nothing read back to the host, so a
forward through it can be captured as a CUDA graph; it ranks exactly as
the plain version, ties toward the lower key index.

The distances carry a gradient, as the JAX package's exact path's do (the
self-supervised loss weights by them): on the CPU through the plain
version's sort, on the card by ``_KnnFunction``'s backward of the
expansion at the selected keys.
"""

from __future__ import annotations

import functools

import torch

from ..perf.trace import annotate
from . import kernels
from .distance import square_distance
from .gather import group_points

MAX_K = 64                      # knn_fused's largest k
KERNEL_K = range(1, MAX_K + 1)
_CHUNK = 2048
KERNEL_LANES = (1, 4, 8, 16, 32)   # lanes a query the kernel is built for
ONE_LANE_K = 3                  # the k, and list entries, of L = 1
TILE = 2048                     # keys a shared-memory tile (csrc/knn.cu)
MAX_THREADS = 1024              # threads a block
SMS = 132                       # streaming multiprocessors of an H100
FILL_THREADS = SMS * 1024       # lanes that keep every SM half occupied
ONE_LANE_QUERIES = SMS * 256    # queries that give 8 warps an SM at L = 1
MIN_BLOCKS = 2 * SMS
FEATURE_DIMS = (32, 64, 128, 256)   # widths of the feature kNN kernel


@kernels.plain("knn")
def knn_plain(k: int, xyz: torch.Tensor, query: torch.Tensor):
    """(d2, idx): (B, S, k) float32 expansion distances, ascending, and
    int32 indices into xyz."""
    ds, idxs = [], []
    for q in torch.split(query, _CHUNK, dim=1):
        d, i = torch.sort(square_distance(q, xyz), dim=-1, stable=True)
        ds.append(d[..., :k])
        idxs.append(i[..., :k].int())
    return torch.cat(ds, dim=1), torch.cat(idxs, dim=1)


@functools.lru_cache(maxsize=None)
def knn_plan(B: int, S: int, N: int, k: int):
    """(lanes, queries a block) of the kNN kernel for B clouds of S queries
    over N keys. One lane a query (its 3 entries in registers) where
    k == ONE_LANE_K and B * S >= ONE_LANE_QUERIES; else lanes the smallest
    power of two >= max(min(k, 32), 4) (one list entry a lane, two where
    k > 32), doubled up to 32 while B * S * lanes is short of FILL_THREADS.
    Queries a block: as many as 1024 threads hold, halved while the grid
    has fewer than MIN_BLOCKS blocks, never below one warp. N does not
    change the plan: a group's time grows with N, its parallelism does
    not."""
    if k not in KERNEL_K:
        raise ValueError(f"knn kernel takes 1 <= k <= {MAX_K}, got {k}")
    if k == ONE_LANE_K and B * S >= ONE_LANE_QUERIES:
        lanes = 1
    else:
        lanes = 4
        while lanes < min(k, KERNEL_LANES[-1]):
            lanes *= 2
        while lanes < KERNEL_LANES[-1] and B * S * lanes < FILL_THREADS:
            lanes *= 2
    qpb = MAX_THREADS // lanes
    while qpb * lanes > 32 and B * -(-S // qpb) < MIN_BLOCKS:
        qpb //= 2
    return lanes, qpb


def lane_entries(lanes: int, k: int) -> int:
    """List entries a lane holds (R of knn_kernel<L, R>): ONE_LANE_K at
    L = 1, two where k > L (L = 32 only), else one."""
    if lanes == 1:
        return ONE_LANE_K
    return 2 if k > lanes else 1


def list_entries(lanes: int, k: int) -> int:
    """Entries of a group's sorted list at L lanes for this k."""
    return lanes * lane_entries(lanes, k)


def knn_striped(k: int, xyz: torch.Tensor, query: torch.Tensor, lanes: int):
    """The kernel's selection rule in torch, for the tests: the keys in
    steps of ``lanes`` consecutive indices, one per lane; the step's
    candidates (distance strictly below the list's k-th entry, at lane
    (k - 1) // R, slot (k - 1) % R) inserted lowest lane first into one
    sorted list, R = lane_entries(lanes, k) entries a lane, after every
    entry whose distance is not greater: an entry moves up from the slot
    before it in its lane, or at slot 0 from the previous lane's last
    slot, as read before the insert. Each candidate is checked again
    against the k-th entry that the earlier insertions left. Returns
    (d2, idx) like knn_plain, which it equals bit for bit."""
    B, S, N = query.shape[0], query.shape[1], xyz.shape[1]
    d_all = square_distance(query, xyz)                     # (B, S, N)
    R = lane_entries(lanes, k)
    if k > lanes * R or (lanes == 1 and k != ONE_LANE_K):
        raise ValueError(f"{lanes} lanes of {R} entries do not hold k={k}")
    t_lane, t_slot = divmod(k - 1, R)
    ld = torch.full((B, S, lanes, R), float("inf"), dtype=d_all.dtype)
    li = torch.zeros(B, S, lanes, R, dtype=torch.int32)
    # a position has a predecessor unless it is the group's first
    has_prev = torch.arange(lanes * R).reshape(lanes, R) > 0
    for j0 in range(0, N, lanes):
        step = d_all[..., j0:j0 + lanes]
        cand = step < ld[..., t_lane, t_slot, None]
        for src in range(step.shape[-1]):
            cd = step[..., src, None, None]
            ins = (cand[..., src, None, None]
                   & (cd < ld[..., t_lane, t_slot, None, None]))
            # slot 0's predecessor: the previous lane's last slot (the
            # kernel's __shfl_up_sync); slot r's: slot r - 1 of its lane
            ud = torch.cat([ld[..., :1, -1:], ld[..., :-1, -1:]], dim=-2)
            ui = torch.cat([li[..., :1, -1:], li[..., :-1, -1:]], dim=-2)
            pd = torch.cat([ud, ld[..., :-1]], dim=-1)
            pi = torch.cat([ui, li[..., :-1]], dim=-1)
            take_up = has_prev & (pd > cd)
            move = ins & (ld > cd)
            ld = torch.where(move, torch.where(take_up, pd, cd), ld)
            li = torch.where(move, torch.where(take_up, pi,
                                               torch.tensor(j0 + src,
                                                            dtype=li.dtype)),
                             li)
    return (ld.reshape(B, S, -1)[..., :k].contiguous(),
            li.reshape(B, S, -1)[..., :k].contiguous())


def feature_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """|s|^2 - 2 s.d + |d|^2 between every (src, dst) row pair, the cross
    term one matrix product (full float32 where use_full_fp32 set it, as
    the JAX package's precision="highest"), summed in the JAX package's
    order: (|s|^2 - 2 s.d) + |d|^2."""
    d = torch.matmul(src, dst.transpose(-1, -2))
    d.mul_(-2.0).add_((src * src).sum(-1, keepdim=True))
    return d.add_((dst * dst).sum(-1)[..., None, :])


def feature_rows(B: int, S: int) -> int:
    """Queries a block of the feature kNN kernel for B clouds of S queries:
    128 (8 rows a thread), or 64 where 128 would give fewer blocks than
    two an SM."""
    return 128 if B * -(-S // 128) >= MIN_BLOCKS else 64


@kernels.plain("knn_features")
def knn_features_plain(k: int, keys: torch.Tensor, query: torch.Tensor
                       ) -> torch.Tensor:
    """Indices (B, S, k) int32: a stable sort of each row of
    feature_distance, in query chunks of 2048 as the JAX package's exact
    knn_point."""
    return torch.cat([torch.sort(feature_distance(q, keys), dim=-1,
                                 stable=True)[1][..., :k].int()
                      for q in torch.split(query, _CHUNK, dim=1)], dim=1)


def _knn_features_cuda(k: int, keys: torch.Tensor, query: torch.Tensor,
                       with_dist: bool = False):
    """The feature kNN kernel: indices (B, S, k) int32, and with with_dist
    (d, idx), d its (B, S, k) distances. |q|^2 and |x|^2 are torch's sums,
    as feature_distance's."""
    kernels.check_tensor("knn_features keys", keys, torch.float32, 3)
    kernels.check_tensor("knn_features query", query, torch.float32, 3)
    B, N, D = keys.shape
    S = query.shape[1]
    if D not in FEATURE_DIMS:
        raise ValueError(f"knn_features kernel takes D in {FEATURE_DIMS}, "
                         f"got {D}")
    if k not in KERNEL_K or k > N:
        raise ValueError(f"knn_features kernel takes 1 <= k <= "
                         f"min({MAX_K}, N), got k={k}, N={N}")
    kernels.check_on_card("knn_features", keys, query)
    if keys.data_ptr() % 16 or query.data_ptr() % 16:
        raise ValueError("knn_features: keys and queries must be 16-byte "
                         "aligned")
    qn = (query * query).sum(-1)
    kn = (keys * keys).sum(-1)
    idx = torch.empty(B, S, k, dtype=torch.int32, device=keys.device)
    d = (torch.empty(B, S, k, dtype=torch.float32, device=keys.device)
         if with_dist else None)
    kernels.launch("knn_features", query.data_ptr(), keys.data_ptr(),
                   qn.data_ptr(), kn.data_ptr(), B, S, N, D, k,
                   feature_rows(B, S), idx.data_ptr(),
                   None if d is None else d.data_ptr())
    kernels.report("knn_features", k, keys, query)
    return (d, idx) if with_dist else idx


def knn_features(k: int, keys: torch.Tensor, query: torch.Tensor
                 ) -> torch.Tensor:
    """Indices (B, S, k) int32 of the k nearest rows of keys (B, N, D)
    around each query row (B, S, D), in feature space, ascending, ties
    toward the lower key index, without autograd (indices carry no
    gradient). A CUDA tensor goes through the kernel, a CPU tensor through
    knn_features_plain. The span knn_features holds the search
    (perf/trace.py)."""
    if (keys.dim() != 3 or query.dim() != 3 or keys.shape[0] != query.shape[0]
            or keys.shape[2] != query.shape[2] or not 0 < k <= keys.shape[1]):
        raise ValueError(f"knn_features takes (B, N, D) keys and (B, S, D) "
                         f"queries, 0 < k <= N; got keys "
                         f"{tuple(keys.shape)}, queries "
                         f"{tuple(query.shape)}, k={k}")
    with annotate("knn_features"), torch.no_grad():
        if keys.device.type == "cuda":
            return _knn_features_cuda(k, keys, query)
        if keys.device.type == "cpu":
            return knn_features_plain(k, keys, query)
    raise ValueError(f"no feature kNN for device {keys.device}")


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
    if k not in KERNEL_K:
        raise ValueError(f"knn kernel takes 1 <= k <= {MAX_K}, got {k}")
    kernels.check_on_card("knn", xyz, query)
    B, N, _ = xyz.shape
    S = query.shape[1]
    lanes, qpb = knn_plan(B, S, N, k)
    idx = torch.empty(B, S, k, dtype=torch.int32, device=xyz.device)
    d2 = torch.empty(B, S, k, dtype=torch.float32, device=xyz.device)
    kernels.launch("knn", query.data_ptr(), xyz.data_ptr(), B, S, N, k,
                   lanes, qpb, idx.data_ptr(), d2.data_ptr())
    kernels.report("knn", k, xyz, query)
    return d2, idx


class _KnnFunction(torch.autograd.Function):
    """The kNN kernel, with a gradient for its distances: d2 is the
    expansion |q|^2 - 2 q.k + |k|^2 at the selected keys, so g d2 adds
    2 g (q - k) to its query and 2 g (k - q) to its key's row, as autograd
    of knn_plain does. The indices have none."""

    @staticmethod
    def forward(ctx, k, xyz, query):
        d2, idx = _knn_cuda(k, xyz, query)
        ctx.save_for_backward(xyz, query, idx)
        ctx.mark_non_differentiable(idx)
        return d2, idx

    @staticmethod
    def backward(ctx, g_d2, _g_idx):
        xyz, query, idx = ctx.saved_tensors
        _, need_xyz, need_query = ctx.needs_input_grad
        g = 2.0 * g_d2[..., None] * (query[:, :, None, :]
                                     - group_points(xyz, idx))
        g_query = g.sum(2) if need_query else None
        g_xyz = None
        if need_xyz:
            B, N, _ = xyz.shape
            rows = (idx.long() + torch.arange(B, device=idx.device)[
                :, None, None] * N).reshape(-1)
            g_xyz = torch.zeros(B * N, 3, dtype=g.dtype,
                                device=g.device).index_add_(
                0, rows, -g.reshape(-1, 3)).reshape(B, N, 3)
        return None, g_xyz, g_query


def _knn_card(k: int, xyz: torch.Tensor, query: torch.Tensor):
    """The kNN on the card: the kernel, its distances' backward."""
    return _KnnFunction.apply(k, xyz, query)


def knn_point_dist(k: int, xyz: torch.Tensor, query: torch.Tensor):
    """k nearest points of xyz (B, N, 3) around each query (B, S, 3).

    Returns (d2, idx), each (B, S, k), sorted by ascending d2: the selection
    distances (the expansion, like the JAX exact path) and int32 indices.
    A CUDA tensor goes through the kernel, a CPU tensor through the plain
    version."""
    _check(k, xyz, query)
    if xyz.device.type == "cuda":
        return _knn_card(k, xyz, query)
    if xyz.device.type == "cpu":
        return knn_plain(k, xyz, query)
    raise ValueError(f"no kNN for device {xyz.device}")


def knn_point(k: int, xyz: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Indices (B, S, k) int32 of the k nearest points; see knn_point_dist."""
    return knn_point_dist(k, xyz, query)[1]
