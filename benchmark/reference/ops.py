"""Plain PyTorch point-cloud ops of the reference.

Each op is the straightforward tensor form of the model's math: no kernel,
no fusion, float32. The 3-D kNN ranks keys by the |q|^2 - 2 q.k + |k|^2
expansion summed coordinate by coordinate and breaks ties toward the lower
key index (a stable sort), FPS seeds at index 0 and takes the first maximum
of the running minimum each round, and the cost-volume pool forms the
grouped (B, N1, K, C) tensor in full. The feature-space kNN takes its
cross term as one float32 matrix product, in query chunks of 2048.

``sites()`` records the shapes of every kNN, FPS and pool call made inside
it, so that the benchmark's operation counts (work.py) follow the same
wiring as the reference forward. A network's op of another kind records
its own calls with ``record(kind, site)``; work.py counts each kind by its
formula, kernels/<kind>.py work(*site).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

LEAKY_RATE = 0.1
CHUNK = 2048

_sites = None


@contextlib.contextmanager
def sites():
    """Record the calls of the block: yields a dict, kind -> the list of
    its calls' sites in call order, of every kind recorded: here "knn" of
    (B, S, N, k), "fps" of (B, N, m), "pool" of (B, N1, N2, K, C) and, at a
    pool whose weights take a gradient, "pool_bwd" of the same, and
    "feature_knn" of (B, S, N, D, k)."""
    global _sites
    outer, _sites = _sites, {}
    try:
        yield _sites
    finally:
        _sites = outer


def record(kind: str, site: tuple) -> None:
    """Record a call of kind at site (its shapes) inside sites()."""
    if _sites is not None:
        _sites.setdefault(kind, []).append(site)


class _Leaky(torch.autograd.Function):
    """leaky_relu(x, 0.1) with gradient 1 at x == 0 (jax.nn.leaky_relu)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.leaky_relu(x, LEAKY_RATE)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, LEAKY_RATE * g)


def leaky(x):
    if torch.is_grad_enabled() and x.requires_grad:
        return _Leaky.apply(x)
    return F.leaky_relu(x, LEAKY_RATE)


def _dot(a, b):
    out = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        out = out + a[..., c] * b[..., c]
    return out


def square_distance(src, dst):
    """(..., N, 3) x (..., M, 3) -> (..., N, M): |s|^2 - 2 s.d + |d|^2,
    each product and sum rounded on its own, coordinate by coordinate."""
    s2 = _dot(src, src)[..., :, None]
    d2 = _dot(dst, dst)[..., None, :]
    cross = _dot(src[..., :, None, :], dst[..., None, :, :])
    return s2 - 2.0 * cross + d2


def knn(k, xyz, query):
    """(d2, idx int32), each (B, S, k): the k nearest keys of xyz (B, N, 3)
    to each query (B, S, 3), ascending, ties toward the lower index."""
    record("knn", (query.shape[0], query.shape[1], xyz.shape[1], k))
    ds, idxs = [], []
    for q in torch.split(query, CHUNK, dim=1):
        d, i = torch.sort(square_distance(q, xyz), dim=-1, stable=True)
        ds.append(d[..., :k])
        idxs.append(i[..., :k].int())
    return torch.cat(ds, dim=1), torch.cat(idxs, dim=1)


def feature_knn(k, keys, query):
    """Indices (B, S, k) int32 of the k nearest rows of keys (B, N, D) in
    feature space, ties toward the lower index; no gradient."""
    record("feature_knn", (query.shape[0], query.shape[1], keys.shape[1],
                           keys.shape[2], k))
    out = []
    with torch.no_grad():
        for q in torch.split(query, CHUNK, dim=1):
            d = torch.matmul(q, keys.transpose(-1, -2))
            d.mul_(-2.0).add_((q * q).sum(-1, keepdim=True))
            d.add_((keys * keys).sum(-1)[..., None, :])
            out.append(torch.sort(d, dim=-1, stable=True)[1][..., :k].int())
    return torch.cat(out, dim=1)


def fps(xyz, npoint):
    """Furthest-point sampling (B, N, 3) -> (B, npoint) int32: seed index
    0, each round the first maximum of the running minimum distance."""
    B, N, _ = xyz.shape
    record("fps", (B, N, npoint))
    idxs = torch.zeros(B, npoint, dtype=torch.int32, device=xyz.device)
    if xyz.is_meta:             # shapes only: a count's run (work.py)
        return idxs
    temp = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = xyz[:, 0, :]
    for j in range(1, npoint):
        diff = xyz - last[:, None, :]
        d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
             + diff[..., 2] * diff[..., 2])
        temp = torch.minimum(temp, d)
        far = torch.argmax(temp, dim=-1)
        idxs[:, j] = far.int()
        last = xyz[rows, far]
    return idxs


def gather_points(points, idx):
    """(B, N, C) x (B, S) -> (B, S, C)."""
    B, N, C = points.shape
    flat = idx.long() + torch.arange(B, device=idx.device)[:, None] * N
    return points.reshape(B * N, C).index_select(0, flat.reshape(-1)).reshape(
        B, idx.shape[1], C)


def group_points(points, idx):
    """(B, N, C) x (B, S, K) -> (B, S, K, C)."""
    B, S, K = idx.shape
    return gather_points(points, idx.reshape(B, S * K)).reshape(
        B, S, K, points.shape[-1])


def _idw(diff):
    dist = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-20))
    inv = 1.0 / dist
    return inv / inv.sum(-1, keepdim=True)


def upsample_idw(dense_xyz, sparse_xyz, sparse_feat, nn3=None):
    """3-NN inverse-distance upsampling of (B, S, C) features at sparse_xyz
    to dense_xyz (B, N, 3); nn3: a precomputed (d2, idx) 3-NN."""
    _, idx = nn3 if nn3 is not None else knn(3, sparse_xyz, dense_xyz)
    grouped = group_points(torch.cat([sparse_xyz, sparse_feat], dim=-1), idx)
    weight = _idw(grouped[..., :3] - dense_xyz[:, :, None, :])
    return (weight[..., None] * grouped[..., 3:]).sum(2)


def point_warp(xyz1, xyz2, flow1):
    """xyz2 (B, N2, 3) moved back along flow1 (B, N1, 3) at xyz1, the
    inverse flow by 3-NN inverse-distance weighting over xyz1 + flow1."""
    moved = xyz1 + flow1
    _, idx = knn(3, moved, xyz2)
    grouped = group_points(torch.cat([moved, flow1], dim=-1), idx)
    weight = _idw(xyz2[:, :, None, :] - grouped[..., :3])
    return xyz2 - (weight[..., None] * grouped[..., 3:]).sum(2)


def pool(u, idx, v, weight, bias):
    """max_k leaky(leaky(u[idx] + v) @ weight^T + bias): u (B, N2, C), idx
    (B, N1, K), v (B, N1, C) -> (B, N1, C)."""
    B, N2, C = u.shape
    site = (B, idx.shape[1], N2, idx.shape[2], C)
    record("pool", site)
    if torch.is_grad_enabled() and weight.requires_grad:
        record("pool_bwd", site)
    h = leaky(group_points(u, idx) + v[:, :, None, :])
    return leaky(F.linear(h, weight, bias)).amax(dim=2)
