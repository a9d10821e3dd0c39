"""The port's ops against their JAX counterparts, on the CPU.

Each kernel wrapper takes its plain version for a CPU tensor, so these hold
the plain versions (the semantics the CUDA kernels are compared with on the
card by chip_smoke.py) against the JAX package as its own CPU tests run it:
the XLA FPS loop, knn_point(method="exact") and pool_mlp_max's _pool_ref.
Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd_pointcloud_tpu.ops import gather as jax_gather
from kd_pointcloud_tpu.ops.distance import square_distance as jax_sqdist
from kd_pointcloud_tpu.ops.fps import _furthest_point_sample_xla
from kd_pointcloud_tpu.ops.interpolate import upsample_idw as jax_upsample
from kd_pointcloud_tpu.ops.knn import knn_point as jax_knn
from kd_pointcloud_tpu.ops.knn import knn_point_dist as jax_knn_dist
from kd_pointcloud_tpu.ops.pallas.pool_fused import _pool_ref
from kd_pointcloud_tpu.ops.warp import point_warp as jax_warp
from kd_pointcloud_tpu_torch.ops import (furthest_point_sample, gather_points,
                                         group_points, knn_point,
                                         knn_point_dist, point_warp,
                                         pool_mlp_max, square_distance,
                                         upsample_idw)
from kd_pointcloud_tpu_torch.ops import kernels
from kd_pointcloud_tpu_torch.ops.fps import fps_plain
from kd_pointcloud_tpu_torch.ops.knn import knn_plain
from kd_pointcloud_tpu_torch.ops.pool_fused import pool_plain

torch.set_num_threads(1)
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cloud(rng, b, n, scale=1.0):
    return (scale * rng.uniform(-1, 1, (b, n, 3))).astype(np.float32)


@pytest.mark.parametrize("n,npoint", [(8192, 2048), (3000, 700)])
def test_fps_bit_identical_to_xla(n, npoint):
    rng = np.random.RandomState(n)
    xyz = _cloud(rng, 2, n, scale=20.0)
    want = np.asarray(_furthest_point_sample_xla(jnp.asarray(xyz), npoint))
    got = furthest_point_sample(_t(xyz), npoint)
    assert got.dtype == torch.int32 and got.shape == (2, npoint)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fps_wrapper_on_cpu_is_plain_and_counts_nothing():
    kernels.reset_launches()
    xyz = _t(_cloud(np.random.RandomState(1), 1, 300))
    torch.testing.assert_close(furthest_point_sample(xyz, 50),
                               fps_plain(xyz, 50), rtol=0, atol=0)
    assert kernels.LAUNCHES == {"fps": 0, "knn": 0, "pool": 0}


def test_square_distance_matches_jax():
    rng = np.random.RandomState(2)
    a, b = _cloud(rng, 2, 100, 10.0), _cloud(rng, 2, 130, 10.0)
    np.testing.assert_allclose(square_distance(_t(a), _t(b)).numpy(),
                               np.asarray(jax_sqdist(a, b)), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("k", [3, 9, 16, 32])
def test_knn_indices_identical_to_jax_exact(k):
    rng = np.random.RandomState(k)
    keys, query = _cloud(rng, 2, 700), _cloud(rng, 2, 300)
    d_want, i_want = jax_knn_dist(k, jnp.asarray(keys), jnp.asarray(query),
                                  method="exact")
    d_got, i_got = knn_point_dist(k, _t(keys), _t(query))
    assert i_got.dtype == torch.int32 and i_got.shape == (2, 300, k)
    np.testing.assert_array_equal(i_got.numpy(), np.asarray(i_want))
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(
        knn_point(k, _t(keys), _t(query)).numpy(),
        np.asarray(jax_knn(k, jnp.asarray(keys), jnp.asarray(query),
                           method="exact")))


def test_knn_query_chunks_match_one_pass():
    """Queries beyond one 2048 chunk give the same rows as a single pass."""
    rng = np.random.RandomState(4)
    keys, query = _t(_cloud(rng, 1, 600)), _t(_cloud(rng, 1, 4100))
    d, i = knn_plain(9, keys, query)
    full_d, full_i = torch.sort(square_distance(query, keys), dim=-1,
                                stable=True)
    torch.testing.assert_close(i, full_i[..., :9].int(), rtol=0, atol=0)
    torch.testing.assert_close(d, full_d[..., :9], rtol=0, atol=0)


def test_knn_ties_break_toward_lower_index():
    keys = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0], [-1.0, 0, 0],
                          [0, 0, 5.0]]])
    query = torch.zeros(1, 1, 3)
    np.testing.assert_array_equal(knn_point(3, keys, query).numpy(),
                                  [[[0, 1, 2]]])


def test_gather_and_group_match_jax():
    rng = np.random.RandomState(5)
    pts = rng.standard_normal((2, 50, 7)).astype(np.float32)
    idx = rng.randint(0, 50, (2, 20, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        group_points(_t(pts), _t(idx)).numpy(),
        np.asarray(jax_gather.group_points(pts, idx)))
    np.testing.assert_array_equal(
        gather_points(_t(pts), _t(idx[:, :, 0])).numpy(),
        np.asarray(jax_gather.gather_points(pts, idx[:, :, 0])))


@pytest.mark.parametrize("c", [32, 64, 128, 256])
def test_pool_plain_matches_pool_ref(c):
    rng = np.random.RandomState(c)
    B, N1, N2, K = 1, 96, 80, 16
    u = rng.standard_normal((B, N2, c)).astype(np.float32)
    v = rng.standard_normal((B, N1, c)).astype(np.float32)
    idx = rng.randint(0, N2, (B, N1, K)).astype(np.int32)
    w = (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32)  # (in, out)
    b = rng.standard_normal(c).astype(np.float32)
    want = np.asarray(_pool_ref(jax_gather.group_points_kmajor(u, idx), v,
                                [w], [b], 0))
    got = pool_mlp_max(_t(u), _t(idx), _t(v), _t(w.T.copy()), _t(b))
    assert got.shape == (B, N1, c)
    assert np.abs(got.numpy() - want).max() <= TOL
    torch.testing.assert_close(
        got, pool_plain(_t(u), _t(idx), _t(v), _t(w.T.copy()), _t(b)),
        rtol=0, atol=0)


@pytest.mark.parametrize("shared_knn", [False, True])
def test_upsample_idw_matches_jax(shared_knn):
    rng = np.random.RandomState(6)
    dense = _cloud(rng, 2, 256, 5.0)
    sparse = dense[:, :64].copy()       # an FPS-like exact subset
    feat = rng.standard_normal((2, 64, 35)).astype(np.float32)
    want = np.asarray(jax_upsample(dense, sparse, feat, method="exact"))
    knn = knn_point_dist(3, _t(sparse), _t(dense)) if shared_knn else None
    got = upsample_idw(_t(dense), _t(sparse), _t(feat), knn=knn).numpy()
    assert np.abs(got - want).max() <= TOL


def test_point_warp_matches_jax():
    rng = np.random.RandomState(7)
    xyz1, xyz2 = _cloud(rng, 1, 200, 5.0), _cloud(rng, 1, 240, 5.0)
    flow = (0.3 * rng.standard_normal((1, 200, 3))).astype(np.float32)
    want = np.asarray(jax_warp(xyz1, xyz2, flow, method="exact"))
    got = point_warp(_t(xyz1), _t(xyz2), _t(flow)).numpy()
    assert np.abs(got - want).max() <= TOL
    pc2 = _t(xyz2)
    assert point_warp(_t(xyz1), pc2, None) is pc2
