"""The port's Morton-window block kNN (kd_pointcloud_tpu_torch/attic/morton.py)
against the JAX package's attic/morton.py, on the CPU.

- morton_codes: bit-equal codes (uint32 in JAX, int64 here) on seeded clouds
  and on points on the box's faces and corners (the clip at 0 and 1023);
- joint_bounds and the window starts (searchsorted of each query block's
  median code, clamped) equal;
- knn_block_dist: indices equal on tie-free seeded normal clouds (the JAX
  test's; the JAX selection, approx_min_k, is exact on the CPU), distances
  within 1e-5 (float32 expansions |q|^2 - 2 q.x + |x|^2 summed in another
  order, whose rounding scales with |q|^2), the caller's query order
  restored;
- the JAX test's recall band against the exact kNN (tests/test_knn_fused.py
  TestMortonNegativeResult): above 0.5, below 1.0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attic import morton as jax_morton
from kd_pointcloud_tpu.ops.knn import knn_point_dist
from kd_pointcloud_tpu_torch.attic import morton
from kd_pointcloud_tpu_torch.ops.knn import knn_plain

torch.set_num_threads(1)


def _clouds(seed, B, S, N, scale=(1.0, 1.0, 1.0)):
    """Normal clouds, the JAX test's (tests/test_knn_fused.py), scaled per
    axis where a test needs a box of other proportions."""
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, S, 3) * scale).astype(np.float32)
    x = (rng.randn(B, N, 3) * scale).astype(np.float32)
    return q, x


@pytest.mark.parametrize("seed", [0, 1])
def test_codes_and_bounds_bit_equal(seed):
    q, x = _clouds(seed, 2, 512, 768, scale=(20.0, 2.0, 15.0))
    # corners and faces of the box: the clip at both ends
    x[:, :8] = np.array([[lo, hi, lo] for lo, hi in
                         ((-60, 60), (60, -60), (0, 0), (-60, -60),
                          (60, 60), (1, -1), (-1, 1), (0, 60))],
                        np.float32)
    lo_j, hi_j = jax_morton.joint_bounds(jnp.asarray(q), jnp.asarray(x))
    lo, hi = morton.joint_bounds(torch.from_numpy(q), torch.from_numpy(x))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(hi_j))
    for cloud in (q, x):
        want = np.asarray(jax_morton.morton_codes(jnp.asarray(cloud), lo_j,
                                                  hi_j)).astype(np.int64)
        got = morton.morton_codes(torch.from_numpy(cloud), lo, hi)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got.max()) < 2 ** 30 and int(got.min()) >= 0


def test_window_starts_equal():
    """The JAX module computes the starts inside knn_block_dist; here they
    are its steps written out in numpy on the JAX codes."""
    q, x = _clouds(3, 2, 1024, 2048)
    window, block = 256, 128
    lo, hi = jax_morton.joint_bounds(jnp.asarray(q), jnp.asarray(x))
    cq = np.asarray(jax_morton.morton_codes(jnp.asarray(q), lo, hi))
    ck = np.asarray(jax_morton.morton_codes(jnp.asarray(x), lo, hi))
    cq_s = np.sort(cq, axis=1, kind="stable")
    ck_s = np.sort(ck, axis=1, kind="stable")
    want = np.stack([np.clip(np.searchsorted(ck_s[b], cq_s[b, block // 2::
                                                              block])
                             - window // 2, 0, x.shape[1] - window)
                     for b in range(2)])
    got = morton.window_starts(torch.from_numpy(cq.astype(np.int64)),
                               torch.from_numpy(ck.astype(np.int64)),
                               window, block)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,window,block", [(16, 256, 128), (8, 512, 256)])
def test_knn_block_dist_matches_jax(k, window, block):
    q, x = _clouds(k + window, 2, 1024, 1536)
    d_j, i_j = jax_morton.knn_block_dist(k, jnp.asarray(x), jnp.asarray(q),
                                         window=window, block=block)
    d, i = morton.knn_block_dist(k, torch.from_numpy(x), torch.from_numpy(q),
                                 window=window, block=block)
    assert i.dtype == torch.int32 and i.shape == (2, 1024, k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    # float32 expansions summed in another order: their rounding scales
    # with |q|^2 (about 1e-6 here, 1e-4 on clouds 20 m wide)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=0,
                               atol=1e-5)


def test_recall_moderate_not_production():
    """The JAX test's band (tests/test_knn_fused.py): locality works, but
    the recall is far below an exact search's."""
    rng = np.random.RandomState(0)
    q = rng.randn(1, 1024, 3).astype(np.float32)
    x = rng.randn(1, 1024, 3).astype(np.float32)
    _, approx = morton.knn_block_dist(16, torch.from_numpy(x),
                                      torch.from_numpy(q), window=256,
                                      block=128)
    _, ie = knn_point_dist(16, jnp.asarray(x), jnp.asarray(q),
                           method="exact", precision="highest")
    _, ip = knn_plain(16, torch.from_numpy(x), torch.from_numpy(q))
    for exact in (torch.from_numpy(np.asarray(ie)), ip):
        recall = float((approx[..., :, None] == exact[..., None, :])
                       .any(-1).float().mean())
        assert 0.5 < recall < 1.0


def test_refuses_what_it_does_not_take():
    q, x = _clouds(5, 1, 300, 512)
    with pytest.raises(ValueError, match="block"):
        morton.knn_block_dist(8, torch.from_numpy(x), torch.from_numpy(q),
                              window=256, block=128)
    q, x = _clouds(5, 1, 256, 200)
    with pytest.raises(ValueError, match="window"):
        morton.knn_block_dist(8, torch.from_numpy(x), torch.from_numpy(q),
                              window=256, block=128)
