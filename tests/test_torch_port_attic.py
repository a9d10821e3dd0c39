"""The port's attic kernels' plain versions against the JAX package's attic
kernels run in interpret mode, on the CPU.

- Pruned FPS (kd_pointcloud_tpu_torch/attic/fps_pruned.py, TPU row 5):
  fps_pruned_plain makes the CUDA kernel's skip decisions in torch, so a
  skip that was not a no-op would change the indices. Its indices must be
  bit-identical to attic/fps_pruned.py's kernel in interpret mode (at
  tests/test_ops.py's shapes and clustered clouds, where windows do prune)
  and to the port's fps_plain, on clustered, uniform and tied clouds.
- The L-layer cross pool (attic/cross_pool.py, TPU row 6): cross_pool_plain
  against the Pallas kernel in interpret mode at L in {1, 2}, within 1e-5
  abs (float32 sums in another order), and at L = 1 equal to the port's
  pool_plain, which computes the same function with the same ops.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attic import cross_pool as jax_cross_pool
from attic.fps_pruned import furthest_point_sample_pruned as jax_fps_pruned
from kd_pointcloud_tpu_torch.attic import (cross_pool_fused, cross_pool_plain,
                                           fps_pruned_plain,
                                           furthest_point_sample_pruned,
                                           spatial_permutation)
from kd_pointcloud_tpu_torch.attic import cross_pool as port_cross_pool
from kd_pointcloud_tpu_torch.attic import fps_pruned as port_fps_pruned
from kd_pointcloud_tpu_torch.ops.fps import fps_plain
from kd_pointcloud_tpu_torch.ops.pool_fused import pool_plain

torch.set_num_threads(1)


def _clustered(rng, B, N):
    """16 clusters of N / 16 points, 20 apart: windows prune."""
    cent = rng.randn(B, 16, 1, 3) * 20
    return (cent + rng.randn(B, 16, N // 16, 3)).reshape(B, N, 3).astype(
        np.float32)


@pytest.mark.parametrize("B,N,npoint", [(1, 2048, 192), (2, 1024, 160)])
def test_pruned_plain_matches_pallas_interpret(B, N, npoint):
    xyz = _clustered(np.random.RandomState(N + B), B, N)
    want = np.asarray(jax_fps_pruned(jnp.asarray(xyz), npoint,
                                     interpret=True))
    got, dirty = fps_pruned_plain(torch.from_numpy(xyz), npoint,
                                  return_dirty=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  fps_plain(torch.from_numpy(xyz),
                                            npoint).numpy())
    # the pruning ran: over a tenth of the sub-block updates were skipped
    assert int(dirty.max()) < 0.9 * (npoint - 1) * (N // 128)


@pytest.mark.parametrize("kind", ["uniform", "ties", "clustered"])
def test_pruned_plain_matches_fps_plain(kind):
    rng = np.random.RandomState(7)
    B, N, npoint = 2, 4096, 300
    if kind == "uniform":
        xyz = rng.uniform(-30, 30, (B, N, 3)).astype(np.float32)
    elif kind == "clustered":
        xyz = _clustered(rng, B, N)
    else:   # every point twice, at shuffled positions: exact ties
        half = rng.uniform(-5, 5, (B, N // 2, 3)).astype(np.float32)
        xyz = np.concatenate([half, half], 1)[:, rng.permutation(N)]
    xyz = torch.from_numpy(np.ascontiguousarray(xyz))
    got = furthest_point_sample_pruned(xyz, npoint)
    assert got.dtype == torch.int32 and got.shape == (B, npoint)
    assert torch.equal(got, fps_plain(xyz, npoint))


def test_spatial_permutation_layout():
    rng = np.random.RandomState(3)
    xyz = torch.from_numpy(_clustered(rng, 2, 2048))
    lay = spatial_permutation(xyz)
    B, N = 2, 2048
    K = N // port_fps_pruned.SUB
    assert lay.planes.shape == (B, 3, N) and lay.pidx.dtype == torch.int32
    assert lay.centers.shape == (B, K, 3) and lay.radii.shape == (B, K)
    for b in range(B):
        assert torch.equal(lay.pidx[b].sort().values,
                           torch.arange(N, dtype=torch.int32))
    pidx = lay.pidx.long()
    np.testing.assert_array_equal(
        lay.planes.transpose(1, 2).numpy(),
        torch.gather(xyz, 1, pidx[..., None].expand(B, N, 3)).numpy())
    blocks = pidx.reshape(B, K, -1)
    assert bool((blocks[..., 1:] > blocks[..., :-1]).all())
    pts = lay.planes.transpose(1, 2).reshape(B, K, -1, 3)
    dist = ((pts - lay.centers[:, :, None]) ** 2).sum(-1).sqrt()
    assert bool((dist <= lay.radii[..., None]).all())


def test_pruned_fps_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="1024"):
        furthest_point_sample_pruned(torch.zeros(1, 1000, 3), 8)
    with pytest.raises(ValueError, match="CUDA"):
        port_fps_pruned._fps_pruned_cuda(torch.zeros(1, 1024, 3), 8)


def _pool_case(seed, c, n_layers, B=2, N=64, K=8):
    rng = np.random.RandomState(seed)
    u = rng.standard_normal((B, N, c)).astype(np.float32)
    v = rng.standard_normal((B, N, c)).astype(np.float32)
    idx = rng.randint(0, N, (B, N, K)).astype(np.int32)
    ws = [(rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32)
          for _ in range(n_layers)]                        # (in, out)
    bs = [(0.1 * rng.standard_normal(c)).astype(np.float32)
          for _ in range(n_layers)]
    return u, v, idx, ws, bs


@pytest.mark.parametrize("c,n_layers", [(32, 1), (32, 2), (64, 2)])
def test_cross_pool_plain_matches_pallas_interpret(c, n_layers):
    u, v, idx, ws, bs = _pool_case(c + n_layers, c, n_layers)
    want = np.asarray(jax_cross_pool.cross_pool_fused(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(idx), ws, bs,
        interpret=True))
    t = torch.from_numpy
    got = cross_pool_fused(t(u), t(v), t(idx), [t(w.T.copy()) for w in ws],
                           [t(b) for b in bs])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_cross_pool_one_layer_is_pool_plain():
    u, v, idx, (w,), (b,) = _pool_case(0, 32, 1, N=48)
    t = torch.from_numpy
    w = t(w.T.copy())
    assert torch.equal(cross_pool_plain(t(u), t(v), t(idx), [w], [t(b)]),
                       pool_plain(t(u), t(idx), t(v), w, t(b)))


def test_cross_pool_refuses_gradients_and_bad_shapes():
    u, v, idx, ws, bs = _pool_case(1, 32, 2)
    t = torch.from_numpy
    w = [t(x.T.copy()) for x in ws]
    b = [t(x) for x in bs]
    with pytest.raises(RuntimeError, match="forward only"):
        cross_pool_fused(t(u).requires_grad_(), t(v), t(idx), w, b)
    with pytest.raises(ValueError):
        cross_pool_fused(t(u), t(v), t(idx), w, b[:1])
    with pytest.raises(ValueError, match="CUDA"):
        port_cross_pool._cross_pool_cuda(t(u), t(v), t(idx), w, b)
