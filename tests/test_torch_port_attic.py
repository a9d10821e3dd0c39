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
- The redesigned kernels' walks: fps_pruned_split (the cloud's sub-blocks
  over 1, 2 or 4 blocks, cached winners with their coordinates, folds by
  largest bm then smallest index) bit-equal to fps_pruned_plain in indices
  and sub-block updates; fps_pruned_plan at every N the wrapper takes;
  spatial_permutation's sub-blocks and their slot order against the JAX
  package's; cross_pool_tiled (the pool kernel's passes and i-tiles over L
  layers written back in place) bit-equal to pool_tiled at L = 1 and
  within 1e-5 of the output's largest magnitude of cross_pool_plain and
  the Pallas kernel in interpret mode at L = 1-3, C = 16-256;
  cross_pool_shape against the kernel's constants.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attic import cross_pool as jax_cross_pool
from attic import fps_pruned as jax_fps_pruned_mod
from attic.fps_pruned import furthest_point_sample_pruned as jax_fps_pruned
from kd_pointcloud_tpu_torch.attic import (cross_pool_fused, cross_pool_plain,
                                           fps_pruned_plain,
                                           furthest_point_sample_pruned,
                                           spatial_permutation)
from kd_pointcloud_tpu_torch.attic import cross_pool as port_cross_pool
from kd_pointcloud_tpu_torch.attic import fps_pruned as port_fps_pruned
from kd_pointcloud_tpu_torch.ops.fps import fps_plain
from kd_pointcloud_tpu_torch.ops.pool_fused import (KERNEL_C, pool_plain,
                                                    pool_tiled)

CSRC = Path(port_fps_pruned.__file__).resolve().parent.parent / "csrc"

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


# ------------------------------------------------------- the kernels' walks

@pytest.mark.parametrize("kind", ["clustered", "ties"])
@pytest.mark.parametrize("blocks", [1, 2, 4])
def test_pruned_split_equals_plain(kind, blocks):
    """The kernel's split of a cloud over blocks and its folds, with the
    cached winners' coordinates feeding the next round: indices and
    sub-block updates bit-equal to fps_pruned_plain (2048 points: 16
    sub-blocks, 16 / 8 / 4 a block)."""
    rng = np.random.RandomState(blocks)
    B, N, npoint = 2, 2048, 256
    if kind == "clustered":
        xyz = _clustered(rng, B, N)
    else:   # every point twice: ties inside and across sub-blocks, blocks
        half = rng.uniform(-5, 5, (B, N // 2, 3)).astype(np.float32)
        xyz = np.concatenate([half, half], 1)[:, rng.permutation(N)]
    xyz = torch.from_numpy(np.ascontiguousarray(xyz))
    want, want_dirty = fps_pruned_plain(xyz, npoint, return_dirty=True)
    got, dirty = port_fps_pruned.fps_pruned_split(xyz, npoint, blocks)
    assert torch.equal(got, want) and torch.equal(dirty, want_dirty)
    assert int(dirty.max()) < (npoint - 1) * (N // 128)   # pruning ran


def test_pruned_plan_covers_every_n():
    text = (CSRC / "fps_pruned.cu").read_text()
    assert "constexpr int kBlockSub = 64;" in text
    assert "constexpr int kPointBytes = 20;" in text
    assert port_fps_pruned.BLOCK_SUB == 64
    for n in range(1024, port_fps_pruned.MAX_N + 1, 1024):
        g, nb = port_fps_pruned.fps_pruned_plan(n)
        assert g in (1, 2, 4) and g * nb == n // 128
        # the fewest blocks whose shares fit a block's 227 kB
        assert nb <= 64 and (g == 1 or n // 128 / (g // 2) > 64)
        assert nb * 128 * port_fps_pruned.POINT_BYTES <= 227 * 1024
    assert port_fps_pruned.fps_pruned_plan(8192) == (1, 64)
    assert port_fps_pruned.fps_pruned_plan(32768) == (4, 64)


@pytest.mark.parametrize("B,N", [(1, 2048), (2, 3072)])
def test_spatial_permutation_matches_jax_slots(B, N):
    """The port's sub-blocks, in slot order, hold the same points as the
    JAX package's slots, with the same centres and radii (float32 sums in
    another order: 1e-5 relative)."""
    xyz = _clustered(np.random.RandomState(N + B), B, N)
    g, ordc, ordr = (np.asarray(a) for a in jax_fps_pruned_mod.
                     _spatial_permutation(jnp.asarray(xyz), N // 1024))
    lay = spatial_permutation(torch.from_numpy(xyz))
    K = N // 128
    p = np.arange(N)
    lane = p % (N // 8)
    slot = lane // 128 * 8 + p // (N // 8)
    for b in range(B):
        want = [sorted(g[b, slot == i]) for i in range(K)]
        got = lay.pidx[b].reshape(K, 128).tolist()
        assert got == want
    np.testing.assert_allclose(lay.centers.numpy(), ordc, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lay.radii.numpy(), ordr, rtol=1e-5)


def _layers_case(seed, c, n_layers, B=2, n1=37, n2=45, k=40):
    """n1 = 37 leaves the last pass ragged at every width; K = 40 takes
    two chunks of 32 slots."""
    rng = np.random.RandomState(seed)
    u = rng.standard_normal((B, n2, c)).astype(np.float32)
    v = rng.standard_normal((B, n1, c)).astype(np.float32)
    idx = rng.randint(0, n2, (B, n1, k)).astype(np.int32)
    ws = [(rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32)
          for _ in range(n_layers)]                        # (out, in)
    bs = [(0.1 * rng.standard_normal(c)).astype(np.float32)
          for _ in range(n_layers)]
    t = torch.from_numpy
    return t(u), t(v), t(idx), [t(w) for w in ws], [t(b) for b in bs]


@pytest.mark.parametrize("c", KERNEL_C)
def test_cross_pool_tiled_at_one_layer_is_pool_tiled(c):
    u, v, idx, ws, bs = _layers_case(c, c, 1)
    assert torch.equal(port_cross_pool.cross_pool_tiled(u, v, idx, ws, bs),
                       pool_tiled(u, idx, v, ws[0], bs[0]))


@pytest.mark.parametrize("n_layers", [1, 2, 3])
@pytest.mark.parametrize("c", KERNEL_C)
def test_cross_pool_tiled_matches_plain_and_pallas(c, n_layers):
    u, v, idx, ws, bs = _layers_case(c + n_layers, c, n_layers, n2=37)
    got = port_cross_pool.cross_pool_tiled(u, v, idx, ws, bs).numpy()
    want = np.asarray(jax_cross_pool.cross_pool_fused(
        jnp.asarray(u.numpy()), jnp.asarray(v.numpy()),
        jnp.asarray(idx.numpy()), [w.numpy().T for w in ws],
        [b.numpy() for b in bs], interpret=True))
    # float32 sums in another order (the i-tiles, torch / XLA dots): 1e-5
    # of the output's largest magnitude
    for ref in (cross_pool_plain(u, v, idx, ws, bs).numpy(), want):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("c", KERNEL_C)
def test_cross_pool_shape_matches_the_kernel_and_fits(c):
    text = (CSRC / "cross_pool.cu").read_text()
    assert "kIT = C == 256 ? 16 : (C > 64 ? 32 : C);" in text
    assert "__launch_bounds__(kThreads, 1)" in text
    assert "constexpr int kMaxSmem = 227 * 1024;" in text
    one, two = (port_cross_pool.cross_pool_shape(c, n) for n in (1, 2))
    assert one["resident"] == two["resident"] == (c <= 64)
    for shape in (one, two):
        # two blocks of one and two layers fit an SM's 228 kB, 1 kB
        # reserved a block (the launch bounds ask for one)
        assert 2 * (shape["smem_bytes"] + 1024) <= 228 * 1024
        assert shape["queries"] * 32 * c == 256 * 64
    # past what a block holds, the layers stream through two tiles
    many = port_cross_pool.cross_pool_shape(c, 200)
    assert not many["resident"] and many["smem_bytes"] <= 227 * 1024
