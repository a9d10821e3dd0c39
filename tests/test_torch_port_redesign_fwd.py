"""The rules the redesigned FPS and pool-forward CUDA kernels implement,
held on the CPU against the port's plain versions and the JAX package.

The kernels run only on a card (tests/test_torch_port_card_kernels.py
holds them there bit for bit and within 1e-4 x max|plain|); these tests hold their arithmetic, emulated
in torch beside the plain versions:

- FPS: fps_cluster (a cloud split over G blocks x 32 / G warps x 32 lanes
  as the kernel splits it, packed keys, the lane's first maximum, the
  warp's smallest index among its largest keys, the cluster's first slot
  with the largest key) equals fps_plain and the JAX package's FPS bit for
  bit for every G, on seeded clouds, on duplicated points whose ties fall
  in other lanes, warps and blocks, and at N = 8000 (padding);
- the FPS launch plan runs the clouds of the eval, train and KD forwards
  in one wave on an H100's 132 SMs;
- pool forward: pool_tiled (passes of queries x 32 slots, K in chunks of
  32, empty slots and queries left out of the max, p summed over the
  kernel's i-tiles) equals pool_plain and JAX's Pallas pool in interpret
  mode, at every width the kernel takes (C = 16 also against the Pallas
  pool on 8 queries lane-packed to a row, as the JAX package runs it),
  ragged K and N1 included; its tiles fit the blocks an SM its launch
  bounds aim at.

Inputs come from numpy seeds; every tolerance is stated where it is used.
"""

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd_pointcloud_tpu.ops.fps import _furthest_point_sample_xla
from kd_pointcloud_tpu.ops.gather import (group_points_kmajor,
                                          group_points_kmajor_packed)
from kd_pointcloud_tpu.ops.pallas import pool_fused as jax_pool
from kd_pointcloud_tpu.ops.pallas.fps_pallas import furthest_point_sample_pallas
from kd_pointcloud_tpu_torch.models import PRESETS
from kd_pointcloud_tpu_torch.ops import fps as fps_mod
from kd_pointcloud_tpu_torch.ops.fps import fps_cluster, fps_plain, fps_plan
from kd_pointcloud_tpu_torch.ops.pool_fused import (KERNEL_C, pool_plain,
                                                    pool_shape, pool_tiled)

torch.set_num_threads(1)
CSRC = Path(fps_mod.__file__).resolve().parent.parent / "csrc"
# clusters of G blocks of the FPS kernel resident at once (one block an
# SM), by cudaOccupancyMaxActiveClusters (ops/fps.py card_clusters) on an
# NVIDIA H100 80GB HBM3: the GPCs hold 15 clusters of 8, not 16
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------------- FPS

def _clouds(case):
    rng = np.random.RandomState(len(case))
    if case == "seeded":
        return (20 * rng.uniform(-1, 1, (2, 2048, 3))).astype(np.float32), 256
    if case == "ties":
        # 200 points repeated to 4096: copy c of point i is point 200 c + i,
        # so equal distances fall in other lanes, warps and (at every
        # G > 1) blocks; past 200 rounds every distance is 0
        base = rng.uniform(-1, 1, (2, 200, 3)).astype(np.float32)
        return np.ascontiguousarray(np.tile(base, (1, 21, 1))[:, :4096]), 260
    # N = 8000: the last warps of the cloud are padding (TPU row 1b)
    return (20 * rng.uniform(-1, 1, (2, 8000, 3))).astype(np.float32), 96


@pytest.mark.parametrize("case", ["seeded", "ties", "n8000"])
@pytest.mark.parametrize("blocks", fps_mod.CLUSTER_SIZES)
def test_fps_cluster_equals_plain_and_jax(blocks, case):
    xyz, m = _clouds(case)
    got = fps_cluster(_t(xyz), m, blocks)
    want = fps_plain(_t(xyz), m)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(_furthest_point_sample_xla(jnp.asarray(xyz),
                                                           m)))


def test_fps_cluster_ties_are_real():
    """The tie case is what it claims: the first copy of each point is
    picked, never a later one, while copies tie at every round."""
    xyz, m = _clouds("ties")
    got = fps_cluster(_t(xyz), m, 8).numpy()
    assert (got[:, :200] < 200).all()
    assert len(set(got[0, :200].tolist())) == 200
    assert (got[:, 200:] == 0).all()


def test_fps_pallas_interpret_at_n8000():
    """The TPU kernel's N % 1024 != 0 body (row 1b) in interpret mode
    against the emulation of the cluster kernel."""
    xyz, _ = _clouds("n8000")
    got = fps_cluster(_t(xyz), 48, fps_mod.MAX_CLUSTER)
    want = furthest_point_sample_pallas(jnp.asarray(xyz), 48, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fps_constants_match_the_kernel():
    text = (CSRC / "fps.cu").read_text()
    assert f"kCloudThreads = {fps_mod.CLOUD_THREADS};" in text
    for g in fps_mod.CLUSTER_SIZES:
        assert f"case {g}: return (int)launch_g<{g}>" in text
    # G = 1's slice of 16 points a thread fills 192 kB, under 227 kB
    assert 3 * 4 * fps_mod.ONE_BLOCK_POINTS <= 227 * 1024


@pytest.mark.parametrize("batch", [1, 3, 8], ids=["eval", "train", "kd"])
def test_fps_plan_runs_the_path_in_one_wave(batch):
    """The forward samples both clouds of a pair in one launch: B = 2, 6
    and 16 clouds of 8192 points."""
    B, N = 2 * batch, PRESETS["teacher"].npoints[0]
    g = fps_plan(B, N, H100_CLUSTERS.get)
    assert g in fps_mod.CLUSTER_SIZES and g <= fps_mod.MAX_CLUSTER
    assert B * g <= fps_mod.SMS and B <= H100_CLUSTERS[g]
    # the largest such G: the next size would not fit in one wave
    bigger = [x for x in fps_mod.CLUSTER_SIZES if g < x <= fps_mod.MAX_CLUSTER]
    assert all(B * x > fps_mod.SMS or B > H100_CLUSTERS[x] for x in bigger)


def test_fps_plan_picks():
    clusters = H100_CLUSTERS.get
    assert [fps_plan(B, 8192, clusters) for B in (2, 6, 16)] == [8, 8, 4]
    assert fps_plan(132, 8192, clusters) == 1
    assert fps_plan(200, 8192, clusters) == 1      # more than one wave
    assert fps_plan(200, 20000, clusters) == 2     # G = 1 cannot hold it
    with pytest.raises(ValueError):
        fps_plan(2, 32 * 1024 + 1, clusters)


# ---------------------------------------------------------------- pool forward

def _pool_case(c, k, seed, B=2, n1=37, n2=50):
    """n1 = 37 leaves the last pass of queries ragged at every width."""
    rng = np.random.RandomState(seed)
    u = rng.standard_normal((B, n2, c)).astype(np.float32)
    v = rng.standard_normal((B, n1, c)).astype(np.float32)
    idx = rng.randint(0, n2, (B, n1, k)).astype(np.int32)
    w = (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32)  # in, out
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return u, idx, v, w, b


@pytest.mark.parametrize("k", [9, 16, 32, 40])
@pytest.mark.parametrize("c", KERNEL_C)
def test_pool_tiled_equals_plain_and_pallas_interpret(c, k, monkeypatch):
    monkeypatch.setattr(jax_pool.pl, "pallas_call",
                        functools.partial(jax_pool.pl.pallas_call,
                                          interpret=True))
    u, idx, v, w, b = _pool_case(c, k, seed=c + k)
    args = (_t(u), _t(idx), _t(v), _t(w.T), _t(b))
    got = pool_tiled(*args).numpy()
    want = jax_pool._pool_pallas(group_points_kmajor(u, idx), jnp.asarray(v),
                                 (jnp.asarray(w),), (jnp.asarray(b),), 0)
    # float32 sums in another order (the i-tiles, cuBLAS / XLA dots): 1e-5
    # of the output's largest magnitude
    for ref in (pool_plain(*args).numpy(), np.asarray(want)):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("k", [16, 32])
def test_pool_tiled_at_c16_equals_pallas_lane_packed(k, monkeypatch):
    """C = 16, the student's l0 width: the JAX package packs 8 queries to a
    128-lane row (nn/cross.py _pool_gather, group_points_kmajor_packed) and
    runs the Pallas pool at packed_p = 8; pool_tiled and pool_plain give
    its output (n1 = 40, a multiple of 8)."""
    monkeypatch.setattr(jax_pool.pl, "pallas_call",
                        functools.partial(jax_pool.pl.pallas_call,
                                          interpret=True))
    u, idx, v, w, b = _pool_case(16, k, seed=16 + k, n1=40)
    args = (_t(u), _t(idx), _t(v), _t(w.T), _t(b))
    got = pool_tiled(*args).numpy()
    want = jax_pool._pool_pallas(group_points_kmajor_packed(u, idx, 8),
                                 jnp.asarray(v), (jnp.asarray(w),),
                                 (jnp.asarray(b),), 0, packed_p=8)
    # float32 sums in another order: 1e-5 of the largest magnitude
    for ref in (pool_plain(*args).numpy(), np.asarray(want)):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_pool_tiled_leaves_empty_slots_out_of_the_max():
    """Slots past K hold zero rows, whose p is the bias. With u + v > 0.5
    and w = -I, every real p lies below the bias, so a tile that let an
    empty slot into the max would return leaky(bias)."""
    u, idx, v, _, b = _pool_case(32, 9, seed=5)
    u, v = np.abs(u) + 0.25, np.abs(v) + 0.25
    w = -np.eye(32, dtype=np.float32)
    args = (_t(u), _t(idx), _t(v), _t(w), _t(b))
    got, want = pool_tiled(*args), pool_plain(*args)
    # float32 sums in another order: 1e-5 of the largest magnitude
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert bool((got < torch.nn.functional.leaky_relu(_t(b), 0.1)).all())


@pytest.mark.parametrize("c", KERNEL_C)
def test_pool_shape_matches_the_kernel_and_fits_its_blocks(c):
    text = (CSRC / "pool_fused.cu").read_text()
    assert "constexpr int kThreads = 256;" in text
    assert "constexpr int kSlots = 32;" in text
    assert "kIT = C == 256 ? 16 : (kWTiled ? 32 : C);" in text
    assert "kBlocksSM = kWTiled ? 1 : 2;" in text
    shape = pool_shape(c)
    # 8 slots x 8 channels a thread over all C channels of 32 slots
    assert shape["queries"] * 32 * c == 256 * 64
    assert shape["w_tiled"] == (c > 64) and c % shape["i_tile"] == 0
    # the SM's 228 kB of shared memory hold the blocks the launch bounds
    # aim at, 1 kB reserved a block; a block may use 227 kB
    assert shape["smem_bytes"] <= 227 * 1024
    assert shape["blocks_sm"] * (shape["smem_bytes"] + 1024) <= 228 * 1024
