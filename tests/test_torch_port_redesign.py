"""The rules the redesigned kNN and pool-backward CUDA kernels implement,
held on the CPU against the port's plain versions and the JAX package.

The kernels run only on a card (tests/test_torch_port_card_kernels.py
holds them there bit for bit and within POOL_BWD_TOL); these tests hold their arithmetic, emulated in
torch beside the plain versions:

- kNN: knn_striped (L lanes a query, keys in steps of L consecutive
  indices, each step's candidates merged into one sorted list lowest lane
  first) equals knn_plain bit for bit for every k and every L the launch
  plan can pick, and its indices equal JAX's exact kNN, on seeded clouds
  and on ties whose equal-distance keys fall in different lanes;
- the launch plan fits the card at every call site of the eval, train and
  KD paths;
- pool backward: pool_bwd_masked (d_h0, d_w, d_bias formed only at the max
  mask's entries) equals autograd of pool_plain and JAX's Pallas backward
  in interpret mode, with exact ties, at K = 16 and K = 32, and at C = 16
  against the lane-packed Pallas backward (packed_p = 8).

Inputs come from numpy seeds; every tolerance is stated where it is used.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd_pointcloud_tpu.ops.gather import (group_points_kmajor,
                                          group_points_kmajor_packed)
from kd_pointcloud_tpu.ops.knn import knn_point_dist as jax_knn_dist
from kd_pointcloud_tpu.ops.pallas import pool_fused as jax_pool
from kd_pointcloud_tpu_torch.models import PRESETS
from kd_pointcloud_tpu_torch.ops import knn as knn_mod
from kd_pointcloud_tpu_torch.ops.distance import square_distance
from kd_pointcloud_tpu_torch.ops.knn import knn_plain, knn_plan, knn_striped
from kd_pointcloud_tpu_torch.ops.pool_fused import pool_bwd_masked, pool_plain

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------------- kNN

# the k of the model's paths
PATH_K = (3, 5, 9, 10, 16, 32)
# a sweep of KERNEL_K (1..64) beyond them: 1, 2, a lane count +- 1, the
# inventory's 8 and 64, and 33-64 at two list entries a lane. Not every k
# of 1..64: that would multiply the cases.
SWEEP_K = (1, 2, 7, 8, 24, 31, 33, 48, 63, 64)


def _lanes_the_plan_picks(k):
    return [L for L in knn_mod.KERNEL_LANES
            if (L == 1 and k == knn_mod.ONE_LANE_K)
            or L >= max(min(k, 32), 4)]


KNN_CASES = [(k, L) for k in PATH_K for L in _lanes_the_plan_picks(k)]
SWEEP_CASES = [(k, L) for k in SWEEP_K for L in _lanes_the_plan_picks(k)]


def _jax_idx(k, keys, query):
    return np.asarray(jax_knn_dist(k, jnp.asarray(keys), jnp.asarray(query),
                                   method="exact")[1])


@pytest.mark.parametrize("k,lanes", KNN_CASES,
                         ids=[f"k{k}-L{L}" for k, L in KNN_CASES])
def test_knn_striped_equals_plain_and_jax_exact(k, lanes):
    rng = np.random.RandomState(100 * k + lanes)
    # N off every multiple of L: the last step is ragged, as a tile's is
    keys = rng.uniform(-1, 1, (2, 301, 3)).astype(np.float32)
    query = rng.uniform(-1, 1, (2, 40, 3)).astype(np.float32)
    d_got, i_got = knn_striped(k, _t(keys), _t(query), lanes)
    d_want, i_want = knn_plain(k, _t(keys), _t(query))
    assert torch.equal(d_got, d_want) and torch.equal(i_got, i_want)
    np.testing.assert_array_equal(i_got.numpy(), _jax_idx(k, keys, query))


def _tied_cloud(rng, groups):
    """Keys in groups of 4 that mirror one point in x and y, at shuffled
    indices; queries on the z axis. Then q.k and |k|^2 are the same floats
    within a group in every summation order, so each group's 4 distances
    tie exactly, in the port and in JAX."""
    base = rng.uniform(0.1, 1, (groups, 3)).astype(np.float32)
    signs = np.array([[1, 1], [-1, 1], [1, -1], [-1, -1]], np.float32)
    keys = np.concatenate([base[:, None, :2] * signs[None],
                           np.repeat(base[:, None, 2:], 4, 1)], -1)
    keys = keys.reshape(-1, 3)[rng.permutation(4 * groups)]
    query = np.zeros((12, 3), np.float32)
    query[:, 2] = rng.uniform(-1, 1, 12)
    return keys[None], query[None]


@pytest.mark.parametrize("k,lanes", SWEEP_CASES,
                         ids=[f"k{k}-L{L}" for k, L in SWEEP_CASES])
def test_knn_striped_sweep_equals_plain(k, lanes):
    """Every k of the sweep on generic floats: the kernel's rule (two
    entries a lane above k = 32) bit-equal to knn_plain. JAX's exact kNN
    is held in the next test, on floats where both sides' expansions are
    exact: on generic floats its matrix product rounds a few ulps apart
    from the port's per-op expansion, which can swap two neighbours whose
    distances differ by less than that."""
    rng = np.random.RandomState(100 * k + lanes)
    keys = rng.uniform(-1, 1, (2, 301, 3)).astype(np.float32)
    query = rng.uniform(-1, 1, (2, 40, 3)).astype(np.float32)
    d_got, i_got = knn_striped(k, _t(keys), _t(query), lanes)
    d_want, i_want = knn_plain(k, _t(keys), _t(query))
    assert torch.equal(d_got, d_want) and torch.equal(i_got, i_want)


def _dyadic_cloud(rng, n_keys, n_query):
    """Coordinates on a 1/64 grid in [-1, 1], a third of the keys copies
    of others at shuffled indices: every product and sum of the expansion
    is exact in float32 in any order, so the port's and JAX's distances
    are the same floats and equal distances (duplicates, and grid points
    at equal distance) tie exactly on both sides."""
    keys = rng.randint(-64, 65, (2, n_keys, 3)).astype(np.float32) / 64
    dup = rng.choice(n_keys, n_keys // 3, replace=False)
    keys[:, dup] = keys[:, rng.choice(n_keys, n_keys // 3)]
    query = rng.randint(-64, 65, (2, n_query, 3)).astype(np.float32) / 64
    return keys, query


@pytest.mark.parametrize("k,lanes", SWEEP_CASES,
                         ids=[f"k{k}-L{L}" for k, L in SWEEP_CASES])
def test_knn_striped_sweep_matches_jax_on_exact_floats(k, lanes):
    keys, query = _dyadic_cloud(np.random.RandomState(7 * k + lanes), 301,
                                40)
    d_got, i_got = knn_striped(k, _t(keys), _t(query), lanes)
    d_want, i_want = knn_plain(k, _t(keys), _t(query))
    assert torch.equal(d_got, d_want) and torch.equal(i_got, i_want)
    jd, ji = jax_knn_dist(k, jnp.asarray(keys), jnp.asarray(query),
                          method="exact")
    np.testing.assert_array_equal(i_got.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(d_got.numpy(), np.asarray(jd))
    _assert_ties_keep_the_lower_index(k, keys, query, d_got, i_got)


def _assert_ties_keep_the_lower_index(k, keys, query, d_got, i_got):
    """The case is what it claims: exact ties inside the lists, listed
    lower index first; at k = 1 a tie for the nearest key, won by the
    lowest index."""
    d, i = d_got.numpy(), i_got.numpy()
    if k == 1:
        full = square_distance(_t(query), _t(keys)).numpy()
        tie = (full == full.min(-1, keepdims=True)).sum(-1) > 1
        assert tie.any()
        np.testing.assert_array_equal(i[..., 0], full.argmin(-1))
        return
    tie = d[..., 1:] == d[..., :-1]
    assert tie.any() and (i[..., 1:] > i[..., :-1])[tie].all()


@pytest.mark.parametrize("k,lanes", KNN_CASES + SWEEP_CASES,
                         ids=[f"k{k}-L{L}"
                              for k, L in KNN_CASES + SWEEP_CASES])
def test_knn_striped_ties_across_lanes_keep_the_lower_index(k, lanes):
    keys, query = _tied_cloud(np.random.RandomState(k + lanes), 40)
    d_got, i_got = knn_striped(k, _t(keys), _t(query), lanes)
    d_want, i_want = knn_plain(k, _t(keys), _t(query))
    assert torch.equal(d_got, d_want) and torch.equal(i_got, i_want)
    np.testing.assert_array_equal(i_got.numpy(), _jax_idx(k, keys, query))
    # the case is what it claims: tied neighbours found by different lanes,
    # listed lower index first
    _assert_ties_keep_the_lower_index(k, keys, query, d_got, i_got)
    d, i = d_got[0].numpy(), i_got[0].numpy()
    tie = d[:, 1:] == d[:, :-1]
    if lanes > 1 and k > 1:
        assert ((i[:, 1:] % lanes) != (i[:, :-1] % lanes))[tie].any()


def _path_knn_sites(batch):
    """(B, S, N, k) of the 19 kNN call sites of one teacher forward at
    8192 points (tests/test_torch_port_card_kernels.py records them): the
    cloud pair stacked (2 batch) where both clouds search, batch alone
    where one does."""
    n0, n1, n2, n3, n4 = PRESETS["teacher"].npoints
    two, one = 2 * batch, batch
    return [(two, n1, n0, 16), (two, n2, n1, 16), (two, n3, n2, 16),
            (two, n4, n3, 16), (two, n3, n4, 3), (two, n3, n3, 32),
            (one, n3, n3, 9), (two, n2, n3, 3), (one, n2, n2, 3),
            (two, n2, n2, 32), (one, n2, n2, 9), (two, n1, n2, 3),
            (one, n1, n1, 3), (two, n1, n1, 32), (one, n1, n1, 9),
            (two, n0, n1, 3), (one, n0, n0, 3), (two, n0, n0, 32),
            (one, n0, n0, 9)]


@pytest.mark.parametrize("batch", [1, 3, 8], ids=["eval", "train", "kd"])
def test_knn_plan_fits_the_card_at_every_path_site(batch):
    src = (knn_mod.__file__.rsplit("/ops/", 1)[0] + "/csrc/knn.cu")
    text = open(src).read()
    assert f"kTile = {knn_mod.TILE};" in text
    assert f"kMaxThreads = {knn_mod.MAX_THREADS};" in text
    assert 16 * knn_mod.TILE <= 227 * 1024       # static shared memory
    sites = _path_knn_sites(batch)
    assert PRESETS["teacher"].npoints[0] == 8192 and len(sites) == 19
    picked = set()
    for B, S, N, k in sites:
        lanes, qpb = knn_plan(B, S, N, k)
        threads = lanes * qpb
        assert lanes in knn_mod.KERNEL_LANES and 32 % lanes == 0
        assert k <= knn_mod.list_entries(lanes, k)
        assert threads <= 1024 and threads % 32 == 0
        # one lane only where the queries alone fill the card; else the
        # card is filled, or every query has all 32 lanes
        if lanes == 1:
            assert B * S >= knn_mod.ONE_LANE_QUERIES
        else:
            assert lanes == 32 or B * S * lanes >= knn_mod.FILL_THREADS
        picked.add(lanes)
    assert 32 in picked


def test_knn_sweep_is_inside_the_kernel_range():
    assert set(PATH_K + SWEEP_K) <= set(knn_mod.KERNEL_K)
    assert list(knn_mod.KERNEL_K) == list(range(1, 65))


@pytest.mark.parametrize("B,S,N", [(1, 2048, 2048), (2, 2048, 2048),
                                   (1, 8192, 8192), (2, 64, 256)])
def test_knn_plan_takes_32_lanes_of_two_entries_above_k32(B, S, N):
    for k in (33, 48, 63, 64):
        lanes, qpb = knn_plan(B, S, N, k)
        assert lanes == 32 and knn_mod.lane_entries(lanes, k) == 2
        assert knn_mod.list_entries(lanes, k) == 64
        assert lanes * qpb <= 1024 and (lanes * qpb) % 32 == 0
    for k in (1, 2, 31, 32):
        assert knn_mod.lane_entries(knn_plan(B, S, N, k)[0], k) == 1
    with pytest.raises(ValueError):
        knn_plan(B, S, N, 65)


def test_knn_kernel_guard_refuses_k_above_64():
    keys = torch.zeros(1, 128, 3)
    query = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError, match="k <= 64"):
        knn_mod._knn_cuda(65, keys, query)
    with pytest.raises(ValueError):
        knn_striped(65, keys, query, 32)


def test_knn_plan_keeps_few_lanes_only_where_the_queries_fill_the_card():
    assert knn_plan(8, 8192, 8192, 3) == (1, 128)
    assert knn_plan(3, 8192, 8192, 3)[0] == 8
    assert knn_plan(1, 8192, 8192, 3)[0] == 32
    assert knn_plan(8, 8192, 8192, 9)[0] == 16
    assert knn_plan(16, 8192, 8192, 32) == (32, 32)
    assert knn_plan(2, 256, 256, 32) == (32, 1)
    for B, S, k in ((1, 256, 9), (2, 64, 16), (2, 512, 16)):
        assert knn_plan(B, S, 2048, k)[0] == 32


# -------------------------------------------------------------- pool backward

def _tie_case(c, k, seed):
    """Pool inputs with exact ties (as the train tests' case): queries 0-7
    have all neighbours one row (every p_k ties), 8-15 the same with v
    cancelling it (every p_k is the bias, exactly 0 in every fourth
    channel), 16-23 an exact 0 before the first leaky at neighbour 0, 24-31
    neighbours alternating between two equal rows of u."""
    rng = np.random.RandomState(seed)
    B, N1, N2 = 2, 64, 48
    u = rng.standard_normal((B, N2, c)).astype(np.float32)
    v = rng.standard_normal((B, N1, c)).astype(np.float32)
    idx = rng.randint(0, N2, (B, N1, k)).astype(np.int32)
    w = (0.2 * rng.standard_normal((c, c))).astype(np.float32)  # (in, out)
    b = (0.2 * rng.standard_normal(c)).astype(np.float32)
    ct = rng.standard_normal((B, N1, c)).astype(np.float32)
    idx[:, :16, :] = idx[:, :16, :1]
    u[:, 1] = u[:, 0]
    idx[:, 24:32, 0::2], idx[:, 24:32, 1::2] = 0, 1
    b[::4] = 0.0
    for bb in range(B):
        v[bb, 8:24] = -u[bb, idx[bb, 8:24, 0]]
    return u, idx, v, w, b, ct


def _masked(u, idx, v, w, b, ct):
    d_u, d_v, d_wt, d_b = pool_bwd_masked(_t(u), _t(idx), _t(v), _t(w.T),
                                          _t(b), _t(ct))
    return [d_u.numpy(), d_v.numpy(), d_wt.numpy().T, d_b.numpy()]


def _autograd(u, idx, v, w, b, ct):
    ts = [_t(a).requires_grad_() for a in (u, v, w.T, b)]
    out = pool_plain(ts[0], _t(idx), ts[1], ts[2], ts[3])
    d_u, d_v, d_wt, d_b = torch.autograd.grad(out, ts, _t(ct))
    return [d_u.numpy(), d_v.numpy(), d_wt.numpy().T, d_b.numpy()]


def _scatter_dg(dg_kmaj, idx, n2):
    """JAX's d_g (B, K, N1, C) folded onto the key table: d_u."""
    B, _, _, C = dg_kmaj.shape
    dg = np.transpose(np.asarray(dg_kmaj, np.float64), (0, 2, 1, 3))
    du = np.zeros((B, n2, C))
    for bb in range(B):
        np.add.at(du[bb], idx[bb].reshape(-1), dg[bb].reshape(-1, C))
    return du


def _close(got, want):
    # float32 sums in another order (d_h0 over the mask's channels, the
    # scatter into d_u, the row sums of d_w / d_b): 1e-5 of each output's
    # largest magnitude
    for name, g, x in zip(("d_u", "d_v", "d_w", "d_b"), got, want):
        x = np.asarray(x, np.float64)
        assert g.shape == x.shape, name
        assert np.abs(g - x).max() <= 1e-5 * np.abs(x).max(), name


@pytest.mark.parametrize("c,k", [(32, 16), (64, 16), (32, 32), (64, 32)])
def test_pool_bwd_masked_matches_autograd_and_pallas_interpret(c, k,
                                                               monkeypatch):
    monkeypatch.setattr(jax_pool.pl, "pallas_call",
                        functools.partial(jax_pool.pl.pallas_call,
                                          interpret=True))
    u, idx, v, w, b, ct = _tie_case(c, k, seed=c + k)
    got = _masked(u, idx, v, w, b, ct)
    _close(got, _autograd(u, idx, v, w, b, ct))
    d_g, d_v, (d_w,), (d_b,) = jax_pool._pool_bwd_pallas(
        group_points_kmajor(u, idx), jnp.asarray(v), (jnp.asarray(w),),
        (jnp.asarray(b),), 0, 1, jnp.asarray(ct))
    _close(got, [_scatter_dg(d_g, idx, u.shape[1]), d_v, d_w, d_b])


@pytest.mark.parametrize("k", [16, 32])
def test_pool_bwd_masked_at_c16_matches_pallas_lane_packed(k, monkeypatch):
    """C = 16, the student's l0 width, with ties: against autograd and the
    Pallas backward on 8 queries lane-packed to a row (packed_p = 8, as
    the JAX package runs it), its d_g unpacked to (B, K, N1, 16) before
    the scatter into d_u."""
    monkeypatch.setattr(jax_pool.pl, "pallas_call",
                        functools.partial(jax_pool.pl.pallas_call,
                                          interpret=True))
    u, idx, v, w, b, ct = _tie_case(16, k, seed=16 + k)
    got = _masked(u, idx, v, w, b, ct)
    _close(got, _autograd(u, idx, v, w, b, ct))
    d_g, d_v, (d_w,), (d_b,) = jax_pool._pool_bwd_pallas(
        group_points_kmajor_packed(u, idx, 8), jnp.asarray(v),
        (jnp.asarray(w),), (jnp.asarray(b),), 0, 8, jnp.asarray(ct))
    _close(got, [_scatter_dg(jax_pool._unpack(d_g, 8), idx, u.shape[1]), d_v,
                 d_w, d_b])


def test_pool_bwd_masked_splits_a_tie_evenly():
    """The tie between two equal rows of u (queries 24-31): each row gets
    half the cotangent, bit for bit."""
    u, idx, v, w, b, ct = _tie_case(32, 32, seed=3)
    ct[:] = 0.0
    ct[0, 24] = 1.0
    d_u = _masked(u, idx, v, w, b, ct)[0]
    assert np.abs(d_u[0, 0]).max() > 0
    np.testing.assert_array_equal(d_u[0, 0], d_u[0, 1])
