"""The experimental inventory's PointConv variants and down-samplers
(kd_pointcloud_tpu_torch/nn/experimental.py, group a) against the JAX
package's, on the CPU.

Each flax module is built from jax.random.PRNGKey(0) at the shapes of
tests/test_experimental.py (B 2, N 64, C 16, K 8), its variables carried
into the port's module by params_from_jax (strict load), and every output
compared within 1e-5 abs (indices exactly). kNN and FPS are exact on both
sides. The BatchNorms of PointConvK / SepConv use running statistics in
every mode, so those are compared in train and eval mode on random
running statistics.
"""

import jax
import numpy as np
import pytest
import torch

from kd_pointcloud_tpu.nn import experimental as jx
from kd_pointcloud_tpu_torch.models import params_from_jax
from kd_pointcloud_tpu_torch.nn import experimental as px

torch.set_num_threads(1)
TOL = 1e-5
B, N, C, K = 2, 64, 16, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _random_stats(variables, seed):
    """Seeded running statistics in place of init's 0 / 1."""
    rng = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 2.0, a.shape) if path[-1].key ==
                         "var" else rng.standard_normal(a.shape)
                         ).astype(np.float32),
        variables["batch_stats"])
    return dict(variables, batch_stats=stats)


def _check(jax_mod, port, args, stats=False):
    """Outputs of jax_mod (PRNGKey(0) init) and of port (strict load of
    its variables) on the same inputs, in eval and in train mode."""
    variables = jax.device_get(jax_mod.init(jax.random.PRNGKey(0), *args))
    if stats:
        variables = _random_stats(variables, 1)
    port.load_state_dict(params_from_jax(variables), strict=True)
    want = _flat(jax_mod.apply(variables, *args))
    for mode in (False, True):
        port.train(mode)
        with torch.no_grad():
            got = _flat(port(*(_t(a) for a in args)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape
            assert np.abs(g.numpy().astype(np.float64) - w).max() <= TOL
    return got


@pytest.fixture
def cloud():
    rng = np.random.RandomState(0)
    return (rng.standard_normal((B, N, 3)).astype(np.float32),
            rng.standard_normal((B, N, C)).astype(np.float32))


@pytest.mark.parametrize("name,make", [
    ("PointConvSVD", lambda m: m.PointConvSVD),
    ("PointConvBias", lambda m: m.PointConvBias),
    ("PointConvFactor", lambda m: m.PointConvFactor),
])
def test_pointconv_variants_match_jax(cloud, name, make):
    out = _check(make(jx)(K, 32), make(px)(K, C, 32), cloud)
    width = px.PointConvFactor.out_channel() if name == "PointConvFactor" \
        else 32
    assert out[0].shape == (B, N, width)


@pytest.mark.parametrize("name", ["PointConvK", "SepConv"])
def test_kernel_aggregations_match_jax_on_running_stats(cloud, name):
    out = _check(getattr(jx, name)(K, 24), getattr(px, name)(K, C, 24),
                 cloud, stats=True)
    assert out[0].shape == (B, N, 24)


def test_vnn_conv_d_matches_jax(cloud):
    xyz, feats = cloud
    feats = feats[..., :15]          # 3 + 15 channels: 6 vector channels
    new_xyz, out, idx = _check(jx.VNNConvD(16, K, 4),
                               px.VNNConvD(16, K, 15, 4), (xyz, feats))
    assert out.shape == (B, 16, 12) and idx.dtype == torch.int32
    with pytest.raises(ValueError):
        px.VNNConvD(16, K, 16, 4)


@pytest.mark.parametrize("name,jax_args,port_args", [
    ("SetAbstract", (K, (32, 24)), (K, C, (32, 24))),
    ("SetAbstractFuse", (K, (32, 24), (32,)), (K, C, (32, 24), (32,))),
    ("SetAbstractFuse", (K, (32,), ()), (K, C, (32,), ())),
    ("LocalFeatureAggregation", (K, 32), (K, C, 32)),
], ids=["set_abstract", "fuse", "fuse_no_mlp2", "lfa"])
def test_same_resolution_blocks_match_jax(cloud, name, jax_args, port_args):
    _check(getattr(jx, name)(*jax_args), getattr(px, name)(*port_args), cloud)


@pytest.mark.parametrize("name,jax_args,port_args", [
    ("SetAbstractD", (16, K, (32,)), (16, K, C, (32,))),
    ("SetAbstractFuseD", (16, K, (32, 32), (32,)),
     (16, K, C, (32, 32), (32,))),
    ("PointConvW", (16, K, 24), (16, K, C, 24)),
    ("PointConvSVDD", (16, K, 32), (16, K, C, 32)),
    ("PointConvWeight", (16, K, 32), (16, K, C, 32)),
], ids=["set_abstract_d", "fuse_d", "w", "svdd", "weight"])
def test_downsamplers_match_jax(cloud, name, jax_args, port_args):
    new_xyz, out, idx = _check(getattr(jx, name)(*jax_args),
                               getattr(px, name)(*port_args), cloud)
    assert new_xyz.shape == (B, 16, 3) and idx.shape == (B, 16)


def test_pointconv_ds_samples_its_own_cloud(cloud):
    xyz, feats = cloud
    xyz_s = np.random.RandomState(1).standard_normal((B, N, 3)).astype(
        np.float32)
    new_xyz, out, idx = _check(jx.PointConvDS(16, K, 24),
                               px.PointConvDS(16, K, C, 24),
                               (xyz_s, xyz, feats))
    np.testing.assert_array_equal(
        new_xyz.numpy(), np.take_along_axis(xyz_s, idx.numpy()[..., None]
                                            .astype(np.int64), 1))


def test_pointconv_4d_matches_jax(cloud):
    xyz, feats = cloud
    c_xyz = np.random.RandomState(2).standard_normal((B, 32, 3)).astype(
        np.float32)
    out = _check(jx.PointConv4D(K, 24), px.PointConv4D(K, C, 24),
                 (c_xyz, xyz, feats))
    assert out[0].shape == (B, 32, 24)


def test_adaptive_sampling_matches_jax(cloud):
    xyz, feats = cloud
    rng = np.random.RandomState(3)
    pc2 = rng.standard_normal((B, N, 3)).astype(np.float32)
    f2 = rng.standard_normal((B, N, C)).astype(np.float32)
    want = np.asarray(jx.AdaptiveSampling(K)(xyz, feats, pc2, f2))
    got = px.AdaptiveSampling(K)(*(_t(a) for a in (xyz, feats, pc2, f2)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
