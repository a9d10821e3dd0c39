"""The inventory's ops against the JAX package's, on the CPU: ball_query,
three_nn / three_interpolate, the k-major gathers and the pointnet2 API
(ops/pointnet2_compat.py), and the inventory's completeness: every public
name of the JAX modules the port mirrors has a counterpart.

Indices are compared exactly, distances and features within 1e-5 abs.
Modules with weights are built in flax from jax.random.PRNGKey(0) and
carried over by params_from_jax (strict load).
"""

import importlib
import inspect

import jax
import numpy as np
import pytest
import torch

from kd_pointcloud_tpu.ops import gather as jgather
from kd_pointcloud_tpu.ops import interpolate as jinterp
from kd_pointcloud_tpu.ops import pointnet2_compat as jpn2
from kd_pointcloud_tpu_torch.models import params_from_jax
from kd_pointcloud_tpu_torch.ops import (ball_query, group_points_kmajor,
                                         group_points_kmajor_packed,
                                         three_interpolate, three_nn)
from kd_pointcloud_tpu_torch.ops import pointnet2_compat as ppn2

# the modules, not the functions of the same name that ops/__init__ exports
jbq = importlib.import_module("kd_pointcloud_tpu.ops.ball_query")
pbq = importlib.import_module("kd_pointcloud_tpu_torch.ops.ball_query")

torch.set_num_threads(1)
TOL = 1e-5
B, N, C = 2, 64, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert np.abs(got.detach().numpy().astype(np.float64) - want).max() <= TOL


@pytest.fixture
def cloud():
    rng = np.random.RandomState(0)
    return (rng.standard_normal((B, N, 3)).astype(np.float32),
            rng.standard_normal((B, N, C)).astype(np.float32))


@pytest.mark.parametrize("radius,k", [(1.5, 4), (0.8, 8), (0.3, 8),
                                      (4.0, 16)])
def test_ball_query_matches_jax(cloud, radius, k):
    xyz = cloud[0]
    query = np.concatenate(
        [xyz[:, :16], np.full((B, 1, 3), 50.0, np.float32)], axis=1)
    got = ball_query(radius, k, _t(xyz), _t(query))
    want = np.asarray(jbq.ball_query(radius, k, xyz, query))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the far query has no hit: all zeros
    assert (got[:, -1] == 0).all()


def test_ball_query_pads_with_the_first_hit():
    """A query with fewer hits than k: the hits in index order, then the
    first hit repeated; one with none: zeros."""
    xyz = np.zeros((1, 10, 3), np.float32)
    xyz[0, :, 0] = np.arange(10)
    query = np.array([[[4.2, 0, 0], [100.0, 0, 0], [0.1, 0, 0]]],
                     np.float32)
    got = ball_query(1.5, 5, _t(xyz), _t(query))
    np.testing.assert_array_equal(got.numpy(), [[[3, 4, 5, 3, 3],
                                                 [0, 0, 0, 0, 0],
                                                 [0, 1, 0, 0, 0]]])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbq.ball_query(1.5, 5, xyz, query)))


def test_ball_query_chunks_the_queries(monkeypatch):
    """Queries beyond one chunk give what one chunk gives."""
    rng = np.random.RandomState(1)
    xyz = _t(rng.uniform(-1, 1, (1, 300, 3)).astype(np.float32))
    query = _t(rng.uniform(-1, 1, (1, 70, 3)).astype(np.float32))
    whole = ball_query(0.4, 6, xyz, query)
    monkeypatch.setattr(pbq, "_CHUNK", 16)
    torch.testing.assert_close(ball_query(0.4, 6, xyz, query), whole,
                               rtol=0, atol=0)


def test_three_nn_and_interpolate_match_jax(cloud):
    xyz, feats = cloud
    sparse = xyz[:, ::4].copy()                  # exact subset: dist 0 rows
    dist, idx = three_nn(_t(xyz), _t(sparse))
    jdist, jidx = jinterp.three_nn(xyz, sparse)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(dist, jdist)
    assert float(dist.min()) == pytest.approx(1e-10)
    w = np.random.RandomState(2).rand(B, N, 3).astype(np.float32)
    _close(three_interpolate(_t(feats[:, ::4].copy()), idx, _t(w)),
           jinterp.three_interpolate(feats[:, ::4], np.asarray(jidx), w))


@pytest.mark.parametrize("pack", [1, 2, 8])
def test_kmajor_gathers_match_jax(cloud, pack):
    _, feats = cloud
    idx = np.random.RandomState(3).randint(0, N, (B, 32, 9)).astype(np.int32)
    np.testing.assert_array_equal(
        group_points_kmajor(_t(feats), _t(idx)).numpy(),
        np.asarray(jgather.group_points_kmajor(feats, idx)))
    np.testing.assert_array_equal(
        group_points_kmajor_packed(_t(feats), _t(idx), pack).numpy(),
        np.asarray(jgather.group_points_kmajor_packed(feats, idx, pack)))


@pytest.mark.parametrize("use_xyz", [True, False])
def test_query_and_group_and_group_all_match_jax(cloud, use_xyz):
    xyz, feats = cloud
    new_xyz = xyz[:, :16]
    _close(ppn2.QueryAndGroup(1.5, 4, use_xyz)(_t(xyz), _t(new_xyz),
                                               _t(feats)),
           jpn2.QueryAndGroup(1.5, 4, use_xyz)(xyz, new_xyz, feats))
    _close(ppn2.GroupAll(use_xyz)(_t(xyz), None, _t(feats)),
           jpn2.GroupAll(use_xyz)(xyz, None, feats))
    _close(ppn2.QueryAndGroup(1.5, 4)(_t(xyz), _t(new_xyz)),
           jpn2.QueryAndGroup(1.5, 4)(xyz, new_xyz))
    if not use_xyz:
        with pytest.raises(ValueError):
            ppn2.QueryAndGroup(1.5, 4, False)(_t(xyz), _t(new_xyz))


@pytest.mark.parametrize("npoint,with_feats", [(16, True), (16, False),
                                               (None, True)],
                         ids=["fps", "xyz_only", "group_all"])
def test_sa_module_matches_jax(cloud, npoint, with_feats):
    xyz, feats = cloud
    f = feats if with_feats else None
    jm = jpn2.PointnetSAModule(npoint, 1.5, 4, (32, 32))
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), xyz, f))
    port = ppn2.PointnetSAModule(npoint, 1.5, 4, C if with_feats else 0,
                                 (32, 32))
    port.load_state_dict(params_from_jax(v), strict=True)
    new_xyz, out = port(_t(xyz), None if f is None else _t(f))
    want_xyz, want = jm.apply(v, xyz, f)
    _close(new_xyz, want_xyz)
    _close(out, want)


@pytest.mark.parametrize("known", [True, False], ids=["idw", "broadcast"])
def test_fp_module_matches_jax(cloud, known):
    xyz, feats = cloud
    rng = np.random.RandomState(4)
    sparse = rng.standard_normal((B, 16, 3)).astype(np.float32)
    sfeats = rng.standard_normal((B, 16 if known else 1, 24)).astype(
        np.float32)
    args = (xyz, sparse if known else None, feats, sfeats)
    jm = jpn2.PointnetFPModule((32,))
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), *args))
    port = ppn2.PointnetFPModule(24 + C, (32,))
    port.load_state_dict(params_from_jax(v), strict=True)
    _close(port(*(None if a is None else _t(a) for a in args)),
           jm.apply(v, *args))


def _public(module):
    """The names a module defines (not those it imports), or its __all__."""
    if hasattr(module, "__all__"):
        return set(module.__all__)
    names = set()
    for name, obj in vars(module).items():
        if name.startswith("_") or inspect.ismodule(obj):
            continue
        owner = getattr(obj, "__module__", module.__name__)
        if owner == module.__name__ or not (callable(obj)
                                            or hasattr(obj, "__module__")):
            names.add(name)
    return names


@pytest.mark.parametrize("name", [
    "nn.experimental", "nn.vn_layers", "ops.ball_query",
    "ops.pointnet2_compat", "nn", "ops"])
def test_every_public_name_of_the_jax_module_has_a_counterpart(name):
    jax_mod = importlib.import_module(f"kd_pointcloud_tpu.{name}")
    port_mod = importlib.import_module(f"kd_pointcloud_tpu_torch.{name}")
    names = _public(jax_mod)
    assert names
    missing = sorted(n for n in names if not hasattr(port_mod, n))
    assert not missing, f"{name}: no counterpart of {missing}"


def test_the_inventory_counterparts_are_of_the_same_kind():
    """Each public class of the experimental and vector-neuron modules is a
    class in the port, each factory a function, the alias an alias of the
    same class; the modules' private classes (_KernelAgg,
    _GenericFlowEstimator) too."""
    for name in ("nn.experimental", "nn.vn_layers"):
        jax_mod = importlib.import_module(f"kd_pointcloud_tpu.{name}")
        port_mod = importlib.import_module(f"kd_pointcloud_tpu_torch.{name}")
        names = _public(jax_mod) | {
            n for n, o in vars(jax_mod).items()
            if inspect.isclass(o) and o.__module__ == jax_mod.__name__}
        for n in names:
            j, p = getattr(jax_mod, n), getattr(port_mod, n)
            assert inspect.isclass(j) == inspect.isclass(p), n
            assert inspect.isfunction(j) == inspect.isfunction(p), n
    jx = importlib.import_module("kd_pointcloud_tpu_torch.nn.experimental")
    assert jx.CrossPoolLayer is jx.CrossLayerConcat
