"""The port's blocked-FPS relaxation (ModelConfig.fps_blocks) and
PointConvDRand against the JAX package, at tiny_config on the CPU.

furthest_point_sample_blocked is held bit for bit against JAX's
(tests/test_ops.py's cases, the fallbacks included); the teacher and serving
flows with fps_blocks in {2, 8}, under both nested_fps values, within 1e-5
abs of the JAX model's on the same seeded weights; PointConvDRand within
1e-5 of flax's on the same weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd_pointcloud_tpu.models import BidPointFlowNet as JaxNet
from kd_pointcloud_tpu.nn import PointConvDRand as JaxPointConvDRand
from kd_pointcloud_tpu.ops.fps import \
    furthest_point_sample_blocked as jax_fps_blocked
from kd_pointcloud_tpu_torch.models import (BidPointFlowNet, check_config,
                                            params_from_jax, tiny_config)
from kd_pointcloud_tpu_torch.nn import PointConvDRand
from kd_pointcloud_tpu_torch.ops import fps as fps_mod
from kd_pointcloud_tpu_torch.ops import furthest_point_sample_blocked

torch.set_num_threads(1)

N = 256
TOL = 1e-5
# a cost-volume K per level that fits tiny_config's points, as serving's
# (16, 16, 32, 32) differs from the teacher's
PER_LEVEL_K = (4, 8, 12, 16)
_JITTED = {}


def _t(a):
    return torch.from_numpy(np.asarray(a))


# (B, N, npoint, blocks): tests/test_ops.py's blocked case and its fallback
# (N % blocks), npoint % blocks, blocks 1, and l1's split at tiny_config
FPS_CASES = [(2, 64, 16, 4), (2, 62, 16, 4), (2, 64, 12, 8), (2, 64, 16, 1),
             (2, 64, 16, 2), (2, 64, 16, 8), (3, 256, 128, 8),
             (2, 256, 128, 2)]


@pytest.mark.parametrize("B,n,npoint,blocks", FPS_CASES,
                         ids=[f"B{c[0]}-N{c[1]}-m{c[2]}-b{c[3]}"
                              for c in FPS_CASES])
def test_blocked_fps_matches_jax(B, n, npoint, blocks):
    rng = np.random.RandomState(n + npoint + blocks)
    xyz = (rng.randn(B, n, 3) * 5).astype(np.float32)
    got = furthest_point_sample_blocked(_t(xyz), npoint, blocks)
    want = np.asarray(jax_fps_blocked(jnp.asarray(xyz), npoint, blocks))
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    if blocks > 1 and n % blocks == 0 and npoint % blocks == 0:
        # one call of B * blocks clouds; any prefix of `blocks` entries
        # holds one pick of every block
        nb = n // blocks
        assert {int(i) // nb for i in got[0, :blocks]} == set(range(blocks))
    else:
        np.testing.assert_array_equal(got.numpy(),
                                      fps_mod.fps_plain(_t(xyz), npoint))


def test_blocked_fps_is_one_call_of_the_blocks(monkeypatch):
    """All blocks go through one furthest_point_sample call (one kernel
    launch on the card), as B * blocks clouds of N / blocks points."""
    calls = []
    plain = fps_mod.fps_plain

    def record(xyz, npoint):
        calls.append((tuple(xyz.shape), npoint, xyz.is_contiguous()))
        return plain(xyz, npoint)
    monkeypatch.setattr(fps_mod, "fps_plain", record)
    xyz = torch.randn(2, 8192 // 16, 3)
    furthest_point_sample_blocked(xyz, 2048 // 16, 8)
    assert calls == [((16, 64, 3), 16, True)]


def _seeded_tree(shapes, rng):
    """Seeded weights for a flax param tree: every Dense-like node (kernel
    and bias) U(+-1/sqrt(fan_in)), BatchNorm scale in [0.5, 2] and bias in
    [-0.1, 0.1]."""
    out = {k: _seeded_tree(v, rng) for k, v in shapes.items()
           if isinstance(v, dict)}
    if "kernel" in shapes:
        bound = 1 / np.sqrt(np.prod(shapes["kernel"].shape[:-1]))
        for k, v in shapes.items():
            out[k] = rng.uniform(-bound, bound, v.shape).astype(np.float32)
    elif "scale" in shapes:
        out["scale"] = rng.uniform(0.5, 2.0, shapes["scale"].shape
                                   ).astype(np.float32)
        out["bias"] = rng.uniform(-0.1, 0.1, shapes["bias"].shape
                                  ).astype(np.float32)
    return out


def _config(preset, fps_blocks, nested):
    cfg = tiny_config("teacher")
    if preset == "serving":
        cfg = dataclasses.replace(tiny_config("serving"),
                                  flow_nei_per_level=PER_LEVEL_K)
    return dataclasses.replace(cfg, fps_blocks=fps_blocks, nested_fps=nested)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(7)
    pc1 = rng.uniform(-2, 2, (1, N, 3)).astype(np.float32)
    pc2 = (pc1 + 0.1 * rng.standard_normal(pc1.shape)).astype(np.float32)
    return pc1, pc2


def _variables(preset, pc1, pc2):
    if preset not in _JITTED:
        net = JaxNet(dataclasses.replace(_config(preset, 1, True),
                                         knn_method="exact"))
        shapes = jax.eval_shape(lambda k, a, b: net.init(k, a, b, a, b,
                                                         train=False),
                                jax.random.PRNGKey(0), pc1, pc2)
        rng = np.random.RandomState(3)
        _JITTED[preset] = {
            "params": _seeded_tree(shapes["params"], rng),
            "batch_stats": jax.tree_util.tree_map(
                lambda s: rng.uniform(0.5, 2.0, s.shape).astype(np.float32),
                shapes["batch_stats"])}
    return _JITTED[preset]


@pytest.mark.parametrize("preset", ["teacher", "serving"])
@pytest.mark.parametrize("fps_blocks", [2, 8])
@pytest.mark.parametrize("nested", [True, False],
                         ids=["nested", "not_nested"])
def test_flows_match_jax_with_fps_blocks(inputs, preset, fps_blocks, nested):
    """Every flow level within 1e-5 abs and every FPS chain equal to the
    JAX model's; under nested_fps only l1's FPS is blocked (l2-l4 take its
    prefixes), without it every level's."""
    pc1, pc2 = inputs
    variables = _variables(preset, pc1, pc2)
    cfg = _config(preset, fps_blocks, nested)
    net = JaxNet(dataclasses.replace(cfg, knn_method="exact"))
    out = jax.device_get(jax.jit(lambda v, a, b: net.apply(
        v, a, b, a, b, train=False))(variables, pc1, pc2))
    model = BidPointFlowNet(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    model.eval()
    with torch.no_grad():
        mine = model(*(_t(a) for a in (pc1, pc2, pc1, pc2)))
    for lvl in range(4):
        np.testing.assert_allclose(mine["flows"][lvl].numpy(),
                                   np.asarray(out["flows"][lvl]), rtol=0,
                                   atol=TOL)
    for key in ("fps_idx1", "fps_idx2"):
        for want, got in zip(out[key], mine[key]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the relaxation is real: l1's ordering is not global FPS's
    exact = fps_mod.fps_plain(_t(pc1), cfg.npoints[1])
    assert not torch.equal(mine["fps_idx1"][0], exact)


def test_pointconv_d_rand_matches_jax():
    """PointConvDRand: the first npoint rows, then PointConvD's grouping,
    WeightNet and Dense, within 1e-5 of flax's on the same weights (the
    bridge maps its leaves as PointConvD's)."""
    rng = np.random.RandomState(11)
    xyz = rng.uniform(-1, 1, (2, 96, 3)).astype(np.float32)
    feats = rng.standard_normal((2, 96, 12)).astype(np.float32)
    net = JaxPointConvDRand(npoint=40, nsample=8, out_channel=24,
                            weightnet=8, knn_method="exact")
    shapes = jax.eval_shape(lambda k: net.init(k, xyz, feats),
                            jax.random.PRNGKey(0))
    variables = {"params": _seeded_tree(shapes["params"], rng)}
    new_xyz, new_feat, idx = jax.device_get(jax.jit(
        lambda v: net.apply(v, xyz, feats))(variables))
    mod = PointConvDRand(40, 8, 12, 24, weightnet=8)
    mod.load_state_dict(params_from_jax(variables), strict=True)
    with torch.no_grad():
        got_xyz, got_feat, got_idx = mod(_t(xyz), _t(feats))
    np.testing.assert_array_equal(got_xyz.numpy(), new_xyz)
    np.testing.assert_array_equal(got_idx.numpy(), idx)
    np.testing.assert_allclose(got_feat.numpy(), new_feat, rtol=0, atol=TOL)
    assert got_feat.shape == (2, 40, 24)


@pytest.mark.parametrize("fps_blocks,ok", [(1, True), (2, True), (3, True),
                                           (8, True), (0, False),
                                           (-2, False)])
def test_check_config_admits_every_buildable_fps_blocks(fps_blocks, ok):
    """Any fps_blocks >= 1 builds (a block count that does not divide a
    level's points falls back to exact FPS there); below 1 it refuses."""
    cfg = dataclasses.replace(tiny_config("teacher"), fps_blocks=fps_blocks)
    if ok:
        check_config(cfg)
        model = BidPointFlowNet(cfg, device="cpu")
        assert model.level1.fps_blocks == fps_blocks
        return
    with pytest.raises(NotImplementedError, match="fps_blocks"):
        check_config(cfg)
