"""The port's modules against their JAX counterparts, on the CPU.

Flax modules are initialised on numpy inputs, their variables carried into
the port's modules by params_from_jax, and both outputs compared within
1e-5 abs. kNN is exact on both sides; the JAX pool runs its off-TPU
reference (_pool_ref).
"""

import jax
import numpy as np
import pytest
import torch

from kd_pointcloud_tpu.nn import blocks as jax_blocks
from kd_pointcloud_tpu.nn.cross import CrossLayerLight as JaxCross
from kd_pointcloud_tpu.nn.flowhead import SceneFlowEstimatorResidual as JaxHead
from kd_pointcloud_tpu.nn.pointconv import PointConvD as JaxPointConvD
from kd_pointcloud_tpu.nn.weightnet import WeightNet as JaxWeightNet
from kd_pointcloud_tpu_torch.models import params_from_jax
from kd_pointcloud_tpu_torch.nn import (MLP, CrossLayerLight, Dense,
                                        PointConvD, SceneFlowEstimatorResidual,
                                        WeightNet)

torch.set_num_threads(1)
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _init(module, *args, **kw):
    return jax.device_get(jax.jit(lambda k: module.init(k, *args, **kw))(
        jax.random.PRNGKey(0)))


def _load(port, variables):
    port.load_state_dict(params_from_jax(variables), strict=True)
    return port.eval()


def _max_err(got, want):
    return float(np.abs(got.detach().numpy() - np.asarray(want)).max())


def test_dense_mlp_weightnet_match_jax():
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 10, 4, 3)).astype(np.float32)
    wn = JaxWeightNet(16)
    v = _init(wn, x)
    # the bridge names WeightNet layers by their place inside a PointConv
    state = params_from_jax({"params": {"WeightNet_0": v["params"]}})
    port = WeightNet(16)
    port.load_state_dict({k.removeprefix("weightnet."): t
                          for k, t in state.items()}, strict=True)
    assert _max_err(port(_t(x)), wn.apply(v, x)) <= TOL

    mlp = jax_blocks.MLP((32, 16))
    v = _init(mlp, x)
    assert _max_err(_load(MLP(3, (32, 16)), v)(_t(x)),
                    mlp.apply(v, x)) <= TOL


def test_dense_init_is_torch_default():
    g = torch.Generator().manual_seed(0)
    layer = Dense(400, 300, g)
    bound = 1 / 20.0
    for p in (layer.weight, layer.bias):
        top = float(p.detach().abs().max())
        assert 0.9 * bound < top <= bound
    again = Dense(400, 300, torch.Generator().manual_seed(0))
    torch.testing.assert_close(again.weight, layer.weight, rtol=0, atol=0)


@pytest.mark.parametrize("prefix", [False, True])
def test_pointconvd_matches_jax(prefix):
    rng = np.random.RandomState(1)
    xyz = rng.uniform(-3, 3, (2, 256, 3)).astype(np.float32)
    feats = rng.standard_normal((2, 256, 32)).astype(np.float32)
    jm = JaxPointConvD(64, 8, 48, weightnet=16, knn_method="exact")
    v = _init(jm, xyz, feats, prefix_sample=prefix)
    want = jm.apply(v, xyz, feats, prefix_sample=prefix)
    port = _load(PointConvD(64, 8, 32, 48, weightnet=16), v)
    got = port(_t(xyz), _t(feats), prefix_sample=prefix)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert _max_err(got[1], want[1]) <= TOL
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("c", [32, 128])   # the JAX merged / split schedules
def test_cross_layer_light_matches_jax(c):
    rng = np.random.RandomState(c)
    pc1 = rng.uniform(-2, 2, (1, 128, 3)).astype(np.float32)
    pc2 = (pc1 + 0.1 * rng.standard_normal(pc1.shape)).astype(np.float32)
    f1 = rng.standard_normal((1, 128, c + 16)).astype(np.float32)
    f2 = rng.standard_normal((1, 128, c + 16)).astype(np.float32)
    jm = JaxCross(16, (c, c), (c, c), knn_method="exact")
    v = _init(jm, pc1, pc2, f1, f2)
    want = jm.apply(v, pc1, pc2, f1, f2)
    port = _load(CrossLayerLight(16, c + 16, (c, c), (c, c)), v)
    got = port(_t(pc1), _t(pc2), _t(f1), _t(f2))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert _max_err(g, w) <= TOL


def test_cross_layer_rejects_deep_mlp():
    with pytest.raises(ValueError):
        CrossLayerLight(16, 48, (32, 32, 32), (32, 32))


@pytest.mark.parametrize("with_flow", [False, True])
def test_flow_head_matches_jax(with_flow):
    rng = np.random.RandomState(3)
    xyz = rng.uniform(-2, 2, (1, 200, 3)).astype(np.float32)
    feats = rng.standard_normal((1, 200, 96)).astype(np.float32)
    cost = rng.standard_normal((1, 200, 32)).astype(np.float32)
    flow = (0.2 * rng.standard_normal((1, 200, 3))).astype(np.float32) \
        if with_flow else None
    jm = JaxHead(knn_method="exact")
    v = _init(jm, xyz, feats, cost, flow, train=False)
    v = {"params": v["params"],
         "batch_stats": jax.tree_util.tree_map(
             lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
             v["batch_stats"])}
    want = jm.apply(v, xyz, feats, cost, flow, train=False)
    port = _load(SceneFlowEstimatorResidual(96, 32), v)
    got = port(_t(xyz), _t(feats), _t(cost),
               None if flow is None else _t(flow))
    for g, w in zip(got, want):
        assert _max_err(g, w) <= TOL
