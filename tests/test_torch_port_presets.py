"""Presets that share the teacher's wiring, against the JAX model, at tiny
shapes on the CPU.

check_config lets serving, serving_v2 and weight48 through. Their two
departures from the teacher are a per-level cost-volume K
(flow_nei_per_level, which tiny_config resets to None) and narrow
WeightNets (weight48: 4 and 8 hidden channels). Each case here builds the
JAX model with exact kNN, carries its weights over with params_from_jax and
holds all four flow levels within 1e-5 abs, the bound of the teacher's own
test (tests/test_torch_port_model.py).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kd_pointcloud_tpu.models import BidPointFlowNet as JaxNet
from kd_pointcloud_tpu.models import tiny_config as jax_tiny_config
from kd_pointcloud_tpu_torch.models import (PRESETS, BidPointFlowNet,
                                            check_config, params_from_jax,
                                            tiny_config)

torch.set_num_threads(1)

N = 256
TOL = 1e-5
# a cost-volume K per level that fits tiny_config's (256, 128, 64, 32)
# points and differs at every level, as serving's (16, 16, 32, 32) does
PER_LEVEL_K = (4, 8, 12, 16)


def _cases():
    serving = dataclasses.replace(jax_tiny_config("serving"),
                                  flow_nei_per_level=PER_LEVEL_K)
    return {"per_level_k": serving, "weight48": jax_tiny_config("weight48")}


@pytest.fixture(scope="module", params=sorted(_cases()))
def case(request):
    cfg = _cases()[request.param]
    rng = np.random.RandomState(1)
    pc1 = rng.uniform(-2, 2, (1, N, 3)).astype(np.float32)
    pc2 = (pc1 + 0.1 * rng.standard_normal(pc1.shape)).astype(np.float32)
    net = JaxNet(dataclasses.replace(cfg, knn_method="exact"))
    variables = jax.device_get(jax.jit(
        lambda k: net.init(k, pc1, pc2, pc1, pc2, train=False))(
            jax.random.PRNGKey(2)))
    out = jax.device_get(jax.jit(
        lambda v: net.apply(v, pc1, pc2, pc1, pc2, train=False))(variables))
    model = BidPointFlowNet(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    model.eval()
    with torch.no_grad():
        mine = model(*(torch.from_numpy(a) for a in (pc1, pc2, pc1, pc2)))
    return cfg, out, mine, model


def test_case_departs_from_the_teacher(case):
    cfg, _, _, model = case
    if cfg.flow_nei_per_level is not None:
        assert [getattr(model, f"cross{lvl}").nsample for lvl in range(4)] \
            == list(PER_LEVEL_K)
    else:
        assert cfg.weightnet == (4, 4, 4, 8, 8)
        assert model.level1.weightnet.layers[-1].weight.shape[0] == 4
        assert model.flow3.convs[0].weightnet.layers[-1].weight.shape[0] == 8


@pytest.mark.parametrize("lvl", range(4))
def test_flows_match_jax(case, lvl):
    _, out, mine, _ = case
    want = np.asarray(out["flows"][lvl])
    got = mine["flows"][lvl].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


def test_features_and_cost_volumes_match_jax(case):
    _, out, mine, _ = case
    for key in ("feat1s", "feat2s", "crosses"):
        for want, got in zip(out[key], mine[key]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=TOL, err_msg=key)


@pytest.mark.parametrize("name", ["serving", "serving_v2", "weight48"])
def test_held_presets_are_accepted(name):
    check_config(PRESETS[name])
