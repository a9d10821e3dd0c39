"""The port's student presets against the JAX package, on the CPU.

serving_v3 (coarse warp at l0), the same wiring with coarse_warp=(0, 1),
student, student2 and non_linear at tiny_config: the same numpy inputs, the
same weights (carried by params_from_jax) and exact kNN on both sides; all
four flow levels, the features and the cost volumes within 1e-5 abs (the
bound of tests/test_torch_port_model.py), FPS chains equal, and the bridge
covering every entry of each model's state_dict. Then the blocks these
presets add, module by module: the 3-tap point-axis conv (flax's (3, in,
out) kernel into torch's (out, in, 3) by the bridge's transpose),
DepthwiseReLU, BottleNeck and PointConvNonLinear. The JAX forward of each
preset runs once per module.
"""

import dataclasses

import flax.linen as flax_nn
import jax
import numpy as np
import pytest
import torch

from kd_pointcloud_tpu.models import BidPointFlowNet as JaxNet
from kd_pointcloud_tpu.models import tiny_config as jax_tiny_config
from kd_pointcloud_tpu.nn import blocks as jax_blocks
from kd_pointcloud_tpu.nn.pointconv import \
    PointConvNonLinear as JaxPointConvNonLinear
from kd_pointcloud_tpu_torch.models import (BidPointFlowNet, params_from_jax,
                                            tiny_config)
from kd_pointcloud_tpu_torch.nn import (BottleNeck, DepthwiseReLU,
                                        PointConvNonLinear)
from kd_pointcloud_tpu_torch.nn.blocks import PointConv1d3

torch.set_num_threads(1)

N = 256
TOL = 1e-5
CASES = ("serving_v3", "coarse_warp_0_1", "student", "student2",
         "non_linear")


def _configs(case):
    """(JAX config, port config) of a case, both at tiny_config."""
    if case == "coarse_warp_0_1":
        return (dataclasses.replace(jax_tiny_config("serving_v3"),
                                    coarse_warp=(0, 1), knn_method="exact"),
                dataclasses.replace(tiny_config("serving_v3"),
                                    coarse_warp=(0, 1)))
    return (dataclasses.replace(jax_tiny_config(case), knn_method="exact"),
            tiny_config(case))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _max_err(got, want):
    return float(np.abs(got.detach().numpy() - np.asarray(want)).max())


@pytest.fixture(scope="module", params=CASES)
def preset(request):
    rng = np.random.RandomState(0)
    pc1 = rng.uniform(-2, 2, (1, N, 3)).astype(np.float32)
    pc2 = (pc1 + 0.1 * rng.standard_normal(pc1.shape)).astype(np.float32)
    jax_cfg, cfg = _configs(request.param)
    net = JaxNet(jax_cfg)
    variables = jax.jit(lambda k: net.init(k, pc1, pc2, pc1, pc2,
                                           train=False))(jax.random.PRNGKey(0))
    # non-trivial BatchNorm running statistics, so eval mode uses them
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    out = jax.device_get(jax.jit(
        lambda v: net.apply(v, pc1, pc2, pc1, pc2, train=False))(variables))
    variables = jax.device_get(variables)

    model = BidPointFlowNet(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    model.eval()
    with torch.no_grad():
        mine = model(*(_t(a) for a in (pc1, pc2, pc1, pc2)))
    return out, mine, model, variables


@pytest.mark.parametrize("lvl", range(4))
def test_flows_match_jax(preset, lvl):
    out, mine, _, _ = preset
    want = np.asarray(out["flows"][lvl])
    got = mine["flows"][lvl].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("key", ["pc1", "pc2", "feat1s", "feat2s", "crosses",
                                 "fps_idx1", "fps_idx2"])
def test_other_outputs_match_jax(preset, key):
    out, mine, _, _ = preset
    assert len(mine[key]) == len(out[key])
    for want, got in zip(out[key], mine[key]):
        if key.startswith("fps_idx"):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=TOL)


def test_bridge_covers_every_state_entry(preset):
    _, _, model, variables = preset
    state = params_from_jax(variables)
    want = model.state_dict()
    assert set(state) == set(want)
    for k, v in state.items():
        assert tuple(v.shape) == tuple(want[k].shape), k


def test_presets_build_the_blocks_their_config_names():
    student = BidPointFlowNet(tiny_config("student"), device="cpu")
    for name in ("level0_1", "level1_0", "level2_0", "level3_0"):
        assert isinstance(getattr(student, name), BottleNeck), name
    assert student.level0_1.dense.weight.shape == (8, 16)    # mid 8, C 16
    assert student.cross0.mlp1.layers[0].dense.weight.shape == (16, 16)
    non_linear = BidPointFlowNet(tiny_config("non_linear"), device="cpu")
    assert [type(getattr(non_linear, f"level{lvl}")).__name__
            for lvl in range(1, 5)] == ["PointConvD", "PointConvD",
                                        "PointConvNonLinear",
                                        "PointConvNonLinear"]


# ------------------------------------------------------------ module by module

def _init(module, *args, **kw):
    return jax.device_get(jax.jit(lambda k: module.init(k, *args, **kw))(
        jax.random.PRNGKey(0)))


def _load(port, variables, prefix=""):
    """The bridge's state_dict of flax variables into a port module that
    sits under `prefix` in the model."""
    state = params_from_jax(variables)
    port.load_state_dict({k.removeprefix(prefix): v
                          for k, v in state.items()}, strict=True)
    return port.eval()


def test_point_conv_kernel_transposes_to_conv1d_layout():
    """flax nn.Conv's (3, in, out) kernel, transposed by the bridge, is
    torch's conv1d (out, in, 3) weight: tap t of the kernel multiplies
    point n + t - 1, with zero padding at both ends and no mixing of the
    batch rows (two clouds stacked on the batch axis)."""
    rng = np.random.RandomState(2)
    x = rng.standard_normal((2, 40, 6)).astype(np.float32)
    conv = flax_nn.Conv(5, kernel_size=(3,), padding="SAME", use_bias=False)
    v = _init(conv, x)
    kernel = np.asarray(v["params"]["kernel"])
    state = params_from_jax({"params": {"Conv_0": v["params"]}})
    assert tuple(state["conv.weight"].shape) == (5, 6, 3)
    np.testing.assert_array_equal(state["conv.weight"].numpy(),
                                  np.transpose(kernel, (2, 1, 0)))
    port = _load(PointConv1d3(6, 5), {"params": {"Conv_0": v["params"]}},
                 "conv.")
    got = port(_t(x))
    assert _max_err(got, conv.apply(v, x)) <= TOL
    # by hand: out[b, n, o] = sum_t,i x[b, n + t - 1, i] kernel[t, i, o]
    pad = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (0, 0)))
    want = sum(pad[:, t:t + 40] @ kernel[t] for t in range(3))
    assert _max_err(got, want) <= TOL
    # each batch row alone gives its rows of the batched call (float32
    # rounding of another conv algorithm aside): nothing crosses the rows
    for b in range(2):
        assert _max_err(port(_t(x[b:b + 1]))[0], got[b].detach()) <= TOL


@pytest.mark.parametrize("mult", [1, 3])
def test_depthwise_relu_matches_jax(mult):
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 30, 8)).astype(np.float32)
    jm = jax_blocks.DepthwiseReLU(8 * mult)
    v = _init(jm, x)
    port = _load(DepthwiseReLU(8, 8 * mult),
                 {"params": {"DepthwiseReLU_0": v["params"]}}, "depthwise.")
    assert _max_err(port(_t(x)), jm.apply(v, x)) <= TOL


@pytest.mark.parametrize("mid,width", [(8, 16), (16, 32)])
def test_bottleneck_matches_jax(mid, width):
    rng = np.random.RandomState(4)
    x = rng.standard_normal((4, 64, width)).astype(np.float32)
    jm = jax_blocks.BottleNeck(mid, width)
    v = _init(jm, x)
    port = _load(BottleNeck(width, mid, width), v)
    got = port(_t(x))
    assert _max_err(got, jm.apply(v, x)) <= TOL
    # stacked clouds stay apart: each batch row alone gives its rows
    for b in range(4):
        assert _max_err(port(_t(x[b:b + 1]))[0], got[b].detach()) <= TOL


@pytest.mark.parametrize("prefix", [False, True])
def test_pointconv_nonlinear_matches_jax(prefix):
    rng = np.random.RandomState(5)
    xyz = rng.uniform(-3, 3, (2, 128, 3)).astype(np.float32)
    feats = rng.standard_normal((2, 128, 40)).astype(np.float32)
    jm = JaxPointConvNonLinear(32, 8, 64, weightnet=16, knn_method="exact")
    params = dict(_init(jm, xyz, feats, prefix_sample=prefix)["params"])
    # the depthwise bias starts at zero: give it values so it is exercised
    params["depthwise_bias"] = rng.standard_normal(43).astype(np.float32)
    want = jm.apply({"params": params}, xyz, feats, prefix_sample=prefix)
    # the bridge names the leaves by their place in the model (level3)
    port = _load(PointConvNonLinear(32, 8, 40, 64, weightnet=16),
                 {"params": {"level3": params}}, "level3.")
    assert tuple(port.depthwise.shape) == (43, 1)
    got = port(_t(xyz), _t(feats), prefix_sample=prefix)
    assert _max_err(got[0], want[0]) == 0.0
    assert _max_err(got[1], want[1]) <= TOL
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_new_blocks_draw_from_the_generator():
    """The students' blocks take their weights from the generator: the same
    seed gives the same block, and the bounds are torch's defaults."""
    a = BottleNeck(16, 8, 16, torch.Generator().manual_seed(0))
    b = BottleNeck(16, 8, 16, torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    assert float(a.conv.weight.detach().abs().max()) <= 1 / np.sqrt(3 * 8)
    assert float(a.depthwise.weight.detach().abs().max()) <= 1 / np.sqrt(16)
    c = PointConvNonLinear(32, 8, 40, 64, 16, torch.Generator().manual_seed(0))
    assert float(c.depthwise.detach().abs().max()) <= 1 / np.sqrt(43)
    assert not c.depthwise_bias.any()
