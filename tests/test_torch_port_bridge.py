"""The port's Bridge and bridge KD step against the JAX package's, on the
CPU.

The Bridge (untied and tied) on numpy features with the JAX module's
weights carried by params_from_jax: 1e-5 abs. One bridge KD step (tiny
`teacher` key 1 -> tiny `lighttoken_res` key 0, hint layer 3, a Bridge of
512 channels on the teacher's 512-wide layer-3 features) against JAX's
make_bridge_distill_step with gradient-capturing optimizers for the student
and the bridge: loss 1e-5 relative, every student and bridge gradient leaf
2e-4 of its largest value (the train step's tolerance; leaves whose true
gradient is 0 below 1e-5 of the largest gradient), BatchNorm statistics
1e-5. With no bridge optimizer the bridge stays as it was.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kd_pointcloud_tpu.models import BidPointFlowNet as JaxNet
from kd_pointcloud_tpu.models import Bridge as JaxBridge
from kd_pointcloud_tpu.models import tiny_config as jax_tiny_config
from kd_pointcloud_tpu.train import distill as jax_distill
from kd_pointcloud_tpu.train import state as jax_state
from kd_pointcloud_tpu_torch.models import (BidPointFlowNet, Bridge,
                                            params_from_jax, tiny_config)
from kd_pointcloud_tpu_torch.train import (make_bridge_distill_step,
                                           make_optimizer)

torch.set_num_threads(1)

B, N = 2, 256
LAYER, FEAT = 3, 512


def _batch_np(seed=0):
    rng = np.random.RandomState(seed)
    pc1 = rng.uniform(-2, 2, (B, N, 3)).astype(np.float32)
    pc2 = (pc1 + 0.1 * rng.standard_normal(pc1.shape)).astype(np.float32)
    return dict(pos1=pc1, pos2=pc2, norm1=pc1, norm2=pc2, flow=pc2 - pc1)


def _capture_grads():
    """Zero updates; the state is the last gradient."""
    zeros = functools.partial(jax.tree_util.tree_map, jnp.zeros_like)
    return optax.GradientTransformation(
        init=zeros, update=lambda grads, state, params=None: (zeros(grads),
                                                             grads))


def _jax_init(name, key, batch):
    net = JaxNet(dataclasses.replace(jax_tiny_config(name),
                                     knn_method="exact"))
    variables = jax.device_get(jax.jit(
        lambda k, a, b: net.init(k, a, b, a, b, train=False))(
            jax.random.PRNGKey(key), batch["pos1"], batch["pos2"]))
    return net, variables


def _port(name, variables):
    model = BidPointFlowNet(tiny_config(name), device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _zero_gradient_leaf(name):
    return name.startswith("flow") and ".convs." in name \
        and name.endswith("dense.bias")


@pytest.mark.parametrize("tied", [False, True])
def test_bridge_matches_jax(tied):
    rng = np.random.RandomState(5)
    a = rng.standard_normal((2, 24, 16)).astype(np.float32)
    b = rng.standard_normal((2, 24, 16)).astype(np.float32)
    jb = JaxBridge(feat_ch=32, tied_output=tied)
    params = jax.device_get(jb.init(jax.random.PRNGKey(3), a, b))
    want = jb.apply(params, a, b)
    bridge = Bridge(16, 32, tied_output=tied, device="cpu")
    state = params_from_jax(params)
    assert set(state) == set(bridge.state_dict())
    assert {k.split(".")[0] for k in state} == (
        {"mixed_layer", "out_src"} | (set() if tied else {"out_target"}))
    bridge.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = bridge(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def bridge_step():
    batch = _batch_np()
    t_net, t_vars = _jax_init("teacher", 1, batch)
    s_net, s_vars = _jax_init("lighttoken_res", 0, batch)
    jb = JaxBridge(feat_ch=FEAT)
    shape = (B, tiny_config("teacher").npoints[3],
             tiny_config("teacher").lift_channels[3])
    b_params = jax.device_get(jb.init(jax.random.PRNGKey(2),
                                      np.zeros(shape, np.float32),
                                      np.zeros(shape, np.float32))["params"])
    tx, b_tx = _capture_grads(), _capture_grads()
    step = jax_distill.make_bridge_distill_step(t_net, s_net, jb, tx, b_tx,
                                                layer=LAYER)
    new_state, _, b_grads, loss = jax.device_get(step(
        jax_state.TrainState.create(s_vars, tx), b_params,
        b_tx.init(b_params), t_vars,
        {k: jnp.asarray(v) for k, v in batch.items()}))

    teacher, student = _port("teacher", t_vars), _port("lighttoken_res",
                                                       s_vars)
    bridge = Bridge(shape[-1], FEAT, device="cpu")
    bridge.load_state_dict(params_from_jax({"params": b_params}))
    b_before = {k: v.clone() for k, v in bridge.state_dict().items()}
    port_loss = make_bridge_distill_step(
        teacher, student, bridge, make_optimizer(student),
        make_optimizer(bridge), layer=LAYER)(_t(batch))
    return dict(loss=float(loss), port_loss=float(port_loss),
                grads=params_from_jax({"params": new_state.opt_state}),
                b_grads=params_from_jax({"params": b_grads}),
                stats=params_from_jax({"batch_stats": new_state.batch_stats}),
                teacher=teacher, student=student, bridge=bridge,
                b_before=b_before, batch=batch, t_vars=t_vars, s_vars=s_vars)


def test_bridge_step_loss_matches_jax(bridge_step):
    assert bridge_step["port_loss"] == pytest.approx(bridge_step["loss"],
                                                     rel=1e-5)


@pytest.mark.parametrize("which", ["student", "bridge"])
def test_bridge_step_gradients_match_jax(bridge_step, which):
    want = bridge_step["grads" if which == "student" else "b_grads"]
    got = {n: p.grad for n, p in bridge_step[which].named_parameters()}
    assert set(got) == set(want)
    top = max(float(g.abs().max()) for g in want.values())
    for name, g in got.items():
        w = want[name].numpy()
        if _zero_gradient_leaf(name):
            assert max(float(g.abs().max()), float(np.abs(w).max())) \
                <= 1e-5 * top, name
        else:
            err = float(np.abs(g.numpy() - w).max())
            assert err <= 2e-4 * float(np.abs(w).max()), (name, err)


def test_bridge_step_batch_stats_match_jax(bridge_step):
    state = bridge_step["student"].state_dict()
    stats = {k: v for k, v in bridge_step["stats"].items()
             if ".running_" in k}
    assert len(stats) == 16
    for name, want in stats.items():
        np.testing.assert_allclose(state[name].numpy(), want.numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_bridge_trains_and_teacher_stays(bridge_step):
    bridge = bridge_step["bridge"]
    changed = [k for k, v in bridge.state_dict().items()
               if not torch.equal(v, bridge_step["b_before"][k])]
    assert sorted(changed) == sorted(bridge_step["b_before"])
    assert not bridge_step["teacher"].training
    assert all(p.grad is None for p in bridge_step["teacher"].parameters())


def test_bridge_without_optimizer_is_frozen(bridge_step):
    teacher = bridge_step["teacher"]
    student = _port("lighttoken_res", bridge_step["s_vars"])
    bridge = Bridge(teacher.cfg.lift_channels[3], FEAT, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in bridge.state_dict().items()}
    loss = make_bridge_distill_step(teacher, student, bridge,
                                    make_optimizer(student), None,
                                    layer=LAYER)(_t(bridge_step["batch"]))
    assert np.isfinite(float(loss))
    for k, v in bridge.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in bridge.parameters())
