"""The port's standard KD step against the JAX package's, on the CPU.

A tiny `teacher` (JAX init, key 1) distils into a tiny `lighttoken_res`
(key 0); the port's models get the same weights through params_from_jax.
One step of JAX's make_distill_step and of the port's, with the shipped
config's loss (biDirection_loss_ht through make_named_loss: gamma 0.3, beta
0.8, hint layers [2, 3]), on the same numpy batch. The JAX optimizer is a
transformation whose state is the last gradient, so the step hands back
its gradient tree; the port's optimizer is the real Adam. Tolerances are
those of the train step's test (tests/test_torch_port_train.py): loss 1e-5
relative, every gradient leaf 2e-4 of its largest value (leaves whose true
gradient is 0 below 1e-5 of the largest gradient), BatchNorm statistics
1e-5. The teacher must come out of the step bit-unchanged and in eval mode.
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
from kd_pointcloud_tpu.models import tiny_config as jax_tiny_config
from kd_pointcloud_tpu.train import distill as jax_distill
from kd_pointcloud_tpu.train import distill_experiment as jax_dexp
from kd_pointcloud_tpu.train import state as jax_state
from kd_pointcloud_tpu_torch.models import (BidPointFlowNet, params_from_jax,
                                            tiny_config)
from kd_pointcloud_tpu_torch.ops import kernels
from kd_pointcloud_tpu_torch.train import (apply_frozen,
                                           compute_teacher_history,
                                           make_distill_step,
                                           make_named_loss, make_optimizer)

torch.set_num_threads(1)

B, N = 2, 256
ARGS = dict(gamma=0.3, beta=0.8, hint_layers=[2, 3])


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
    # the Dense bias feeding a flow head's BatchNorm: the batch mean
    # removes it, so its true gradient is 0 and any value is rounding noise
    return name.startswith("flow") and ".convs." in name \
        and name.endswith("dense.bias")


@pytest.fixture(scope="module")
def distill():
    batch = _batch_np()
    t_net, t_vars = _jax_init("teacher", 1, batch)
    s_net, s_vars = _jax_init("lighttoken_res", 0, batch)
    tx = _capture_grads()
    step = jax_distill.make_distill_step(
        t_net, s_net, tx, loss_fn=jax_dexp.make_named_loss(
            "biDirection_loss_ht", ARGS))
    new_state, loss = jax.device_get(step(
        jax_state.TrainState.create(s_vars, tx), t_vars,
        {k: jnp.asarray(v) for k, v in batch.items()}))

    teacher, student = _port("teacher", t_vars), _port("lighttoken_res",
                                                       s_vars)
    t_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    s_before = {k: v.clone() for k, v in student.state_dict().items()}
    kernels.reset_launches()
    port_loss = make_distill_step(
        teacher, student, make_optimizer(student),
        loss_fn=make_named_loss("biDirection_loss_ht", ARGS))(_t(batch))
    return dict(loss=float(loss), port_loss=float(port_loss),
                grads=params_from_jax({"params": new_state.opt_state}),
                stats=params_from_jax({"batch_stats": new_state.batch_stats}),
                teacher=teacher, student=student, t_before=t_before,
                s_before=s_before, launches=dict(kernels.LAUNCHES),
                t_net=t_net, t_vars=t_vars, batch=batch)


def test_distill_loss_matches_jax(distill):
    assert distill["port_loss"] == pytest.approx(distill["loss"], rel=1e-5)


def test_distill_student_gradients_match_jax(distill):
    want = distill["grads"]
    got = {n: p.grad for n, p in distill["student"].named_parameters()}
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


def test_distill_student_batch_stats_match_jax(distill):
    state = distill["student"].state_dict()
    stats = {k: v for k, v in distill["stats"].items() if ".running_" in k}
    assert len(stats) == 16
    for name, want in stats.items():
        np.testing.assert_allclose(state[name].numpy(), want.numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
        assert not torch.equal(state[name], distill["s_before"][name])


def test_distill_teacher_frozen_and_student_stepped(distill):
    teacher, student = distill["teacher"], distill["student"]
    assert not teacher.training and student.training
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, distill["t_before"][k]), k
    assert all(p.grad is None for p in teacher.parameters())
    moved = [k for k, v in student.state_dict().items()
             if not torch.equal(v, distill["s_before"][k])]
    assert len(moved) > 100
    # on the CPU no kernel runs: the plain versions carry both models
    assert all(v == 0 for v in distill["launches"].values())


def test_frozen_teacher_records_no_graph(distill):
    out = apply_frozen(distill["teacher"], _t(distill["batch"]))
    assert not distill["teacher"].training
    for key in ("flows", "feat1s", "feat2s", "crosses"):
        assert all(t.grad_fn is None and not t.requires_grad
                   for t in out[key])


def test_default_loss_raises_on_equal_widths(distill):
    """The reference's default cross_biDirection_loss_ht needs a student
    twice the teacher's width at the hint layers; with teacher ->
    lighttoken_res it fails in the JAX package and in the port alike."""
    batch = distill["batch"]
    t_net, t_vars = distill["t_net"], distill["t_vars"]
    tx = _capture_grads()
    with pytest.raises(TypeError, match="sub got incompatible shapes"):
        jax_distill.make_distill_step(t_net, t_net, tx)(
            jax_state.TrainState.create(t_vars, tx), t_vars,
            {k: jnp.asarray(v) for k, v in batch.items()})
    student = _port("lighttoken_res", t_vars)
    step = make_distill_step(distill["teacher"], student,
                             make_optimizer(student))
    with pytest.raises(RuntimeError, match="size of tensor"):
        step(_t(batch))


def test_teacher_history_matches_jax(distill):
    """compute_teacher_history over a 3-batch loader (numpy batches with
    paths): the teacher's loss per batch, 1e-5 relative."""
    loader = [tuple(_batch_np(s)[k] for k in
                    ("pos1", "pos2", "norm1", "norm2", "flow")) + (["p"] * B,)
              for s in (3, 4, 5)]
    want = jax_dexp.compute_teacher_history(distill["t_net"],
                                            distill["t_vars"], loader,
                                            max_batches=2)
    got = compute_teacher_history(distill["teacher"], loader, max_batches=2)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)
