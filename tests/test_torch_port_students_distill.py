"""The port's KD step into the halved-width student against the JAX
package's, on the CPU.

A tiny `teacher` (JAX init, key 1) distils into a tiny `student` (key 0:
bottleneck level blocks, half the teacher's widths, a C = 16 cost volume
at l0); the port's models get the same weights through params_from_jax.
One step of JAX's make_distill_step and of the port's with biDirectionLoss
through make_named_loss (gamma 0.3, gamma2 0.3, beta 0.8: flow terms only,
since the student's feature widths are not the teacher's), on the same
numpy batch. The JAX optimizer is a transformation whose state is the last
gradient, so the step hands back its gradient tree; the port's optimizer
is the real Adam. Tolerances are those of tests/test_torch_port_distill.py:
loss 1e-5 relative, every gradient leaf 2e-4 of its largest value (leaves
whose true gradient is 0 below 1e-5 of the largest gradient), BatchNorm
statistics 1e-5. The teacher comes out of the step bit-unchanged.

The gradients are held against the JAX step run in float64 (the same
float32 weights and batch, cast; jax.enable_x64 for that call only). For
this student JAX's own float32 step is off its float64 gradients by up to
1e-2 of a leaf's largest value (flow1's weight nets), while the port's
float32 step stays within 1e-5 of them; the float64 step is the sharper
reference, at the same bound. Two more witnesses: the port's plain step
run in float64 on the same weights and batch matches JAX's float64 step
to 1e-12 (loss, relative) and 1e-11 of each leaf's largest value (about
1e-13 measured), so the two implementations compute the same function;
and JAX's float32 step with only the BatchNorm batch statistics (flax's
_compute_stats: the mean and variance over the batch and point axes, and
so their VJP) computed in float64 comes within the same 2e-4 of the
float64 gradients (about 1e-5 measured, as the port's float32 step).
Those reductions, in the flow heads' PointConvs, are where JAX's float32
step loses its digits.
"""

import contextlib
import dataclasses
import functools

import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from kd_pointcloud_tpu.models import BidPointFlowNet as JaxNet
from kd_pointcloud_tpu.models import tiny_config as jax_tiny_config
from kd_pointcloud_tpu.train import distill as jax_distill
from kd_pointcloud_tpu.train import distill_experiment as jax_dexp
from kd_pointcloud_tpu.train import state as jax_state
from kd_pointcloud_tpu_torch.models import (BidPointFlowNet, params_from_jax,
                                            tiny_config)
from kd_pointcloud_tpu_torch.models.jax_bridge import torch_key
from kd_pointcloud_tpu_torch.nn import BottleNeck
from kd_pointcloud_tpu_torch.ops import kernels
from kd_pointcloud_tpu_torch.train import (make_distill_step, make_named_loss,
                                           make_optimizer)

torch.set_num_threads(1)

B, N = 2, 256
LOSS = "biDirectionLoss"
ARGS = dict(gamma=0.3, gamma2=0.3, beta=0.8)


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


def _zero_gradient_leaf(name):
    # the Dense bias feeding a flow head's BatchNorm: the batch mean
    # removes it, so its true gradient is 0 and any value is rounding noise
    return name.startswith("flow") and ".convs." in name \
        and name.endswith("dense.bias")


def _grads64(tree):
    """params_from_jax's keys and layouts for a gradient tree, kept in
    float64 (params_from_jax casts to float32)."""
    out = {}
    for path, value in flatten_dict(tree, sep="/").items():
        arr = np.asarray(value, np.float64)
        out[torch_key(path)] = torch.tensor(
            arr.T if path.endswith("kernel") else arr)
    return out


@contextlib.contextmanager
def _plain_in_float64():
    """The plain versions compute in their inputs' dtype; their guards hold
    them to the kernels' float32, so let float64 through for this witness."""
    check = kernels.check_tensor

    def check64(name, t, dtype, ndim):
        return check(name, t, torch.float64 if dtype == torch.float32
                     else dtype, ndim)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "check_tensor", check64)
        yield


def _port_step(teacher, student, batch):
    return make_distill_step(
        teacher, student, make_optimizer(student, 1e-3, 1e-4),
        loss_fn=make_named_loss(LOSS, ARGS))(
            {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})


def _worst(got, want):
    """Largest error over the non-zero-gradient leaves, each relative to
    its leaf's largest value, and that leaf."""
    return max((float((got[n].double() - want[n].double()).abs().max())
                / float(want[n].abs().max()), n)
               for n in want if not _zero_gradient_leaf(n))


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if np.asarray(a).dtype == np.float32 else a, tree)


@pytest.fixture(scope="module")
def distill():
    batch = _batch_np()
    t_net, t_vars = _jax_init("teacher", 1, batch)
    s_net, s_vars = _jax_init("student", 0, batch)
    tx = _capture_grads()
    step = jax_distill.make_distill_step(
        t_net, s_net, tx, loss_fn=jax_dexp.make_named_loss(LOSS, ARGS))
    new_state, loss = jax.device_get(step(
        jax_state.TrainState.create(s_vars, tx), t_vars,
        {k: jnp.asarray(v) for k, v in batch.items()}))
    with jax.enable_x64(True):
        state64, loss64 = jax.device_get(step(
            jax_state.TrainState.create(_f64(s_vars), tx), _f64(t_vars),
            _f64(batch)))

    teacher, student = _port("teacher", t_vars), _port("student", s_vars)
    t_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    s_before = {k: v.clone() for k, v in student.state_dict().items()}
    kernels.reset_launches()
    port_loss = _port_step(teacher, student, batch)
    launches = dict(kernels.LAUNCHES)
    student64 = _port("student", s_vars).double()
    with _plain_in_float64():
        port_loss64 = _port_step(_port("teacher", t_vars).double(),
                                 student64,
                                 {k: v.astype(np.float64)
                                  for k, v in batch.items()})
    return dict(loss=float(loss), port_loss=float(port_loss),
                loss64=float(loss64), port_loss64=float(port_loss64),
                grads64=_grads64(state64.opt_state),
                port_grads64={n: p.grad
                              for n, p in student64.named_parameters()},
                jax_net=(t_net, s_net, t_vars, s_vars, batch),
                grads=params_from_jax({"params": state64.opt_state}),
                stats=params_from_jax({"batch_stats": new_state.batch_stats}),
                teacher=teacher, student=student, t_before=t_before,
                s_before=s_before, launches=launches)


def test_student_is_the_halved_bottleneck_model(distill):
    student = distill["student"]
    assert isinstance(student.level0_1, BottleNeck)
    # the l0 cost volume pools at C = 16, half the teacher's 32
    assert student.cross0.mlp1.layers[0].dense.weight.shape == (16, 16)
    assert distill["teacher"].cross0.mlp1.layers[0].dense.weight.shape == \
        (32, 32)


def test_student_distill_loss_matches_jax(distill):
    assert distill["port_loss"] == pytest.approx(distill["loss"], rel=1e-5)


def test_student_distill_gradients_match_jax(distill):
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


def test_student_distill_batch_stats_match_jax(distill):
    state = distill["student"].state_dict()
    stats = {k: v for k, v in distill["stats"].items() if ".running_" in k}
    assert len(stats) == 16
    for name, want in stats.items():
        np.testing.assert_allclose(state[name].numpy(), want.numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
        assert not torch.equal(state[name], distill["s_before"][name])


def test_student_distill_teacher_frozen(distill):
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


def test_student_distill_float64_port_matches_jax_float64(distill):
    # the plain versions in float64 against JAX in float64: the same
    # function, so agreement far below float32's rounding
    assert distill["port_loss64"] == pytest.approx(distill["loss64"],
                                                   rel=1e-12)
    got, want = distill["port_grads64"], distill["grads64"]
    assert set(got) == set(want)
    assert all(g.dtype == torch.float64 for g in got.values())
    worst, leaf = _worst(got, want)
    assert worst <= 1e-11, (leaf, worst)


def test_jax_float32_loses_its_digits_in_batchnorm_statistics(distill):
    """JAX's float32 step with only flax's BatchNorm batch statistics in
    float64 is as close to the float64 gradients as the port's float32
    step; JAX's plain float32 step is not."""
    t_net, s_net, t_vars, s_vars, batch = distill["jax_net"]
    tx = _capture_grads()
    compute_stats = flax_norm._compute_stats

    def stats_in_float64(x, axes, dtype, *args, **kwargs):
        mean, var = compute_stats(x.astype(jnp.float64), axes, jnp.float64,
                                  *args, **kwargs)
        return mean.astype(x.dtype), var.astype(x.dtype)

    def jax_grads():
        step = jax_distill.make_distill_step(
            t_net, s_net, tx, loss_fn=jax_dexp.make_named_loss(LOSS, ARGS))
        state, _ = jax.device_get(step(
            jax_state.TrainState.create(s_vars, tx), t_vars,
            {k: jnp.asarray(v) for k, v in batch.items()}))
        return _grads64(state.opt_state)

    want = distill["grads64"]
    with jax.enable_x64(True):
        plain32 = jax_grads()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(flax_norm, "_compute_stats", stats_in_float64)
            bn64 = jax_grads()
    assert all(g.dtype == torch.float64 for g in plain32.values())
    worst_plain, leaf = _worst(plain32, want)
    assert worst_plain > 1e-3, (leaf, worst_plain)
    assert leaf.startswith("flow1.") and ".weightnet." in leaf, leaf
    worst_bn, leaf = _worst(bn64, want)
    assert worst_bn <= 2e-4, (leaf, worst_bn)
    port = {n: p.grad for n, p in distill["student"].named_parameters()}
    assert _worst(port, want)[0] <= 2e-4
