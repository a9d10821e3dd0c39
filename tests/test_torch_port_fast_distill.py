"""The port's fast (attentive per-iteration) KD step against the JAX
package's, on the CPU.

A tiny `bifeat` teacher (JAX init, key 1: two refinement iterations at
l0-l2) distils into a tiny `fg` student (key 0); the port's models get the
same weights through params_from_jax. One step of JAX's
make_fast_distill_step and of the port's, att_iter_loss with gamma 0.6 and
layers [1, 2] (configs/fast_distill.yaml), on the same numpy batch. The
JAX optimizer is a transformation whose state is the last gradient, so the
step hands back its gradient tree; the port's optimizer is the real Adam.

Tolerances, as tests/test_torch_port_students_distill.py and for its
reason: the gradients are held against JAX's step run in float64 (the same
float32 weights and batch, cast; jax.enable_x64 for that call only),
because JAX's own float32 step loses up to about 1e-2 of a leaf's largest
value in flax BatchNorm's batch statistics, and the FG student's flow
heads have the same BatchNorm sites. Every gradient leaf within 2e-4 of
its largest value (leaves whose true gradient is 0 below 1e-5 of the
largest gradient), the loss within 1e-5 relative and the BatchNorm
statistics within 1e-5 abs, all of the float64 step. The port's
plain step run in float64 matches JAX's float64 step to 1e-12 (loss,
relative) and 1e-11 of each leaf's largest value: the same function. The
teacher comes out of the step bit-unchanged.
"""

import contextlib
import dataclasses
import functools

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
from kd_pointcloud_tpu.train import state as jax_state
from kd_pointcloud_tpu_torch.losses import att_iter_loss
from kd_pointcloud_tpu_torch.models import (BidPointFlowNet, params_from_jax,
                                            tiny_config)
from kd_pointcloud_tpu_torch.models.jax_bridge import torch_key
from kd_pointcloud_tpu_torch.ops import kernels
from kd_pointcloud_tpu_torch.train import (apply_frozen,
                                           make_fast_distill_step,
                                           make_optimizer)

torch.set_num_threads(1)

B, N = 2, 256
GAMMA, LAYERS = 0.6, (1, 2)


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
    return make_fast_distill_step(
        teacher, student, make_optimizer(student, 1e-3, 1e-4), gamma=GAMMA,
        layers=LAYERS)({k: torch.from_numpy(np.array(v))
                        for k, v in batch.items()})


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
    t_net, t_vars = _jax_init("bifeat", 1, batch)
    s_net, s_vars = _jax_init("fg", 0, batch)
    tx = _capture_grads()
    step = jax_distill.make_fast_distill_step(t_net, s_net, tx, gamma=GAMMA,
                                              layers=LAYERS)
    with jax.enable_x64(True):
        state64, loss64 = jax.device_get(step(
            jax_state.TrainState.create(_f64(s_vars), tx), _f64(t_vars),
            _f64(batch)))

    teacher, student = _port("bifeat", t_vars), _port("fg", s_vars)
    t_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    s_before = {k: v.clone() for k, v in student.state_dict().items()}
    kernels.reset_launches()
    port_loss = _port_step(teacher, student, batch)
    launches = dict(kernels.LAUNCHES)
    student64 = _port("fg", s_vars).double()
    with _plain_in_float64():
        port_loss64 = _port_step(_port("bifeat", t_vars).double(),
                                 student64,
                                 {k: v.astype(np.float64)
                                  for k, v in batch.items()})
    return dict(port_loss=float(port_loss),
                loss64=float(loss64), port_loss64=float(port_loss64),
                grads64=_grads64(state64.opt_state),
                port_grads64={n: p.grad
                              for n, p in student64.named_parameters()},
                stats=params_from_jax({"batch_stats": state64.batch_stats}),
                teacher=teacher, student=student, t_before=t_before,
                s_before=s_before, launches=launches,
                t_vars=t_vars, batch=batch)


def test_teacher_is_iterative_and_student_is_fg(distill):
    """The teacher's l1 and l2 flows, which the loss reads, are lists of
    two iterations; the student's are tensors."""
    t_out = apply_frozen(distill["teacher"], {
        k: torch.from_numpy(v) for k, v in distill["batch"].items()})
    s_cfg = distill["student"].cfg
    assert (distill["teacher"].cfg.iters, s_cfg.iters) == (2, 1)
    assert s_cfg.cross == "fg" and s_cfg.encoder == "pointconv"
    for lvl in LAYERS:
        assert len(t_out["flows"][lvl]) == 2
        assert not torch.equal(*t_out["flows"][lvl])


def test_fast_distill_loss_matches_jax(distill):
    assert distill["port_loss"] == pytest.approx(distill["loss64"], rel=1e-5)


def test_fast_distill_gradients_match_jax_float64(distill):
    want = distill["grads64"]
    got = {n: p.grad for n, p in distill["student"].named_parameters()}
    assert set(got) == set(want)
    top = max(float(g.abs().max()) for g in want.values())
    for name, g in got.items():
        w = want[name]
        if _zero_gradient_leaf(name):
            assert max(float(g.abs().max()), float(w.abs().max())) \
                <= 1e-5 * top, name
        else:
            err = float((g.double() - w).abs().max())
            assert err <= 2e-4 * float(w.abs().max()), (name, err)
    # the FG encoder's PointConv and the cross layers' projections train
    for name in ("level0.dense.weight", "level0_lift.dense.weight",
                 "cross0.cross_t11.weight", "cross3.pos2.weight"):
        assert float(got[name].abs().max()) > 0, name


def test_fast_distill_batch_stats_match_jax(distill):
    state = distill["student"].state_dict()
    stats = {k: v for k, v in distill["stats"].items() if ".running_" in k}
    assert len(stats) == 16
    for name, want in stats.items():
        np.testing.assert_allclose(state[name].numpy(), want.numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
        assert not torch.equal(state[name], distill["s_before"][name])


def test_fast_distill_teacher_frozen(distill):
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


def test_fast_distill_float64_port_matches_jax_float64(distill):
    # the plain versions in float64 against JAX in float64: the same
    # function, so agreement far below float32's rounding
    assert distill["port_loss64"] == pytest.approx(distill["loss64"],
                                                   rel=1e-12)
    got, want = distill["port_grads64"], distill["grads64"]
    assert set(got) == set(want)
    assert all(g.dtype == torch.float64 for g in got.values())
    worst, leaf = _worst(got, want)
    assert worst <= 1e-11, (leaf, worst)


def test_att_iter_loss_on_the_models_outputs(distill):
    """The loss of the step, recomputed from the port's eval-mode outputs
    of both models, against JAX's att_iter_loss on the JAX models' outputs
    for the same weights and batch: the per-iteration contract feeds the
    loss the same way on both sides."""
    from kd_pointcloud_tpu.losses import att_iter_loss as jax_att_iter_loss
    batch = distill["batch"]
    t_net = JaxNet(dataclasses.replace(jax_tiny_config("bifeat"),
                                       knn_method="exact"))
    t_out = jax.jit(lambda v, a, b: t_net.apply(v, a, b, a, b, train=False))(
        distill["t_vars"], batch["pos1"], batch["pos2"])
    teacher = _port("bifeat", distill["t_vars"])
    mine = apply_frozen(teacher, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    flow = torch.from_numpy(batch["flow"])
    # the teacher scored against itself at its last iterations: a student
    # whose flows are the teacher's final ones
    s_flows = [f[-1] if isinstance(f, list) else f for f in mine["flows"]]
    got = att_iter_loss(s_flows, mine["fps_idx1"], flow, mine["flows"],
                        mine["fps_idx1"], GAMMA, LAYERS)
    want = jax_att_iter_loss(
        [f[-1] if isinstance(f, list) else f for f in t_out["flows"]],
        t_out["fps_idx1"], batch["flow"], t_out["flows"], t_out["fps_idx1"],
        GAMMA, LAYERS)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
