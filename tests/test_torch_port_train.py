"""The port's training path against the JAX package, on the CPU.

- The pool's plain backward (torch.autograd of pool_plain, the reference
  the CUDA backward kernel is held to on the card) against JAX's Pallas
  backward _pool_bwd_pallas in interpret mode and against jax.vjp of
  _pool_ref, with exact ties and exact zeros before each leaky.
- One train step of the tiny teacher against JAX's make_train_step from
  the same variables: loss, every gradient leaf, BatchNorm statistics.
- The optimizer on identical gradients, the learning-rate schedules, the
  multi-scale loss, the padded-batch protocol and the eval step.

Inputs come from numpy seeds; every tolerance is stated where it is used.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kd_pointcloud_tpu.data import PAD_PATH as JAX_PAD_PATH
from kd_pointcloud_tpu.losses import multiscale as jax_ms
from kd_pointcloud_tpu.models import BidPointFlowNet as JaxNet
from kd_pointcloud_tpu.models import tiny_config as jax_tiny_config
from kd_pointcloud_tpu.ops.gather import group_points_kmajor
from kd_pointcloud_tpu.ops.pallas import pool_fused as jax_pool
from kd_pointcloud_tpu.train import loop as jax_loop
from kd_pointcloud_tpu.train import state as jax_state
from kd_pointcloud_tpu.utils.config import Config
from kd_pointcloud_tpu_torch.eval import make_eval_metrics_step
from kd_pointcloud_tpu_torch.losses import (multi_scale_loss,
                                            multi_scale_loss_per_sample,
                                            safe_norm)
from kd_pointcloud_tpu_torch.models import (BidPointFlowNet, params_from_jax,
                                            tiny_config)
from kd_pointcloud_tpu_torch.nn import leaky
from kd_pointcloud_tpu_torch.ops.pool_fused import pool_plain
from kd_pointcloud_tpu_torch.train import (PAD_PATH, batch_to_device,
                                           custom_lr, eval_sceneflow,
                                           lr_for_epoch, make_eval_step,
                                           make_optimizer, make_train_step,
                                           set_learning_rate, step_lr,
                                           supervised_loss)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------- pool backward

def _pool_case(c, seed):
    """Pool inputs with three kinds of special queries (queries 0-7: all K
    neighbours one row, so every p_k ties exactly; 8-15: the same, with
    v = -u[that row], so h0's pre-activation is exactly 0 and every p_k is
    the bias, which is exactly 0 in every fourth channel -- a K-way tie at
    exactly 0 after the second leaky; 16-23: v = -u[idx[:, q, 0]], an exact
    0 before the first leaky at neighbour 0 only; 24-31: neighbours
    alternate between rows 0 and 1 of u, which are equal, so the tie is
    between two rows and an even split shows in d_u)."""
    rng = np.random.RandomState(seed)
    B, N1, N2, K = 2, 64, 48, 16
    u = rng.standard_normal((B, N2, c)).astype(np.float32)
    v = rng.standard_normal((B, N1, c)).astype(np.float32)
    idx = rng.randint(0, N2, (B, N1, K)).astype(np.int32)
    w = (0.2 * rng.standard_normal((c, c))).astype(np.float32)  # (in, out)
    b = (0.2 * rng.standard_normal(c)).astype(np.float32)
    ct = rng.standard_normal((B, N1, c)).astype(np.float32)
    idx[:, :16, :] = idx[:, :16, :1]
    u[:, 1] = u[:, 0]
    idx[:, 24:32, 0::2], idx[:, 24:32, 1::2] = 0, 1
    b[::4] = 0.0
    for bb in range(B):
        v[bb, 8:24] = -u[bb, idx[bb, 8:24, 0]]
    return u, idx, v, w, b, ct


def _scatter_dg(dg_kmaj, idx, n2):
    """JAX's d_g (B, K, N1, C) folded onto the key table: d_u."""
    B, _, _, C = dg_kmaj.shape
    dg = np.transpose(np.asarray(dg_kmaj, np.float64), (0, 2, 1, 3))
    du = np.zeros((B, n2, C))
    for bb in range(B):
        np.add.at(du[bb], idx[bb].reshape(-1), dg[bb].reshape(-1, C))
    return du


def _port_pool_grads(u, idx, v, w, b, ct):
    ts = [_t(a).requires_grad_() for a in (u, v, w.T, b)]
    out = pool_plain(ts[0], _t(idx), ts[1], ts[2], ts[3])
    d_u, d_v, d_wt, d_b = torch.autograd.grad(out, ts, _t(ct))
    return [d_u.numpy(), d_v.numpy(), d_wt.numpy().T, d_b.numpy()]


def _assert_pool_grads(got, want):
    # float32 sums in another order (the scatter over idx, the K and row
    # sums of d_w / d_b): 1e-5 of each output's largest magnitude
    for name, g, x in zip(("d_u", "d_v", "d_w", "d_b"), got, want):
        x = np.asarray(x, np.float64)
        assert g.shape == x.shape, name
        assert np.abs(g - x).max() <= 1e-5 * np.abs(x).max(), name


@pytest.mark.parametrize("c", [32, 64])
def test_pool_plain_backward_matches_pallas_bwd_interpret(c, monkeypatch):
    """The plain backward against JAX's Pallas backward kernel, run as
    tests/test_pool_fused.py runs it on the CPU (interpret mode)."""
    monkeypatch.setattr(jax_pool.pl, "pallas_call",
                        functools.partial(jax_pool.pl.pallas_call,
                                          interpret=True))
    u, idx, v, w, b, ct = _pool_case(c, seed=c)
    d_g, d_v, (d_w,), (d_b,) = jax_pool._pool_bwd_pallas(
        group_points_kmajor(u, idx), jnp.asarray(v), (jnp.asarray(w),),
        (jnp.asarray(b),), 0, 1, jnp.asarray(ct))
    _assert_pool_grads(_port_pool_grads(u, idx, v, w, b, ct),
                       [_scatter_dg(d_g, idx, u.shape[1]), d_v, d_w, d_b])


@pytest.mark.parametrize("c", [32, 64])
def test_pool_plain_backward_matches_pool_ref_vjp(c):
    u, idx, v, w, b, ct = _pool_case(c, seed=c + 1)
    _, vjp = jax.vjp(lambda g, vv, ww, bb: jax_pool._pool_ref(g, vv, ww, bb,
                                                              0),
                     group_points_kmajor(u, idx), jnp.asarray(v),
                     (jnp.asarray(w),), (jnp.asarray(b),))
    d_g, d_v, (d_w,), (d_b,) = vjp(jnp.asarray(ct))
    _assert_pool_grads(_port_pool_grads(u, idx, v, w, b, ct),
                       [_scatter_dg(d_g, idx, u.shape[1]), d_v, d_w, d_b])


def test_pool_tie_splits_cotangent_evenly():
    """A tie between two equal rows of u: each gets half the cotangent (as
    the VJP of jnp.max), not the first one all of it."""
    u, idx, v, w, b, ct = _pool_case(32, seed=3)
    ct[:] = 0.0
    ct[0, 24] = 1.0
    d_u = _port_pool_grads(u, idx, v, w, b, ct)[0]
    assert np.abs(d_u[0, 0]).max() > 0
    np.testing.assert_array_equal(d_u[0, 0], d_u[0, 1])


def test_leaky_gradient_is_one_at_zero():
    """jax.nn.leaky_relu's slope at exactly 0 (F.leaky_relu's is 0.1)."""
    x = torch.tensor([-1.0, 0.0, -0.0, 2.0], requires_grad=True)
    (g,) = torch.autograd.grad(leaky(x).sum(), x)
    want = jax.grad(lambda a: jnp.sum(jax_pool._leaky(a)))(
        jnp.asarray([-1.0, 0.0, -0.0, 2.0]))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        leaky(x).detach().numpy(),
        torch.nn.functional.leaky_relu(x, 0.1).detach().numpy())


# ------------------------------------------------------------- one train step

B, N = 2, 256


def _batch_np(seed=0):
    rng = np.random.RandomState(seed)
    pc1 = rng.uniform(-2, 2, (B, N, 3)).astype(np.float32)
    pc2 = (pc1 + 0.1 * rng.standard_normal(pc1.shape)).astype(np.float32)
    return dict(pos1=pc1, pos2=pc2, norm1=pc1, norm2=pc2, flow=pc2 - pc1)


def _capture_grads():
    """An optax transformation whose updates are zero and whose state is the
    last gradient: JAX's make_train_step then hands back its gradient tree
    as new_state.opt_state, untouched."""
    zeros = functools.partial(jax.tree_util.tree_map, jnp.zeros_like)
    return optax.GradientTransformation(
        init=zeros, update=lambda grads, state, params=None: (zeros(grads),
                                                             grads))


@pytest.fixture(scope="module")
def jax_teacher():
    batch = _batch_np()
    cfg = dataclasses.replace(jax_tiny_config("teacher"), knn_method="exact")
    net = JaxNet(cfg)
    variables = jax.device_get(jax.jit(
        lambda k, a, b: net.init(k, a, b, a, b, train=False))(
            jax.random.PRNGKey(0), batch["pos1"], batch["pos2"]))
    return net, variables, batch


@pytest.fixture(scope="module")
def train_step(jax_teacher):
    net, variables, batch = jax_teacher
    tx = _capture_grads()
    state = jax_state.TrainState.create(variables, tx)
    step = jax_loop.make_train_step(net, tx, donate=False)
    new_state, loss = jax.device_get(step(state, {k: jnp.asarray(v) for k, v
                                                  in batch.items()}))

    model = BidPointFlowNet(tiny_config("teacher"), device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    port_loss = make_train_step(model, make_optimizer(model))(
        {k: _t(v) for k, v in batch.items()})
    return dict(loss=float(loss), grads=params_from_jax(
                    {"params": new_state.opt_state}),
                stats=params_from_jax({"batch_stats": new_state.batch_stats}),
                port_loss=float(port_loss), model=model)


def test_train_step_loss_matches_jax(train_step):
    assert abs(train_step["port_loss"] - train_step["loss"]) \
        <= 1e-5 * abs(train_step["loss"])


def _bias_before_batchnorm(name):
    # the Dense bias feeding a flow head's BatchNorm: the batch mean
    # removes it, so its true gradient is exactly 0 and both frameworks'
    # float32 values are rounding noise
    return name.startswith("flow") and ".convs." in name \
        and name.endswith("dense.bias")


def test_train_step_gradients_match_jax(train_step):
    """Every gradient leaf within 2e-4 of the leaf's largest magnitude: the
    same math, float32 sums in another order through the whole backward
    (measured worst 3.9e-5, median 9e-6 at this size). Leaves whose true
    gradient is 0 stay below 1e-5 of the largest gradient anywhere."""
    want = train_step["grads"]
    got = {n: p.grad for n, p in train_step["model"].named_parameters()}
    assert set(got) == set(want)
    top = max(float(g.abs().max()) for g in want.values())
    for name, g in got.items():
        w = want[name].numpy()
        err = float(np.abs(g.numpy() - w).max())
        if _bias_before_batchnorm(name):
            assert max(float(g.abs().max()), float(np.abs(w).max())) \
                <= 1e-5 * top, name
        else:
            assert err <= 2e-4 * float(np.abs(w).max()), (name, err)


def test_train_step_batch_stats_match_jax(train_step):
    """Running mean and variance after the step, as flax moves them (biased
    batch variance), within 1e-5."""
    state = train_step["model"].state_dict()
    stats = {k: v for k, v in train_step["stats"].items() if ".running_" in k}
    assert len(stats) == 16         # 2 BatchNorms in each of 4 flow heads
    for name, want in stats.items():
        np.testing.assert_allclose(state[name].numpy(), want.numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_eval_step_matches_jax(jax_teacher):
    """Per-sample (epe3d, loss) of the eval step, and the eval loss column
    of make_eval_metrics_step, against JAX's make_eval_step: 1e-5
    relative."""
    net, variables, batch = jax_teacher
    epe, loss, flow0 = jax.device_get(jax_loop.make_eval_step(net)(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}))
    model = BidPointFlowNet(tiny_config("teacher"), device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    tb = {k: _t(v) for k, v in batch.items()}
    p_epe, p_loss, p_flow0 = make_eval_step(model)(tb)
    np.testing.assert_allclose(p_epe.numpy(), epe, rtol=1e-5)
    np.testing.assert_allclose(p_loss.numpy(), loss, rtol=1e-5)
    np.testing.assert_allclose(p_flow0.numpy(), flow0, rtol=0, atol=1e-5)
    rows = make_eval_metrics_step(model, with_2d=False)(
        tb["pos1"], tb["pos2"], tb["norm1"], tb["norm2"], tb["flow"],
        torch.zeros(B, 6))
    assert rows.shape == (B, 7)
    np.testing.assert_allclose(rows[:, 6].numpy(), loss, rtol=1e-5)
    np.testing.assert_allclose(rows[:, 0].numpy(), epe, rtol=1e-5)


# ------------------------------------------------------ optimizer, schedules

def test_optimizer_matches_optax_on_identical_gradients():
    """Three Adam steps (the learning rate changed before the third) on the
    same gradients: parameters within 1e-6."""
    rng = np.random.RandomState(7)
    shapes = {"a": (5, 3), "b": (4,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]

    tx = jax_state.make_optimizer(1e-3, 1e-4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(_t(v)))
    opt = make_optimizer(module, 1e-3, 1e-4)
    for i, g in enumerate(grads):
        if i == 2:
            opt_state = jax_state.set_learning_rate(opt_state, 5e-4)
            set_learning_rate(opt, 5e-4)
        updates, opt_state = tx.update({k: jnp.asarray(v)
                                        for k, v in g.items()}, opt_state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        for k, p in module.named_parameters():
            p.grad = _t(g[k])
        opt.step()
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("epoch", [0, 99, 100, 250, 1000, 5000])
def test_lr_schedules_match_jax(epoch):
    assert step_lr(1e-3, epoch) == jax_state.step_lr(1e-3, epoch)
    assert step_lr(2e-3, epoch, 50, 0.7) == \
        jax_state.step_lr(2e-3, epoch, 50, 0.7)
    lrs, switch = [1e-4, 5e-4, 1e-3], [300, 100, 0]
    assert custom_lr(epoch, lrs, switch) == \
        jax_state.custom_lr(epoch, lrs, switch)
    for cfg in (Config(learning_rate=1e-3),
                Config(custom_lr=True, lrs=lrs, lr_switch_epochs=switch,
                       learning_rate=1e-3)):
        assert lr_for_epoch(cfg, epoch) == jax_state.lr_for_epoch(cfg, epoch)


# ------------------------------------------------------------------ the loss

def _loss_case(seed, zero_level=None, iterative=False):
    """Predicted flows at 4 levels, ground truth and an FPS-like index
    chain (nested random subsets)."""
    rng = np.random.RandomState(seed)
    sizes = (64, 32, 16, 8)
    gt = rng.standard_normal((3, sizes[0], 3)).astype(np.float32)
    idxs = [np.stack([rng.permutation(a)[:b] for _ in range(3)])
            .astype(np.int32) for a, b in zip(sizes, sizes[1:])]
    gts = [gt]
    for i in idxs:
        gts.append(np.take_along_axis(gts[-1], i[..., None], axis=1))
    preds = [(g + 0.3 * rng.standard_normal(g.shape)).astype(np.float32)
             for g in gts]
    if zero_level is not None:
        preds[zero_level] = gts[zero_level].copy()
    if iterative:
        preds[0] = [preds[0], (gts[0] + 0.1).astype(np.float32)]
    return preds, gt, idxs


def _tree(fn, preds):
    return [[fn(x) for x in p] if isinstance(p, list) else fn(p)
            for p in preds]


@pytest.mark.parametrize("case", [dict(), dict(zero_level=2),
                                  dict(iterative=True)],
                         ids=["plain", "zero_residual", "iterative"])
def test_multi_scale_loss_matches_jax(case):
    """Loss values (1e-6 relative) and their gradients by the predictions
    (1e-6 absolute; at a zero residual both are exactly 0)."""
    preds, gt, idxs = _loss_case(1, **case)
    jidx = [jnp.asarray(i) for i in idxs]
    want_per = jax_ms.multi_scale_loss_per_sample(_tree(jnp.asarray, preds),
                                                  jnp.asarray(gt), jidx)
    want, want_g = jax.value_and_grad(
        lambda p: jax_ms.multi_scale_loss(p, jnp.asarray(gt), jidx))(
            _tree(jnp.asarray, preds))
    tp = _tree(lambda a: _t(a).requires_grad_(), preds)
    tidx = [_t(i) for i in idxs]
    got = multi_scale_loss(tp, _t(gt), tidx)
    np.testing.assert_allclose(
        multi_scale_loss_per_sample(tp, _t(gt), tidx).detach().numpy(),
        np.asarray(want_per), rtol=1e-6)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    flat = jax.tree_util.tree_leaves(tp)
    got_g = torch.autograd.grad(got, flat)
    for g, w in zip(got_g, jax.tree_util.tree_leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    if "zero_level" in case:
        assert float(got_g[2].abs().max()) == 0.0


def test_safe_norm_gradient_at_zero():
    x = torch.zeros(2, 3, requires_grad=True)
    (g,) = torch.autograd.grad(safe_norm(x).sum(), x)
    assert torch.isfinite(g).all() and float(g.abs().max()) == 0.0
    assert float(safe_norm(x.detach())[0]) == pytest.approx(1e-10)


def test_padded_batch_and_weighted_loss_match_jax():
    """batch_to_device's pad rows and weights equal JAX's; the default loss
    over a padded batch is the mean over the real rows only."""
    rng = np.random.RandomState(4)
    arrs = [rng.standard_normal((2, 64, 3)).astype(np.float32)
            for _ in range(5)]
    batch_np = (*arrs, ["a", "b"])
    got = batch_to_device(batch_np, "cpu", pad_to=4)
    want = jax_loop.batch_to_device(batch_np, pad_to=4)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))

    preds, gt, idxs = _loss_case(5)
    pad = lambda a: np.concatenate([a, a[-1:]])   # noqa: E731
    out = dict(flows=[_t(pad(p)) for p in preds],
               fps_idx1=[_t(pad(i)) for i in idxs])
    batch = dict(flow=_t(pad(gt)), weight=_t([1.0, 1.0, 1.0, 0.0]))
    per = jax_ms.multi_scale_loss_per_sample(
        [jnp.asarray(pad(p)) for p in preds], jnp.asarray(pad(gt)),
        [jnp.asarray(pad(i)) for i in idxs])
    w = jnp.asarray([1.0, 1.0, 1.0, 0.0])
    assert float(supervised_loss(out, batch)) == pytest.approx(
        float(jnp.sum(per * w) / jnp.sum(w)), rel=1e-6)
    assert float(supervised_loss(out, batch)) == pytest.approx(float(
        jax_ms.multi_scale_loss([jnp.asarray(p) for p in preds],
                                jnp.asarray(gt),
                                [jnp.asarray(i) for i in idxs])), rel=1e-6)


def test_eval_sceneflow_masks_pad_rows():
    assert PAD_PATH == JAX_PAD_PATH
    rng = np.random.RandomState(6)
    loader = [(*[rng.standard_normal((2, 8, 3)).astype(np.float32)
                 for _ in range(5)], paths)
              for paths in (["x", "y"], ["z", PAD_PATH])]
    seen = []

    def eval_step(batch):
        seen.append(batch["pos1"].shape[0])
        epe = batch["flow"][:, 0, 0]
        return epe, 2 * epe, None

    epe, loss = eval_sceneflow(eval_step, loader, "cpu", pad_to=3)
    real = np.concatenate([loader[0][4][:, 0, 0], loader[1][4][:1, 0, 0]])
    assert seen == [3, 3]
    assert epe == pytest.approx(float(real.mean()), rel=1e-6)
    assert loss == pytest.approx(2 * float(real.mean()), rel=1e-6)
