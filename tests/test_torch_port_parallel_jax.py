"""The port's data-parallel teacher train step on 2 gloo ranks, in float32,
against the JAX package's sharded step on 2 devices of the suite's virtual
CPU mesh, from the same seeded weights: the divisible global batch of 4,
and the padded one (batch_size 3 padded to 4 by data_parallel_plan, the
pad row masked out of the loss by its weight but inside the BatchNorm
statistics).

JAX's step runs in float64 (the same float32 weights and batch, cast;
jax.enable_x64 for that call only), as tests/test_torch_port_students_
distill.py runs it: from these weights JAX's own float32 gradients are off
its float64 ones by up to 6e-3 of a leaf's largest value (median 6e-4;
flax's BatchNorm takes the variance as E[x^2] - E[x]^2 in float32), where
the port's float32 step stays within 1.3e-5 on the batches below.

The JAX optimizer is a transformation whose state is the last gradient, so
its step hands back its gradient tree; the port's ranks run the real Adam,
whose update is a function of that gradient
(tests/test_torch_port_train.py holds it against optax on identical
gradients). Tolerances are the train step's
(tests/test_torch_port_train.py): loss 1e-5 relative, every gradient leaf
within 2e-4 of the leaf's largest value (leaves whose true gradient is 0
below 1e-5 of the largest gradient), BatchNorm statistics 1e-5.
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
from kd_pointcloud_tpu.parallel import mesh as jax_mesh
from kd_pointcloud_tpu.train import loop as jax_loop
from kd_pointcloud_tpu.train import state as jax_state
from kd_pointcloud_tpu_torch.models import params_from_jax

import torch_parallel_ranks as ranks

torch.set_num_threads(1)

# (global batch, padded to, batch seed). Float32 gradients of this model
# are ill-conditioned: a max-pool or kNN choice that a rounding difference
# flips moves some leaves by 1e-4 to 4e-2 of their largest value, on one
# device and on two ranks alike, and which batches it hits changes with
# the summation order (the port's float32 step against its own float64
# step from these weights, seeds 0-7: within 1.3e-5 at every leaf on one
# device and on two ranks for seeds 3 and 4 of batch 4 and 0, 2 and 3 of
# batch 3 padded). The cases take the first such seed of each, so that
# the tolerances are the train step's (test_torch_port_train.py's batch is
# such a batch too); tests/test_torch_port_parallel.py holds the ranks to
# one device in float64, where no choice flips, on any batch.
CASES = {"divisible": (4, None, 3), "padded": (3, 4, 0)}


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


def _capture_grads():
    """Zero updates; the state is the last gradient."""
    zeros = functools.partial(jax.tree_util.tree_map, jnp.zeros_like)
    return optax.GradientTransformation(
        init=zeros, update=lambda grads, state, params=None: (zeros(grads),
                                                             grads))


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if np.asarray(a).dtype == np.float32 else a, tree)


def _zero_gradient_leaf(name):
    # the Dense bias feeding a flow head's BatchNorm: the batch mean
    # removes it, so its true gradient is 0 and any value is rounding noise
    return name.startswith("flow") and ".convs." in name \
        and name.endswith("dense.bias")


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """JAX's sharded step on 2 devices for each case, the port's ranks
    running the same cases meanwhile."""
    net = JaxNet(dataclasses.replace(jax_tiny_config("teacher"),
                                     knn_method="exact"))
    b = ranks.batch_np(2, 0)
    shapes = jax.eval_shape(lambda k, x, y: net.init(k, x, y, x, y,
                                                     train=False),
                            jax.random.PRNGKey(0), b["pos1"], b["pos2"])
    # flax's initial statistics: mean 0, var 1
    variables = {"params": _seeded_tree(shapes["params"],
                                        np.random.RandomState(0)),
                 "batch_stats": jax.tree_util.tree_map_with_path(
                     lambda p, s: np.full(s.shape, 0.0 if "mean" in str(p[-1])
                                          else 1.0, np.float32),
                     shapes["batch_stats"])}
    state_dict = params_from_jax(variables)
    batches = {k: ranks.loader_batch(bs, seed)
               for k, (bs, _, seed) in CASES.items()}
    started = ranks.start(2, {k: ("train32", dict(
        state=state_dict, batch=batches[k], pad_to=pad))
        for k, (_, pad, _) in CASES.items()},
        str(tmp_path_factory.mktemp("pg")))

    orig = jax_mesh.make_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mesh, "make_mesh", lambda n_devices=None,
                   devices=None: orig(2 if n_devices is None else n_devices,
                                      devices))
        tx = _capture_grads()
        step = jax_loop.make_train_step(net, tx, donate=False)
        want = {}
        for key, (bs, _, _) in CASES.items():
            mesh, sharding, padded = jax_mesh.data_parallel_plan(bs)
            assert mesh.devices.size == 2 and padded == 4
            pad_to = padded if padded != bs else None
            batch = jax_loop.batch_to_device(batches[key], pad_to=pad_to)
            with jax.enable_x64(True):
                state = jax_mesh.replicate(mesh, jax_state.TrainState.create(
                    _f64(variables), tx))
                new_state, loss = jax.device_get(step(state, {
                    k: jax.device_put(v, sharding)
                    for k, v in _f64(batch).items()}))
            want[key] = dict(
                loss=float(loss),
                grads=params_from_jax({"params": new_state.opt_state}),
                stats=params_from_jax({"batch_stats":
                                       new_state.batch_stats}))
    got = ranks.collect(started)
    return {k: dict(want=want[k], got=ranks.result(got, k)) for k in CASES}


@pytest.mark.parametrize("case", CASES)
def test_loss_matches_jax_sharded_step(steps, case):
    want = steps[case]["want"]["loss"]
    for got in steps[case]["got"]:
        assert abs(got["loss"] - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("case", CASES)
def test_gradients_match_jax_sharded_step(steps, case):
    want = steps[case]["want"]["grads"]
    top = max(float(g.abs().max()) for g in want.values())
    for got in steps[case]["got"]:
        assert set(got["grads"]) == set(want)
        for name, w in want.items():
            g = got["grads"][name]
            if _zero_gradient_leaf(name):
                assert max(float(g.abs().max()), float(w.abs().max())) \
                    <= 1e-5 * top, name
            else:
                err = float((g.double() - w.double()).abs().max())
                assert err <= 2e-4 * float(w.abs().max()), (name, err)


@pytest.mark.parametrize("case", CASES)
def test_batch_stats_match_jax_sharded_step(steps, case):
    """Running mean and variance over the global batch (the pad row
    included), as flax moves them, on both ranks."""
    stats = {k: v for k, v in steps[case]["want"]["stats"].items()
             if ".running_" in k}
    assert len(stats) == 16
    for got in steps[case]["got"]:
        for name, want in stats.items():
            np.testing.assert_allclose(got["state"][name].double().numpy(),
                                       want.double().numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)
