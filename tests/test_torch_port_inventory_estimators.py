"""The experimental inventory's flow-head variants
(kd_pointcloud_tpu_torch/nn/experimental.py, groups c and d) and the two
inventory heads of nn/flowhead.py against the JAX package's, on the CPU.

Each flax module is built from jax.random.PRNGKey(0) at the shapes of
tests/test_experimental.py (B 2, N 64, C 16, K 8), its variables carried
into the port's module by params_from_jax (strict load), and every output
compared within 1e-5 abs. Heads with BatchNorm are compared in train mode
(outputs and the moved running statistics) and in eval mode on random
running statistics; SceneFlowEstimatorResidualSmooth normalises with batch
statistics and SceneFlowEstimatorResidualOcc with running ones in either
mode, as the JAX package fixes them.
"""

import jax
import numpy as np
import pytest
import torch

from kd_pointcloud_tpu.nn import experimental as jx
from kd_pointcloud_tpu.nn import flowhead as jfh
from kd_pointcloud_tpu_torch.models import params_from_jax
from kd_pointcloud_tpu_torch.nn import experimental as px
from kd_pointcloud_tpu_torch.nn import flowhead as pfh

torch.set_num_threads(1)
TOL = 1e-5
B, N, C, K = 2, 64, 16, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.abs(g.detach().numpy().astype(np.float64) - w).max() <= TOL


def _random_stats(variables, seed):
    rng = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 2.0, a.shape) if path[-1].key ==
                         "var" else rng.standard_normal(a.shape)
                         ).astype(np.float32),
        variables["batch_stats"])
    return dict(variables, batch_stats=stats)


def _stats_close(port, batch_stats):
    want = params_from_jax({"batch_stats": batch_stats})
    got = port.state_dict()
    for key, value in want.items():
        if "running" in key:
            assert np.abs(got[key].numpy() - value.numpy()).max() <= TOL, key


def _check(jax_mod, port, args, train_kw=None, bn="none"):
    """bn: "none" (no BatchNorm: one comparison), "running" (running
    statistics in every mode: random ones, both port modes against JAX's
    only apply), "batch" (batch statistics in every mode: both port modes
    against JAX's mutable apply), "flag" (JAX's train flag: train=True
    against port.train(), train=False on random statistics against
    port.eval())."""
    tkw = train_kw or {}
    variables = jax.device_get(jax_mod.init(jax.random.PRNGKey(0), *args,
                                            **tkw))
    if bn in ("running", "flag"):
        variables = _random_stats(variables, 1)
    targs = [None if a is None else _t(a) for a in args]
    if bn == "flag":
        port.load_state_dict(params_from_jax(variables), strict=True)
        want, upd = jax_mod.apply(variables, *args, train=True,
                                  mutable=["batch_stats"])
        _close(port.train()(*targs), want)
        _stats_close(port, upd["batch_stats"])
        port.load_state_dict(params_from_jax(variables), strict=True)
        with torch.no_grad():
            _close(port.eval()(*targs),
                   jax_mod.apply(variables, *args, train=False))
        return
    if bn == "batch":
        want, upd = jax_mod.apply(variables, *args, mutable=["batch_stats"])
    else:
        want = jax_mod.apply(variables, *args)
    for mode in (False, True):
        port.load_state_dict(params_from_jax(variables), strict=True)
        with torch.no_grad():
            _close(port.train(mode)(*targs), want)
        if bn == "batch":
            _stats_close(port, upd["batch_stats"])


@pytest.fixture
def head_inputs():
    rng = np.random.RandomState(0)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, N, 3), (B, N, C), (B, N, 8), (B, N, 3)))


FACTORIES = ["SceneFlowEstimatorSepResidual", "SceneFlowEstimatorResidualBias",
             "SceneFlowEstimatorResidualSVD",
             "SceneFlowEstimatorSetconvResidual",
             "SceneFlowEstimatorResidualFactor"]


@pytest.mark.parametrize("name", FACTORIES)
@pytest.mark.parametrize("with_flow", [True, False], ids=["flow", "no_flow"])
def test_generic_estimators_match_jax(head_inputs, name, with_flow):
    xyz, feats, cost, flow = head_inputs
    args = (xyz, feats, cost, flow if with_flow else None)
    kw = dict(channels=(16, 16), mlp=(16, 8), neighbors=K)
    _check(getattr(jx, name)(**kw), getattr(px, name)(C, 8, **kw), args,
           bn="running" if name == "SceneFlowEstimatorSepResidual"
           else "none")


def test_generic_estimator_refuses_an_unknown_conv():
    with pytest.raises(ValueError):
        px._GenericFlowEstimator("pointconv", C, 8)


def test_residual_smooth_uses_batch_statistics_in_both_modes(head_inputs):
    xyz, feats, cost, flow = head_inputs
    bid = np.random.RandomState(1).standard_normal((B, N, 4)).astype(
        np.float32)
    kw = dict(channels=(16,), mlp=(16, 8))
    _check(jx.SceneFlowEstimatorResidualSmooth(neighbors=K, **kw),
           px.SceneFlowEstimatorResidualSmooth(C, 4, 8, neighbors=K, **kw),
           (xyz, feats, bid, cost, flow), bn="batch")


@pytest.mark.parametrize("with_occ", [True, False], ids=["occ", "no_occ"])
def test_residual_occ_uses_running_statistics_in_both_modes(head_inputs,
                                                            with_occ):
    xyz, feats, cost, flow = head_inputs
    occ = np.random.RandomState(2).rand(B, N, 1).astype(np.float32)
    kw = dict(channels=(32,), mlp=(32, 16), neighbors=K)
    _check(jx.SceneFlowEstimatorResidualOcc(**kw),
           px.SceneFlowEstimatorResidualOcc(C, 8, 1 if with_occ else 0,
                                            **kw),
           (xyz, feats, cost, flow, occ if with_occ else None),
           bn="running")


def test_setconv_fuse_residual_matches_jax(head_inputs):
    xyz, feats, cost, flow = head_inputs
    kw = dict(channels=((32, 32), (32, 24)), mlp=(32, 16), neighbors=K)
    _check(jx.SceneFlowEstimatorSetconvFuseResidual(**kw),
           px.SceneFlowEstimatorSetconvFuseResidual(C, 8, **kw),
           (xyz, feats, cost, flow))


@pytest.mark.parametrize("with_flow", [True, False], ids=["flow", "no_flow"])
def test_flowhead_pointconv_matches_jax(head_inputs, with_flow):
    xyz, feats, cost, flow = head_inputs
    kw = dict(channels=(16, 16), mlp=(16, 8), neighbors=K)
    _check(jfh.SceneFlowEstimatorPointConv(**kw),
           pfh.SceneFlowEstimatorPointConv(C, 8, 3 if with_flow else 0,
                                           **kw),
           (xyz, feats, cost, flow if with_flow else None), bn="flag")


def test_flowhead_residual_iter_matches_jax(head_inputs):
    xyz, feats, cost, flow = head_inputs
    kw = dict(channels=(16, 16), mlp=(16, 8), neighbors=K, iters=3)
    _check(jfh.SceneFlowEstimatorResidualIter(**kw),
           pfh.SceneFlowEstimatorResidualIter(C, 8, **kw),
           (xyz, feats, cost, flow), bn="flag")


def test_point_warping_simple(head_inputs):
    xyz, _, _, flow = head_inputs
    want = np.asarray(jx.PointWarpingSimple()(xyz, xyz + 1.0, flow))
    got = px.PointWarpingSimple()(_t(xyz), _t(xyz) + 1.0, _t(flow))
    np.testing.assert_array_equal(got.numpy(), want)


def test_omission_ledger_equals_jax_entry_by_entry():
    assert list(px.OMITTED_VOTE_CLASSES) == list(jx.OMITTED_VOTE_CLASSES)
    for name, entry in jx.OMITTED_VOTE_CLASSES.items():
        assert px.OMITTED_VOTE_CLASSES[name] == entry
