"""The port's teacher against the JAX teacher, at tiny_config on the CPU.

Same numpy inputs, same weights (carried by params_from_jax), exact kNN on
both sides: all four flow levels within 1e-5 abs (the bound the JAX package
met against the reference PyTorch model, tests/test_torch_parity.py), FPS
chains equal. The JAX forward runs once per module.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kd_pointcloud_tpu.eval.metrics import evaluate_3d as jax_evaluate_3d
from kd_pointcloud_tpu.eval.metrics import evaluate_3d_jax
from kd_pointcloud_tpu.models import PRESETS as JAX_PRESETS
from kd_pointcloud_tpu.models import BidPointFlowNet as JaxNet
from kd_pointcloud_tpu.models import tiny_config as jax_tiny_config
from kd_pointcloud_tpu_torch.eval import (evaluate_3d, evaluate_3d_torch,
                                          evaluate_model, synthetic_pairs)
from kd_pointcloud_tpu_torch.models import (PRESETS, BidPointFlowNet,
                                            ModelConfig, check_config,
                                            params_from_jax, tiny_config)

torch.set_num_threads(1)

N = 256
TOL = 1e-5


def _perturb_batch_stats(stats, rng):
    """Non-trivial BN running statistics, so eval-mode BN is exercised."""
    return jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 2.0, a.shape) if a.ndim else a)
        .astype(np.float32), stats)


@pytest.fixture(scope="module")
def teacher():
    rng = np.random.RandomState(0)
    pc1 = rng.uniform(-2, 2, (1, N, 3)).astype(np.float32)
    pc2 = (pc1 + 0.1 * rng.standard_normal(pc1.shape)).astype(np.float32)
    cfg = dataclasses.replace(jax_tiny_config("teacher"), knn_method="exact")
    net = JaxNet(cfg)
    variables = jax.jit(lambda k: net.init(k, pc1, pc2, pc1, pc2,
                                           train=False))(jax.random.PRNGKey(0))
    variables = {"params": variables["params"],
                 "batch_stats": _perturb_batch_stats(
                     variables["batch_stats"], rng)}
    out = jax.device_get(jax.jit(
        lambda v: net.apply(v, pc1, pc2, pc1, pc2, train=False))(variables))
    variables = jax.device_get(variables)

    model = BidPointFlowNet(tiny_config("teacher"), device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    model.eval()
    with torch.no_grad():
        mine = model(*(torch.from_numpy(a) for a in (pc1, pc2, pc1, pc2)))
    return out, mine, model, variables


@pytest.mark.parametrize("lvl", range(4))
def test_flows_match_jax(teacher, lvl):
    out, mine, _, _ = teacher
    want = np.asarray(out["flows"][lvl])
    got = mine["flows"][lvl].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("key", ["fps_idx1", "fps_idx2"])
def test_fps_chains_equal(teacher, key):
    out, mine, _, _ = teacher
    assert len(mine[key]) == len(out[key]) == 3
    for want, got in zip(out[key], mine[key]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("key", ["pc1", "pc2", "feat1s", "feat2s", "crosses"])
def test_other_outputs_match_jax(teacher, key):
    out, mine, _, _ = teacher
    assert len(mine[key]) == len(out[key])
    for want, got in zip(out[key], mine[key]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)


def _metric_pred_gt(seed):
    """Predictions whose errors straddle every metric threshold (0.05,
    0.1, 0.3 m and 5 / 10 % relative)."""
    rng = np.random.RandomState(seed)
    gt = rng.standard_normal((3, 500, 3)).astype(np.float32)
    pred = (gt + 0.08 * rng.standard_normal(gt.shape)).astype(np.float32)
    return pred, gt


def test_evaluate_model_matches_numpy_metrics(teacher):
    """evaluate_model against the JAX package's metrics on the same
    predictions: numpy evaluate_3d per pair and the batched evaluate_3d_jax."""
    _, _, model, _ = teacher
    pairs = synthetic_pairs(2, npoints=N, seed=3)
    got = evaluate_model(model, pairs)
    got = [got[k] for k in ("epe3d", "acc3ds", "acc3dr", "outliers")]
    with torch.no_grad():
        preds = np.stack([model(*(torch.from_numpy(a)[None]
                                  for a in pair[:4]))["flows"][0][0].numpy()
                          for pair in pairs])
    gts = np.stack([pair[4] for pair in pairs])
    want = np.mean([jax_evaluate_3d(p, g) for p, g in zip(preds, gts)],
                   axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    want_jax = np.mean(np.stack([np.asarray(m) for m in
                                 evaluate_3d_jax(preds, gts)], -1), axis=0)
    np.testing.assert_allclose(got, want_jax, rtol=1e-5, atol=1e-6)


def test_evaluate_3d_torch_matches_numpy():
    """The port's batched metrics against the JAX package's numpy
    evaluate_3d per sample and its batched evaluate_3d_jax."""
    pred, gt = _metric_pred_gt(1)
    got = np.stack([t.numpy() for t in evaluate_3d_torch(
        torch.from_numpy(pred), torch.from_numpy(gt))], axis=-1)
    want = np.asarray([jax_evaluate_3d(p, g) for p, g in zip(pred, gt)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    want_jax = np.stack([np.asarray(m) for m in evaluate_3d_jax(pred, gt)],
                        axis=-1)
    np.testing.assert_allclose(got, want_jax, rtol=1e-5, atol=1e-6)
    assert 0 < want[:, 1:].min() and want[:, 1:].max() < 1


@pytest.mark.parametrize("seed", [1, 2])
def test_evaluate_3d_copy_matches_jax(seed):
    """The port's numpy copy of evaluate_3d against the JAX package's."""
    pred, gt = _metric_pred_gt(seed)
    for p, g in zip(pred, gt):
        np.testing.assert_allclose(evaluate_3d(p, g), jax_evaluate_3d(p, g),
                                   rtol=1e-12, atol=0)


def test_synthetic_pairs_are_rigid_motions_with_row_flow():
    pairs = synthetic_pairs(2, npoints=1024, seed=5)
    assert len(pairs) == 2
    for pc1, pc2, n1, n2, flow in pairs:
        assert pc1.shape == pc2.shape == flow.shape == (1024, 3)
        assert pc1.dtype == np.float32
        np.testing.assert_array_equal(flow, pc2 - pc1)
        np.testing.assert_array_equal(n1, pc1)
        np.testing.assert_array_equal(n2, pc2)
    again = synthetic_pairs(2, npoints=1024, seed=5)
    np.testing.assert_array_equal(again[1][0], pairs[1][0])


@pytest.mark.parametrize("name", sorted(JAX_PRESETS))
def test_presets_copied_field_for_field(name):
    assert dataclasses.asdict(PRESETS[name]) == \
        dataclasses.asdict(JAX_PRESETS[name])
    assert dataclasses.asdict(tiny_config(name)) == \
        dataclasses.asdict(jax_tiny_config(name))


def test_config_fields_match_jax():
    from kd_pointcloud_tpu.models.config import ModelConfig as JaxConfig
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(JaxConfig)]


@pytest.mark.parametrize("name", ["teacher", "lighttoken_res", "serving",
                                  "serving_v2", "weight48"])
def test_teacher_wiring_presets_accepted(name):
    check_config(PRESETS[name])


@pytest.mark.parametrize("name", ["fg", "bifeat", "no_cross", "vote",
                                  "non_linear", "student", "student2",
                                  "serving_v3"])
def test_uncovered_presets_raise(name):
    with pytest.raises(NotImplementedError):
        BidPointFlowNet(tiny_config(name), device="cpu")


def test_bridge_covers_every_state_entry(teacher):
    _, _, model, variables = teacher
    state = params_from_jax(variables)
    want = model.state_dict()
    assert set(state) == set(want)
    for k, v in state.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
