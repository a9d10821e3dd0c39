"""The port's paths through the hand-written kernels against the same paths
through the plain versions, on the card (marker ``card``; each skips
without one), at full width and 8192 points.

The eval forward of each preset through evaluate_model (its launches from
the wiring, every flow level and iteration within 1e-3 / median 1e-5 of a
run through the plain versions, the FPS orderings and the feature kNN's
indices equal); one train step of the teacher at batch 3, one KD step at
batch 8 into lighttoken_res and into the halved-width student, the bridge
step, the fast KD step bifeat -> fg and the self-supervised loss's
backward through a student, each against a copy stepped through the plain
versions (loss within 1e-5 relative, every gradient leaf within GRAD_TOL,
BatchNorm statistics within 1e-5, the launches of the step, the frozen
teacher bit-unchanged); a checkpoint round trip; the profile entry's
kernel calls and an operation count equal on the CPU and the card; the
experimental inventory's modules and the pointnet2 API at l1; the cli
entries on seeded trees, raw frames through the preprocessors to the
eval, and the teacher's train step on a data mesh (the drives of
tests/torch_port_checks.py). The eval forward's CUDA graphs and a trace of
one forward's kernels are held in tests/test_torch_port_eval_graph.py.

This file imports no JAX; run every card test on the card with

    python -m pytest --noconftest -p no:cacheprovider -q -m card \\
        tests/test_torch_port_card_kernels.py \\
        tests/test_torch_port_card_paths.py \\
        tests/test_torch_port_eval_graph.py \\
        tests/test_torch_port_knn_features.py
"""

import contextlib
import copy
import dataclasses
import math
import types

import pytest
import torch

from kd_pointcloud_tpu_torch import losses
from kd_pointcloud_tpu_torch.cli import profile as profile_cli
from kd_pointcloud_tpu_torch.eval import (evaluate_model, make_eval_forward,
                                          pairs_loader, synthetic_pairs)
from kd_pointcloud_tpu_torch.models import PRESETS, Bridge, tiny_config
from kd_pointcloud_tpu_torch.nn import ConvGRU
from kd_pointcloud_tpu_torch.nn import cross as cross_nn
from kd_pointcloud_tpu_torch.nn import experimental as ex_nn
from kd_pointcloud_tpu_torch.nn import flowhead as flowhead_nn
from kd_pointcloud_tpu_torch.ops import fps as fps_mod
from kd_pointcloud_tpu_torch.ops import (gather_points, kernels,
                                         square_distance)
from kd_pointcloud_tpu_torch.ops import knn as knn_mod
from kd_pointcloud_tpu_torch.ops import pointnet2_compat as pn2
from kd_pointcloud_tpu_torch.perf import flop_count
from kd_pointcloud_tpu_torch.train import (best_checkpoint, full_state_tree,
                                           make_bridge_distill_step,
                                           make_distill_step,
                                           make_eval_step,
                                           make_named_loss, make_optimizer,
                                           make_train_step,
                                           restore_train_state,
                                           save_checkpoint)
from kd_pointcloud_tpu_torch.train.overfit import synthetic_batches

import torch_port_checks as checks
from torch_port_checks import N_POINTS, SEED
from torch_port_checks import card, kd_batch, pair  # noqa: F401  (fixtures)

FPS_BLOCKS = 8
# the eval forwards: each preset, and the teacher with fps_blocks=8
EVAL_PRESETS = ("teacher", "student", "serving_v3", "student2",
                "non_linear", "bifeat", "fg", "no_cross", "vote",
                "fps_blocks=8")
N_METRIC_PAIRS = 3
STEPS_THAT_FALL = 10
PROFILE_PRESETS = ("teacher", "student", "fg")
# the inventory: the flow heads' neighbours, ConvGRU's hidden width, the
# radii tried for PointnetSAModule's ball
INVENTORY_HEAD_K = 9
INVENTORY_GRU_HIDDEN = 128
INVENTORY_RADII = (1.0, 1.25, 1.5, 2.0, 2.5, 3.0)


@pytest.fixture(scope="module")
def pairs(card):
    return synthetic_pairs(N_METRIC_PAIRS, N_POINTS, seed=SEED)


def _cfg(name):
    if name == f"fps_blocks={FPS_BLOCKS}":
        return dataclasses.replace(PRESETS["teacher"], fps_blocks=FPS_BLOCKS)
    return PRESETS[name]


def _model(name, seed, card):
    return checks.model(_cfg(name), seed, card)


def _site(k, xyz, q):
    return f"k={k} B={q.shape[0]} {q.shape[1]}x{xyz.shape[1]}"


@contextlib.contextmanager
def _feature_calls(store):
    """Record every feature-space kNN of the FG cross layers: (k, keys,
    queries, indices)."""
    entry = cross_nn.knn_features

    def run(k, keys, query):
        idx = entry(k, keys, query)
        store.append((k, keys, query, idx))
        return idx
    cross_nn.knn_features = run
    try:
        yield
    finally:
        cross_nn.knn_features = entry


def _hold_flows(model, pair):
    """Eval flows through the kernels against the same model on the plain
    versions, every level and iteration: max abs <= 1e-3, median <= 1e-5;
    FPS orderings equal; the feature-space kNN's indices equal at each of
    its sites. Returns the kernel run's feature kNN sites."""
    f_k, f_p = [], []
    with torch.inference_mode():
        with _feature_calls(f_k):
            out_k = model(*pair)
        with checks.plain_kernels(), _feature_calls(f_p):
            out_p = model(*pair)
    for lvl in range(4):
        fks, fps_ = out_k["flows"][lvl], out_p["flows"][lvl]
        if model.cfg.iters > 1 and lvl < 3:
            assert len(fks) == len(fps_) == model.cfg.iters
        else:
            fks, fps_ = [fks], [fps_]
        for it, (fk, fp) in enumerate(zip(fks, fps_)):
            assert tuple(fk.shape) == (1, model.cfg.npoints[lvl], 3)
            assert bool(torch.isfinite(fk).all()), (lvl, it)
            diff = (fk - fp).abs()
            mx, med = float(diff.max()), float(diff.median())
            assert mx <= 1e-3 and med <= 1e-5, (lvl, it, mx, med)
    for key in ("fps_idx1", "fps_idx2"):
        assert all(torch.equal(a, b) for a, b in zip(out_k[key], out_p[key]))
    assert len(f_k) == len(f_p)
    assert all(torch.equal(a[3], b[3]) for a, b in zip(f_k, f_p))
    return f_k


# ------------------------------------------------------------ eval forwards

@pytest.mark.card
@pytest.mark.parametrize("name", EVAL_PRESETS)
def test_eval_forward(name, card, pairs, pair):
    """evaluate_model over N_METRIC_PAIRS pairs (the teacher) or one: the
    launches a forward from the wiring (the student's C = 16 pools by
    width), finite metrics; the kNN sites of a student preset the
    teacher's (serving_v3's l0 warp search of 8192 x 8192 replaced by one
    of 2048 x 2048); fg's feature kNN once a level; fps_blocks=8's one
    FPS call over 16 blocks; the flows against the plain versions."""
    cfg = _cfg(name)
    model = _model(name, SEED, card)
    n = N_METRIC_PAIRS if name == "teacher" else 1
    kernels.reset_launches()
    metrics = evaluate_model(model, pairs_loader(pairs[:n]), with_2d=False)
    torch.cuda.synchronize()
    want = checks.forward_launches(cfg)
    assert kernels.LAUNCHES == {k: v * n for k, v in want.items()}
    assert kernels.WIDTH_LAUNCHES.get("pool C=16", 0) == n * (
        3 if cfg.level_channels[0] == 16 else 0)
    assert all(math.isfinite(v) and abs(v) < 1e6 for v in metrics.values())
    sites = checks.empty_sites()
    with checks.recording(sites), torch.inference_mode():
        model.eval()(*pair)
    if want == checks.PER_FORWARD:
        teacher_sites = checks.empty_sites()
        with checks.recording(teacher_sites), torch.inference_mode():
            _model("teacher", SEED, card).eval()(*pair)
        want_knn = sorted(_site(*a) for a in teacher_sites["knn"])
        if cfg.coarse_warp:
            warp0 = f"k=3 B=1 {N_POINTS}x{N_POINTS}"
            n1 = cfg.npoints[1]
            want_knn.remove(warp0)
            want_knn = sorted(want_knn + [f"k=3 B=1 {n1}x{n1}"])
        assert sorted(_site(*a) for a in sites["knn"]) == want_knn
    if cfg.fps_blocks > 1:
        assert [tuple(a[0].shape) + (a[1],) for a in sites["fps"]] == [
            (2 * FPS_BLOCKS, N_POINTS // FPS_BLOCKS, 3,
             cfg.npoints[1] // FPS_BLOCKS)]
    feature_sites = _hold_flows(model, pair)
    assert len(feature_sites) == want["knn_features"]


# ------------------------------------------------------------------ steps

def _hold_step(step_k, step_p, batch, model_k, model_p, want):
    """One step through the kernels and one of a copy through the plain
    versions on the same batch: the kernel step's launches (returned with
    its launches by width), the plain step's none, the loss within 1e-5
    relative, every gradient leaf within GRAD_TOL, BatchNorm statistics
    within 1e-5; then the kernel step's loss falls over STEPS_THAT_FALL
    more steps."""
    kernels.reset_launches()
    loss_k = float(step_k(batch))
    launches = dict(kernels.LAUNCHES)
    widths = dict(kernels.WIDTH_LAUNCHES)
    assert launches == want
    with checks.plain_kernels():
        loss_p = float(step_p(batch))
    assert kernels.LAUNCHES == launches
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), (loss_k, loss_p)
    checks.compare_grads(model_k, model_p)
    assert checks.compare_stats(model_k, model_p) <= 1e-5
    # more steps on the same batch: the loss falls (a sanity check, not a
    # convergence claim)
    losses_k = [float(step_k(batch)) for _ in range(STEPS_THAT_FALL)]
    assert losses_k[-1] < losses_k[0], losses_k
    return widths


def _frozen(teacher):
    """A check that the frozen teacher did not move: its state as it is
    now, eval mode, no gradients."""
    state = {k: v.clone() for k, v in teacher.state_dict().items()}

    def unchanged():
        assert all(torch.equal(v, state[k])
                   for k, v in teacher.state_dict().items())
        assert not teacher.training
        assert all(p.grad is None for p in teacher.parameters())
    return unchanged


@pytest.mark.card
def test_train_step(card):
    model = _model("teacher", SEED, card)
    plain = copy.deepcopy(model)
    batch = synthetic_batches(1, checks.TRAIN_BATCH, N_POINTS, SEED + 1,
                              "cuda")[0]
    _hold_step(make_train_step(model, make_optimizer(model)),
               make_train_step(plain, make_optimizer(plain)), batch, model,
               plain, checks.PER_TRAIN_STEP)


@pytest.mark.card
@pytest.mark.parametrize("student", ["lighttoken_res", "student"])
def test_kd_step(student, card, kd_batch):
    """Teacher (seed 1) -> lighttoken_res (seed 0) by biDirection_loss_ht,
    or -> the halved-width student by biDirectionLoss; the student's l0
    pools run the C = 16 instances, forward and backward."""
    path = "kd" if student == "lighttoken_res" else "student_kd"
    teacher = _model("teacher", checks.TEACHER_SEED, card)
    model = _model(student, checks.STUDENT_SEED, card)
    plain = copy.deepcopy(model)
    unchanged = _frozen(teacher.eval())
    steps = [checks.kd_step(path, teacher, m) for m in (model, plain)]
    widths = _hold_step(*steps, kd_batch, model, plain, checks.PER_KD_STEP)
    if student == "student":
        assert {k: widths.get(k, 0) for k in checks.STUDENT_C16} == \
            checks.STUDENT_C16
    for kernel in ("pool", "pool_bwd"):
        assert sum(n for k, n in widths.items()
                   if k.startswith(f"{kernel} C=")) == \
            checks.PER_KD_STEP[kernel]
    unchanged()


@pytest.mark.card
def test_bridge_step(card, kd_batch):
    """A 512-channel Bridge on the teacher's layer-3 features, its own
    Adam: student and bridge gradients within GRAD_TOL, every bridge
    tensor moved."""
    teacher = _model("teacher", checks.TEACHER_SEED, card)
    unchanged = _frozen(teacher.eval())
    students = [_model("lighttoken_res", checks.STUDENT_SEED, card)
                for _ in range(2)]
    layer = checks.KD_ARGS["hint_layers"][-1]
    width = PRESETS["teacher"].lift_channels[layer]
    bridges = [Bridge(width, 512, device=card,
                      generator=torch.Generator().manual_seed(SEED + 4))
               for _ in range(2)]
    before = {k: v.clone() for k, v in bridges[0].state_dict().items()}
    steps = [make_bridge_distill_step(
        teacher, s, br, make_optimizer(s, 1e-3, 1e-4),
        make_optimizer(br, 1e-3, 1e-4), gamma=checks.KD_ARGS["gamma"],
        beta=checks.KD_ARGS["beta"], layer=layer)
        for s, br in zip(students, bridges)]
    kernels.reset_launches()
    loss_k = float(steps[0](kd_batch))
    assert kernels.LAUNCHES == checks.PER_KD_STEP
    with checks.plain_kernels():
        loss_p = float(steps[1](kd_batch))
    assert kernels.LAUNCHES == checks.PER_KD_STEP
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    checks.compare_grads(*bridges)
    checks.compare_grads(*students)
    assert all(not torch.equal(v, before[k])
               for k, v in bridges[0].state_dict().items())
    unchanged()


@pytest.mark.card
def test_fast_kd_step(card, kd_batch):
    """make_fast_distill_step, frozen bifeat (seed 1) -> fg (seed 0),
    att_iter_loss (gamma 0.6, layers [1, 2])."""
    teacher = _model(checks.FAST_TEACHER, checks.TEACHER_SEED, card)
    model = _model(checks.FAST_STUDENT, checks.STUDENT_SEED, card)
    plain = copy.deepcopy(model)
    unchanged = _frozen(teacher.eval())
    steps = [checks.kd_step("fast_kd", teacher, m) for m in (model, plain)]
    _hold_step(*steps, kd_batch, model, plain, checks.distill_launches(
        PRESETS[checks.FAST_TEACHER], PRESETS[checks.FAST_STUDENT]))
    unchanged()


@pytest.mark.card
def test_selfsup_backward(card):
    """The self-supervised loss (multi_scale_chamfer_smooth_curvature) and
    its backward through a student train forward at batch 2: each of its
    four terms within 1e-5 relative."""
    batch = synthetic_batches(1, checks.SELFSUP_BATCH, N_POINTS, SEED + 5,
                              "cuda")[0]
    model = _model("student", checks.STUDENT_SEED, card)
    plain = copy.deepcopy(model)

    def backward(m):
        m.train()
        m.zero_grad(set_to_none=True)
        out = m(batch["pos1"], batch["pos2"], batch["norm1"],
                batch["norm2"])
        parts = losses.multi_scale_chamfer_smooth_curvature(
            out["pc1"], out["pc2"], out["flows"])
        parts[0].backward()
        return [float(v.detach()) for v in parts]

    kernels.reset_launches()
    got = backward(model)
    assert kernels.LAUNCHES == checks.PER_SELFSUP_STEP
    with checks.plain_kernels():
        want = backward(plain)
    assert kernels.LAUNCHES == checks.PER_SELFSUP_STEP
    for a, b in zip(got, want, strict=True):
        assert abs(a - b) <= 1e-5 * abs(b), (got, want)
    checks.compare_grads(model, plain)
    assert checks.compare_stats(model, plain) <= 1e-5


@pytest.mark.card
def test_checkpoint_round_trip(card, kd_batch, pair, tmp_path):
    """A distilled student saved with its optimizer, restored into a fresh
    model and optimizer: state, Adam's step count and the eval flows
    bit-equal."""
    teacher = _model("teacher", checks.TEACHER_SEED, card)
    student = _model("lighttoken_res", checks.STUDENT_SEED, card)
    opt = make_optimizer(student, 1e-3, 1e-4)
    make_distill_step(teacher, student, opt, loss_fn=make_named_loss(
        checks.KD_LOSS, checks.KD_ARGS))(kd_batch)
    epe = float(make_eval_step(student)(kd_batch)[0].mean())
    path = save_checkpoint(str(tmp_path), "S", 1, epe,
                           full_state_tree(student, opt, 1, epe))
    fresh = _model("lighttoken_res", SEED + 5, card)
    fresh_opt = make_optimizer(fresh, 1e-3, 1e-4)
    epoch, _, _ = restore_train_state(path, fresh, fresh_opt)
    assert epoch == 1 and best_checkpoint(str(tmp_path)) == path
    assert all(torch.equal(v, fresh.state_dict()[k])
               for k, v in student.state_dict().items())
    assert (fresh_opt.state_dict()["state"][0]["step"]
            == opt.state_dict()["state"][0]["step"])
    with torch.inference_mode():
        a = student.eval()(*pair)["flows"]
        b = fresh.eval()(*pair)["flows"]
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------- tooling

@pytest.mark.card
def test_profile_entry(card):
    """cli.profile for teacher, student and fg: each forward's kernel
    calls those of its wiring."""
    for name, st in profile_cli.main(list(PROFILE_PRESETS)).items():
        want = checks.forward_launches(PRESETS[name])
        assert {n: v["calls"] for n, v in st["by_kernel"].items()} == {
            n: c for n, c in want.items() if c}, name


@pytest.mark.card
def test_operation_count_on_cpu_and_card(card):
    """The operations of a tiny_config teacher forward (flop_count): the
    same on the CPU and the card."""
    tiny = checks.model(tiny_config("teacher"), SEED, "cpu")
    inputs = [torch.from_numpy(a)[None]
              for a in synthetic_pairs(1, 256, seed=SEED)[0][:4]]
    on_cpu = flop_count(make_eval_forward(tiny), *inputs)
    on_card = flop_count(make_eval_forward(copy.deepcopy(tiny).to(card)),
                         *(a.to(card) for a in inputs))
    assert on_cpu == on_card


# -------------------------------------------------------------- inventory

# every module of nn/experimental.py, the ConvGRU, the two inventory flow
# heads and the pointnet2 API at the teacher's widths, batch 1: l1 (2048
# points a cloud, C = 64; feat_nei 16 for the PointConv kind, flow_nei 32
# for the cross layers, so CrossLocalTransLayer searches k = 64 over 2048
# keys and CrossTransLayer attends 2048 x 2048) and the down-samplers from
# l0 (8192 -> 2048, C = 32). Each entry: (label, make(inputs, generator)
# -> (module, args)).
_HEADS = ("SceneFlowEstimatorSepResidual", "SceneFlowEstimatorResidualBias",
          "SceneFlowEstimatorResidualSVD",
          "SceneFlowEstimatorSetconvResidual",
          "SceneFlowEstimatorResidualFactor",
          "SceneFlowEstimatorSetconvFuseResidual")
INVENTORY = [
    # the PointConv variants and down-samplers
    ("PointConvSVD", lambda i, g: (ex_nn.PointConvSVD(
        i.fn, i.c1, i.c1, generator=g), (i.xyz1, i.f1))),
    ("PointConvBias", lambda i, g: (ex_nn.PointConvBias(
        i.fn, i.c1, i.c1, generator=g), (i.xyz1, i.f1))),
    ("PointConvFactor", lambda i, g: (ex_nn.PointConvFactor(
        i.fn, i.c1, i.c1, generator=g), (i.xyz1, i.f1))),
    ("PointConvK", lambda i, g: (ex_nn.PointConvK(i.fn, i.c1, i.c1, g),
                                 (i.xyz1, i.f1))),
    ("SepConv", lambda i, g: (ex_nn.SepConv(i.fn, i.c1, i.c1, g),
                              (i.xyz1, i.f1))),
    # 3 + C must be whole 3-vectors: the first 30 of the 32 channels
    ("VNNConvD", lambda i, g: (ex_nn.VNNConvD(i.n1, i.fn, 30, i.c1 // 3, g),
                               (i.xyz0, i.f0[..., :30].contiguous()))),
    ("SetAbstract", lambda i, g: (ex_nn.SetAbstract(
        i.fn, i.c1, (i.c1, i.c1), g), (i.xyz1, i.f1))),
    ("SetAbstractD", lambda i, g: (ex_nn.SetAbstractD(
        i.n1, i.fn, i.c0, (i.c1, i.c1), g), (i.xyz0, i.f0))),
    ("SetAbstractFuse", lambda i, g: (ex_nn.SetAbstractFuse(
        i.fn, i.c1, (i.c1, i.c1), (i.c1,), g), (i.xyz1, i.f1))),
    ("SetAbstractFuseD", lambda i, g: (ex_nn.SetAbstractFuseD(
        i.n1, i.fn, i.c0, (i.c1, i.c1), (i.c1,), g), (i.xyz0, i.f0))),
    ("PointConvW", lambda i, g: (ex_nn.PointConvW(
        i.n1, i.fn, i.c0, i.c1, g), (i.xyz0, i.f0))),
    ("PointConvSVDD", lambda i, g: (ex_nn.PointConvSVDD(
        i.n1, i.fn, i.c0, i.c1, generator=g), (i.xyz0, i.f0))),
    ("PointConvWeight", lambda i, g: (ex_nn.PointConvWeight(
        i.n1, i.fn, i.c0, i.c1, generator=g), (i.xyz0, i.f0))),
    ("PointConvDS", lambda i, g: (ex_nn.PointConvDS(
        i.n1, i.fn, i.c0, i.c1, generator=g), (i.xyz0b, i.xyz0, i.f0))),
    ("AdaptiveSampling", lambda i, g: (ex_nn.AdaptiveSampling(i.xn),
                                       (i.xyz1, i.f1, i.xyz1b, i.f1b))),
    ("PointConv4D", lambda i, g: (ex_nn.PointConv4D(
        i.fn, i.c1, i.c1, generator=g), (i.xyz1b, i.xyz1, i.f1))),
    ("LocalFeatureAggregation", lambda i, g: (
        ex_nn.LocalFeatureAggregation(i.fn, i.c1, i.c1, g), (i.xyz1, i.f1))),
    # the cross layers
    ("PointConvFlow", lambda i, g: (ex_nn.PointConvFlow(
        i.xn, i.c1, (i.c1, i.c1), g), i.pair1)),
    ("CrossLayerConcat", lambda i, g: (ex_nn.CrossLayerConcat(
        i.xn, i.c1, (i.c1, i.c1), (i.c1, i.c1), g), i.pair1)),
    ("CrossConvLayer", lambda i, g: (ex_nn.CrossConvLayer(
        i.xn, i.c1, i.c1, i.c1, generator=g), i.pair1)),
    ("FlowEmbeddingLayer", lambda i, g: (ex_nn.FlowEmbeddingLayer(
        i.xn, i.c1, (i.c1,), g), i.pair1)),
    ("CrossLayerLightUp", lambda i, g: (ex_nn.CrossLayerLightUp(
        i.xn, i.c0, i.c1, (i.c1, i.c1), g), (i.xyz0, i.xyz1b, i.f0, i.f1b))),
    ("CrossTransLayer", lambda i, g: (ex_nn.CrossTransLayer(
        i.xn, i.c1, (i.c1,), (i.c1,), g), i.pair1)),
    ("CrossLocalTransLayer", lambda i, g: (ex_nn.CrossLocalTransLayer(
        i.xn, i.c1, (i.c1,), (i.c1,), g), i.pair1)),
    ("CrossLayerPoolLight", lambda i, g: (ex_nn.CrossLayerPoolLight(
        i.xn, i.c1, (i.c1,), (i.c1,), g), i.pair1)),
    ("CrossLayerLightVoteDouble", lambda i, g: (
        ex_nn.CrossLayerLightVoteDouble(i.xn, i.c1, (i.c1, i.c1),
                                        (i.c1, i.c1), dense_channel=i.c0,
                                        generator=g),
        (*i.pair1, i.xyz0b, i.f0b))),
    ("CrossLayerLightVote1", lambda i, g: (ex_nn.CrossLayerLightVote1(
        i.xn, i.c1, (i.c1, i.c1), (i.c1, i.c1), g), i.pair1)),
    ("CrossLayerLightVote2", lambda i, g: (ex_nn.CrossLayerLightVote2(
        i.xn, i.c1, (i.c1, i.c1), (i.c1, i.c1), g), i.pair1)),
    ("NoCrossLayer", lambda i, g: (ex_nn.NoCrossLayer(
        i.xn, i.c1, (i.c1, i.c1), True, g), i.pair1)),
    ("CrossAtten", lambda i, g: (ex_nn.CrossAtten(i.c1, i.c1, g), i.pair1)),
    ("CrossLayerLightOcc", lambda i, g: (ex_nn.CrossLayerLightOcc(
        i.xn, i.c1, (i.c1, i.c1), (i.c1, i.c1), g), i.pair1)),
    ("CrossLayerLightAttentive", lambda i, g: (
        ex_nn.CrossLayerLightAttentive(i.xn, i.c1, (i.c1, i.c1),
                                       (i.c1, i.c1), g), i.pair1)),
    ("CrossLayerP2PConvLight2", lambda i, g: (
        ex_nn.CrossLayerP2PConvLight2(i.xn, i.c1, (i.c1, i.c1),
                                      (i.c1, i.c1), g), i.pair1)),
    ("CrossLayerLightShift", lambda i, g: (ex_nn.CrossLayerLightShift(
        i.xn, i.c1, (i.c1, i.c1), (i.c1, i.c1), g), i.pair1)),
    # the estimators
    *((name, lambda i, g, name=name: (getattr(ex_nn, name)(
        i.c1, i.c1, generator=g, neighbors=INVENTORY_HEAD_K),
        (i.xyz1, i.f1, i.cost1, i.flow1))) for name in _HEADS),
    ("SceneFlowEstimatorResidualSmooth", lambda i, g: (
        ex_nn.SceneFlowEstimatorResidualSmooth(
            i.c1, i.c1, i.c1, generator=g, neighbors=INVENTORY_HEAD_K),
        (i.xyz1, i.f1, i.bid1, i.cost1, i.flow1))),
    ("SceneFlowEstimatorResidualOcc", lambda i, g: (
        ex_nn.SceneFlowEstimatorResidualOcc(
            i.c1, i.c1, 1, generator=g, neighbors=INVENTORY_HEAD_K),
        (i.xyz1, i.f1, i.cost1, i.flow1, i.occ1))),
    ("SceneFlowEstimatorPointConv", lambda i, g: (
        flowhead_nn.SceneFlowEstimatorPointConv(
            i.c1, i.c1, 3, generator=g, neighbors=INVENTORY_HEAD_K),
        (i.xyz1, i.f1, i.cost1, i.flow1))),
    ("SceneFlowEstimatorResidualIter", lambda i, g: (
        flowhead_nn.SceneFlowEstimatorResidualIter(
            i.c1, i.c1, generator=g, neighbors=INVENTORY_HEAD_K),
        (i.xyz1, i.f1, i.cost1, i.flow1))),
    ("ConvGRU", lambda i, g: (ConvGRU(2 * i.c1, INVENTORY_GRU_HIDDEN, g),
                              (i.h1, torch.cat([i.f1, i.cost1], dim=-1)))),
    # the warp
    ("PointWarpingSimple", lambda i, g: (ex_nn.PointWarpingSimple(),
                                         (i.xyz1, i.xyz1b, i.flow1))),
    # the pointnet2 API
    ("PointnetSAModule", lambda i, g: (pn2.PointnetSAModule(
        i.n1, i.radius, i.fn, i.c0, (i.c1, i.c1), generator=g),
        (i.xyz0, i.f0))),
    ("PointnetFPModule", lambda i, g: (pn2.PointnetFPModule(
        i.c1 + i.c0, (i.c1,), g), (i.xyz0, i.xyz1, i.f0, i.f1))),
]


@pytest.fixture(scope="module")
def inventory_inputs(card, pair):
    """Seeded features at l0 and l1, the l1 clouds by the FPS kernel from
    the eval pair, and PointnetSAModule's radius: the smallest of
    INVENTORY_RADII at which the median ball around the l1 centres holds
    nsample / 2 points."""
    cfg = PRESETS["teacher"]
    i = types.SimpleNamespace(n0=cfg.npoints[0], n1=cfg.npoints[1],
                              c0=cfg.level_channels[0],
                              c1=cfg.level_channels[1], fn=cfg.feat_nei,
                              xn=cfg.flow_nei)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    i.xyz0, i.xyz0b = pair[0], pair[1]
    with torch.inference_mode():
        l1 = [gather_points(p, fps_mod.furthest_point_sample(p, i.n1))
              for p in pair[:2]]
    i.xyz1, i.xyz1b = (p.clone() for p in l1)
    i.f0, i.f0b = randn(1, i.n0, i.c0), randn(1, i.n0, i.c0)
    i.f1, i.f1b, i.cost1, i.bid1 = (randn(1, i.n1, i.c1) for _ in range(4))
    i.flow1, i.occ1 = 0.1 * randn(1, i.n1, 3), randn(1, i.n1, 1)
    i.h1 = randn(1, i.n1, INVENTORY_GRU_HIDDEN)
    i.pair1 = (i.xyz1, i.xyz1b, i.f1, i.f1b)
    with torch.no_grad():
        d2 = square_distance(i.xyz1, i.xyz0)
        for radius in INVENTORY_RADII:
            hits = float((d2 < radius * radius).sum(-1).clamp(max=i.fn)
                         .float().median())
            if hits >= i.fn / 2:
                break
    assert hits >= i.fn / 2
    i.radius = radius
    return i


@pytest.fixture(scope="module")
def inventory(card, inventory_inputs):
    """Each module once through the kernels, its kernel calls recorded and
    its launches counted from just before to just after: {label: (a copy
    of the module, args, outputs, launches, sites)}."""
    rows = {}
    for label, make in INVENTORY:
        mod, args = make(inventory_inputs,
                         torch.Generator().manual_seed(SEED))
        if isinstance(mod, torch.nn.Module):
            mod = mod.to(card).eval()
        twin = copy.deepcopy(mod)
        sites = checks.empty_sites()
        before = dict(kernels.LAUNCHES)
        with checks.recording(sites), torch.no_grad():
            out = mod(*args)
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in kernels.LAUNCHES.items()}
        rows[label] = (twin, args, out, launched, sites)
    return rows


def _distinct(calls):
    """The distinct sites (shapes and k) of calls."""
    seen = {}
    for args in calls:
        seen.setdefault(tuple(tuple(a.shape) if torch.is_tensor(a) else a
                              for a in args), args)
    return list(seen.values())


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.card
@pytest.mark.parametrize("label", [c[0] for c in INVENTORY])
def test_inventory_module(label, inventory):
    """The module through the kernels against its copy through the plain
    versions: outputs within max abs 1e-3 / median 1e-5, indices equal;
    every launch one of its recorded FPS and kNN calls, none of the pool;
    FPS and kNN bit-identical at each distinct site."""
    twin, args, out_k, launched, sites = inventory[label]
    assert launched["fps"] == len(sites["fps"])
    assert launched["knn"] == len(sites["knn"])
    assert not launched["pool"] and not launched["pool_bwd"]
    with checks.plain_kernels(), torch.no_grad():
        out_p = twin(*args)
    for a, b in zip(_flat(out_k), _flat(out_p), strict=True):
        assert a.shape == b.shape and bool(torch.isfinite(a.float()).all())
        if a.is_floating_point():
            diff = (a - b).abs()
            assert float(diff.max()) <= 1e-3, float(diff.max())
            assert float(diff.median()) <= 1e-5, float(diff.median())
        else:
            assert torch.equal(a, b)
    for xyz, m in _distinct(sites["fps"]):
        checks.hold_fps(xyz, m)
    for args_ in _distinct(sites["knn"]):
        checks.hold_knn(*args_)


@pytest.mark.card
def test_inventory_reaches_fps_and_knn(inventory):
    """Over the inventory: FPS and kNN launch, the pool does not, and one
    distinct site searches k = 64 (CrossLocalTransLayer)."""
    total = {n: sum(r[3][n] for r in inventory.values())
             for n in kernels.LAUNCHES}
    assert total["fps"] > 0 and total["knn"] > 0
    assert not total["pool"] and not total["pool_bwd"]
    knn_sites = _distinct([a for r in inventory.values()
                           for a in r[4]["knn"]])
    assert [a[0] for a in knn_sites].count(knn_mod.MAX_K) == 1


# ---------------------------------------------------------- end to end

@pytest.mark.card
def test_workflow(card):
    """The cli entries on seeded trees (checks.workflow): every eval run
    launches the forward's kernels a forward, every train and KD run each
    path kernel."""
    runs = checks.workflow("cuda")["runs"]
    kitti = len(checks.WORKFLOW_KITTI["mapped"])
    ft3d_val = -(-checks.WORKFLOW_FT3D["val"] // 3)
    forwards = {"evaluate": kitti, "eval KITTI device": kitti,
                "eval KITTI host": kitti, "eval FT3D val device": ft3d_val,
                "eval FT3D val host": ft3d_val}
    for label, n in forwards.items():
        assert runs[label]["launches"] == {
            k: v * n for k, v in checks.PER_FORWARD.items()}, label
    for label in ("train", "resume", "distill", "distill_bridge",
                  "fast_distill"):
        assert all(runs[label]["launches"][k] for k in checks.PATH_KERNELS)


@pytest.mark.card
def test_preprocess_to_eval(card):
    """Raw FT3D (540 x 960) and KITTI (375 x 1242) frames through the
    preprocessors to evaluate_model (checks.preprocess_eval): the
    forward's kernels a scene."""
    pre = checks.preprocess_eval("cuda")
    for label, scenes in pre["scenes"].items():
        assert pre["launches"][label] == {
            k: v * len(scenes) for k, v in checks.PER_FORWARD.items()}


@pytest.mark.card
def test_mesh(card, tmp_path):
    """The teacher's train step on a data mesh (checks.mesh_phase): an
    NCCL world of one rank here, a gloo world of two ranks on the card;
    each step launches the train step's kernels."""
    out = checks.mesh_phase(str(tmp_path), PRESETS["teacher"])
    assert out["launches"] == checks.PER_TRAIN_STEP
    assert out["rank_launches"] == [checks.PER_TRAIN_STEP] * checks.MESH_RANKS
