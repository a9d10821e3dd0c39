"""Shared checks of the port's kernels and paths, for the card tests
(tests/test_torch_port_card_*.py, and chip_smoke.py, which runs them),
and their CPU rehearsals (tests/test_torch_port_guards.py).

The card gate and the seeded inputs every card file shares (the fixtures
card, pair and kd_batch, imported by name into each file), the seeded
models and KD steps, the launch counts each path makes, the entry points
where a model reaches each kernel (swapped for a recorder or for the plain
version), the crafted pool inputs (ties, the FG union, a ragged grid), the
gates that hold a step through the kernels against the same step through
the plain versions, and three end-to-end drives that run on either
device: the cli entries on seeded trees (workflow), raw frames through the
preprocessors to the eval (preprocess_eval) and the teacher's train step
on a data mesh (mesh_phase).
This module imports torch and the port only, never JAX, so the card tests
run with ``--noconftest``.
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import math
import shutil
import tempfile
from pathlib import Path

import pytest
import torch

from kd_pointcloud_tpu_torch.device import use_full_fp32
from kd_pointcloud_tpu_torch.eval import synthetic_pairs
from kd_pointcloud_tpu_torch.models import PRESETS, BidPointFlowNet
from kd_pointcloud_tpu_torch.ops import fps as fps_mod
from kd_pointcloud_tpu_torch.ops import knn as knn_mod
from kd_pointcloud_tpu_torch.ops import pool_fused as pool_mod
from kd_pointcloud_tpu_torch.train import (make_distill_step,
                                           make_fast_distill_step,
                                           make_named_loss, make_optimizer)
from kd_pointcloud_tpu_torch.train.overfit import synthetic_batches

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
N_POINTS = 8192
TRAIN_BATCH = 3
# configs/distill_kd.yaml: batch 8, biDirection_loss_ht, gamma 0.3, beta
# 0.8, hint layers [2, 3], Adam lr 1e-3, weight decay 1e-4
KD_BATCH = 8
KD_LOSS = "biDirection_loss_ht"
KD_ARGS = dict(gamma=0.3, beta=0.8, hint_layers=[2, 3])
TEACHER_SEED, STUDENT_SEED = 1, 0
# the halved-width student: its features are half the teacher's width, so
# the hint losses do not apply; biDirectionLoss is flow-only
STUDENT_LOSS = "biDirectionLoss"
STUDENT_LOSS_ARGS = dict(gamma=0.3, gamma2=0.3, beta=0.8)
# configs/fast_distill.yaml: bifeat -> fg, att_iter_loss gamma 0.6, layers
# [1, 2]
FAST_TEACHER, FAST_STUDENT = "bifeat", "fg"
FAST_KD_ARGS = dict(gamma=0.6, layers=(1, 2))
# each KD path: (frozen teacher, student)
KD_PATHS = {"kd": ("teacher", "lighttoken_res"),
            "student_kd": ("teacher", "student"),
            "fast_kd": (FAST_TEACHER, FAST_STUDENT)}
SELFSUP_BATCH = 2
SELFSUP_KNN = 16            # 4 searches a level (k = 10, 10, 9, 5) x 4
# the workflow's seeded trees: FT3D-subset scenes (batch 3 x 2 train steps,
# batch 8 x 2 KD steps; a padded last val batch at 3) and KITTI's 3 mapped
# scenes, rows a scene before sampling to N_POINTS
WORKFLOW_FT3D = dict(train=16, val=4, points=10240)
WORKFLOW_KITTI = dict(mapped=(0, 1, 5), points=20480)
WORKFLOW_STEPS = 2
# raw frames at the datasets' sizes (FT3D 540 x 960, KITTI 375 x 1242)
RAW_FT3D = dict(train=1, val=2, height=540, width=960)
RAW_KITTI = dict(frames=(0, 1, 2), height=375, width=1242)
# the mesh: a gloo world of MESH_RANKS ranks at a global batch of
# MESH_BATCH; every collective and join fails after MESH_TIMEOUT_S
MESH_RANKS, MESH_BATCH = 2, 4
MESH_TIMEOUT_S = 120
# device against host eval path: the same forward, metrics in torch on the
# card against numpy on the host (float32 sums in another order)
EVAL_PATHS_RTOL = 1e-5
# x max|plain|: float32 sums in another order (the pool, the cross pool)
POOL_TOL = 1e-4
# the backward kernel adds d_u, d_weight and d_bias with float atomics, in
# an order that changes from run to run: float32 rounding of sums over up
# to B * N1 * K = 786432 rows, not bit-equality
POOL_BWD_TOL = 1e-4
# a step through the kernels against the plain versions: the same math,
# but those atomic sums in another order, carried through the whole
# backward; per leaf, relative to the leaf's max |plain gradient|
GRAD_TOL = 1e-3

PER_FORWARD = {"fps": 1, "knn": 19, "pool": 12, "pool_bwd": 0,
               "fps_pruned": 0, "cross_pool": 0, "knn_features": 0}
PER_TRAIN_STEP = dict(PER_FORWARD, pool_bwd=12)
# the frozen teacher's forward adds no backward
PER_KD_STEP = {"fps": 2, "knn": 38, "pool": 24, "pool_bwd": 12,
               "fps_pruned": 0, "cross_pool": 0, "knn_features": 0}
# a student forward in train mode, the self-supervised loss on its four
# levels and the backward
PER_SELFSUP_STEP = dict(PER_TRAIN_STEP, knn=PER_FORWARD["knn"] + SELFSUP_KNN)
# launches by width of a student KD step at C = 16: the forward and the
# backward of the l0 cross layer's three pools (every other site is wider)
STUDENT_C16 = {"pool C=16": 3, "pool_bwd C=16": 3}
PATH_KERNELS = ("fps", "knn", "pool", "pool_bwd")

# where the model reaches each kernel: (module, attribute, plain version);
# the pool's entry carries its backward kernel too
ENTRIES = {"fps": (fps_mod, "_fps_cuda", fps_mod.fps_plain),
           "knn": (knn_mod, "_knn_card", knn_mod.knn_plain),
           "pool": (pool_mod, "_pool_card", pool_mod.pool_plain),
           "knn_features": (knn_mod, "_knn_features_cuda",
                            knn_mod.knn_features_plain)}


@pytest.fixture(scope="module")
def card():
    """The CUDA card, float32 products in full float32 (no TF32); the test
    skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    use_full_fp32()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def pair(card):
    """The eval forward's inputs on the card: the first seeded pair
    (synthetic_pairs, seed SEED) at batch 1."""
    return [torch.from_numpy(a)[None].to(card)
            for a in synthetic_pairs(1, N_POINTS, seed=SEED)[0][:4]]


@pytest.fixture(scope="module")
def kd_batch(card):
    """The KD steps' batch on the card: KD_BATCH seeded pairs."""
    return synthetic_batches(1, KD_BATCH, N_POINTS, SEED + 2, "cuda")[0]


def model(cfg, seed: int, device) -> BidPointFlowNet:
    """A model of cfg (a ModelConfig or a preset's name), its weights drawn
    from seed."""
    cfg = PRESETS[cfg] if isinstance(cfg, str) else cfg
    return BidPointFlowNet(cfg, device=device,
                           generator=torch.Generator().manual_seed(seed))


def kd_step(path: str, teacher, student):
    """The step of KD path (KD_PATHS) from the frozen teacher into
    student, Adam lr 1e-3, weight decay 1e-4: biDirection_loss_ht
    (configs/distill_kd.yaml), biDirectionLoss into the halved-width
    student, or make_fast_distill_step's att_iter_loss
    (configs/fast_distill.yaml)."""
    opt = make_optimizer(student, 1e-3, 1e-4)
    if path == "fast_kd":
        return make_fast_distill_step(teacher, student, opt, **FAST_KD_ARGS)
    loss, args = ((STUDENT_LOSS, STUDENT_LOSS_ARGS) if path == "student_kd"
                  else (KD_LOSS, KD_ARGS))
    return make_distill_step(teacher, student, opt,
                             loss_fn=make_named_loss(loss, args))


def forward_launches(cfg) -> dict:
    """Kernel launches of one forward of cfg, from its wiring. FPS once
    (l1; l2-l4 slice its ordering). kNN: the encoder's groupings (l1-l4,
    and l0's PointConv with encoder="pointconv"), the l4 -> l3 and three
    decoder 3-NN, and per cross-layer call (l3 once, l2-l0 iters times)
    its 3-D search (both directions stacked; the FG layer's Euclidean
    half; no_cross's one direction) and the flow head's self-kNN, and per
    l2-l0 call one warp search (a coarse warp searches one level up
    instead). Pool: 3 a cross-layer call, 2 for vote (its last round is
    plain), 1 for no_cross. The feature kNN once a level (cross="fg")."""
    calls = 1 + 3 * cfg.iters
    encoder = 4 + (cfg.encoder == "pointconv")
    pools = {"light": 3, "fg": 3, "vote": 2, "nocross": 1}[cfg.cross]
    return {"fps": 1, "knn": encoder + 4 + 2 * calls + 3 * cfg.iters,
            "pool": pools * calls, "pool_bwd": 0, "fps_pruned": 0,
            "cross_pool": 0, "knn_features": 4 if cfg.cross == "fg" else 0}


def distill_launches(t_cfg, s_cfg) -> dict:
    """Launches of one KD step: the frozen teacher's forward, the
    student's, and the backward of the student's pools alone."""
    t_fwd, s_fwd = forward_launches(t_cfg), forward_launches(s_cfg)
    return dict({n: t_fwd[n] + s_fwd[n] for n in t_fwd},
                pool_bwd=s_fwd["pool"])


@contextlib.contextmanager
def _swapped(make):
    """Replace each kernel entry of ENTRIES by make(name, entry, plain)."""
    originals = {n: getattr(m, a) for n, (m, a, _) in ENTRIES.items()}
    try:
        for n, (m, a, p) in ENTRIES.items():
            setattr(m, a, make(n, originals[n], p))
        yield
    finally:
        for n, (m, a, _) in ENTRIES.items():
            setattr(m, a, originals[n])


def plain_kernels():
    """Every kernel entry runs its plain version instead (on any device);
    the kernels launch nothing."""
    return _swapped(lambda n, entry, plain: plain)


def recording(store: dict):
    """Every kernel entry appends a copy of its arguments to store[name]
    (a dict of lists, one a name of ENTRIES), then runs."""
    def make(name, entry, _plain):
        def run(*args):
            store[name].append(tuple(
                a.detach().clone() if torch.is_tensor(a) else a
                for a in args))
            return entry(*args)
        return run
    return _swapped(make)


def empty_sites() -> dict:
    return {n: [] for n in ENTRIES}


def hold_fps(xyz, m):
    """The FPS kernel bit-identical to fps_plain at its plan's G and at
    every G whose clusters fit the card's SMs."""
    B, N = xyz.shape[:2]
    gs = [g for g in fps_mod.CLUSTER_SIZES if B * g <= fps_mod.SMS
          and (g > 1 or N <= fps_mod.ONE_BLOCK_POINTS)]
    with torch.inference_mode():
        want = fps_mod.fps_plain(xyz, m)
        bad = {g: int((fps_mod._fps_cuda(xyz, m, g) != want).sum())
               for g in gs}
        bad["plan"] = int((fps_mod._fps_cuda(xyz, m) != want).sum())
    assert not any(bad.values()), (tuple(xyz.shape), m, bad)


def hold_knn(k, xyz, q):
    """The kNN kernel bit-identical to knn_plain: indices in order, d2."""
    with torch.inference_mode():
        (dk, ik), (dp, ip) = knn_mod._knn_cuda(k, xyz, q), knn_mod.knn_plain(
            k, xyz, q)
    site = f"k={k} {tuple(q.shape)} x {tuple(xyz.shape)}"
    assert torch.equal(ik, ip), (site, int((ik != ip).sum()))
    assert torch.equal(dk, dp), (site, int((dk != dp).sum()))


def pool_bwd_plain(u, idx, v, weight, bias, ct):
    """(d_u, d_v, d_weight, d_bias) of pool_plain by torch.autograd."""
    ts = [t.detach().requires_grad_() for t in (u, v, weight, bias)]
    with torch.enable_grad():
        out = pool_mod.pool_plain(ts[0], idx, ts[1], ts[2], ts[3])
        return torch.autograd.grad(out, ts, ct)


def tie_case(u, idx, v, weight, bias, ct):
    """Pool inputs with exact ties: in the first quarter of the queries
    every neighbour alternates between rows 0 and 1 of u, made equal; in
    the second quarter all neighbours are one row and v cancels it, so the
    first leaky's input is exactly 0 and every p_k is the bias, which is
    exactly 0 in every fourth channel."""
    from kd_pointcloud_tpu_torch.ops import gather_points

    u, idx, v, bias = u.clone(), idx.clone(), v.clone(), bias.clone()
    q = idx.shape[1] // 4
    u[:, 1] = u[:, 0]
    idx[:, :q, 0::2], idx[:, :q, 1::2] = 0, 1
    idx[:, q:2 * q, :] = idx[:, q:2 * q, :1]
    v[:, q:2 * q] = -gather_points(u, idx[:, q:2 * q, 0].contiguous())
    bias[::4] = 0.0
    return u, idx, v, weight, bias, ct


def union_case(u, idx, v, weight, bias, ct):
    """Pool inputs shaped like the FG layer's union of two neighbour
    halves: slots 16-31 repeat slots 0-15 in reverse, so every neighbour
    is in two slots of its query, an exact tie of two slots everywhere."""
    idx = idx.clone()
    idx[:, :, 16:32] = idx[:, :, :16].flip(-1)
    return u, idx, v, weight, bias, ct


def ragged_case(u, idx, v, weight, bias, ct):
    """Pool inputs off the path's grid: K = 16 neighbours (slots left
    empty in the backward kernel) and N1 not a multiple of any query
    tile."""
    n = idx.shape[1] - 5
    return (u, idx[:, :n, :16].contiguous(), v[:, :n].contiguous(), weight,
            bias, ct[:, :n].contiguous())


def zero_gradient_leaf(name: str) -> bool:
    """The Dense bias feeding a flow head's BatchNorm: the batch mean
    removes it, so its true gradient is 0 and any float32 value is
    rounding noise."""
    return (name.startswith("flow") and ".convs." in name
            and name.endswith("dense.bias"))


def leaf_errors(model_k, model_p) -> dict:
    """Each gradient leaf of model_k against model_p's: error / the leaf's
    max |model_p|; zero-gradient leaves must be below 1e-5 of the largest
    gradient, and are left out."""
    grads_p = {n: p.grad for n, p in model_p.named_parameters()}
    top = max(float(g.abs().max()) for g in grads_p.values())
    rels = {}
    for name, p in model_k.named_parameters():
        gk, gp = p.grad, grads_p[name]
        assert gk is not None and bool(torch.isfinite(gk).all()), \
            f"gradient of {name} missing or not finite"
        if zero_gradient_leaf(name):
            assert max(float(gk.abs().max()), float(gp.abs().max())) \
                <= 1e-5 * top, f"{name}: a zero gradient is not ~0"
            continue
        rels[name] = (float((gk - gp).abs().max())
                      / max(float(gp.abs().max()), 1e-30))
    return rels


def compare_grads(model_k, model_p, allow=None) -> None:
    """Every gradient leaf of model_k (a step through the kernels) within
    GRAD_TOL (plus allow[leaf] where given) of model_p's (the plain
    versions), relative to the leaf's max |plain|."""
    allow = allow or {}
    bad = {n: r for n, r in leaf_errors(model_k, model_p).items()
           if r > GRAD_TOL + allow.get(n, 0.0)}
    assert not bad, f"gradient leaves past {GRAD_TOL}: {bad}"


def compare_stats(model_k, model_p) -> float:
    """BatchNorm running statistics of model_k against model_p's: the
    largest error / max |plain| of a buffer."""
    stats_p = dict(model_p.named_buffers())
    err = 0.0
    for name, buf in model_k.named_buffers():
        if ".running_" in name:
            want = stats_p[name]
            err = max(err, float((buf - want).abs().max())
                      / max(float(want.abs().max()), 1e-30))
    return err


def workflow(device: str, n_points: int = N_POINTS, ft3d=None, kitti=None,
             steps: int = WORKFLOW_STEPS) -> dict:
    """The user's path through the cli entries, on seeded trees written
    under a temporary directory (data.synthetic): an FT3D-subset tree of
    ft3d["train"] + ft3d["val"] scenes (the class's counts lowered to it)
    and a KITTI tree of 200 scene directories, ft3d / kitti["points"] rows
    a scene. Each run reads a kd_pointcloud_tpu/configs YAML with the tree,
    an experiment directory, the epochs and full: true written over it:

      train (2 epochs of `steps` steps, then a resume from the best
      checkpoint for one more epoch), evaluate on KITTI with the trained
      checkpoint, the device and host eval paths on KITTI (batch 1) and
      FT3D val (batch 3, padded last batch) from fresh loaders at 0
      workers, so both see the same points, and distill, distill_bridge
      (the trained teacher) and fast_distill, 1 epoch of `steps` steps
      each.

    Every run's kernel launches are counted from 0 (set just before it,
    read just after). Returns what it saw; raises on a fault."""
    import yaml

    from kd_pointcloud_tpu_torch.cli import (distill, distill_bridge,
                                             evaluate, fast_distill, train)
    from kd_pointcloud_tpu_torch.data import DataLoader, datasets, synthetic
    from kd_pointcloud_tpu_torch.eval import evaluate_model
    from kd_pointcloud_tpu_torch.ops import kernels
    from kd_pointcloud_tpu_torch.train import (build_datasets, build_model,
                                               load_checkpoint, load_weights)
    from kd_pointcloud_tpu_torch.utils import Config, postprocess

    ft3d = ft3d or WORKFLOW_FT3D
    kitti = kitti or WORKFLOW_KITTI
    out = dict(runs={})
    base = Path(tempfile.mkdtemp(prefix="kdpc_workflow_"))
    cls = datasets.FlyingThings3DSubset
    counts = cls.TRAIN_COUNT, cls.VAL_COUNT

    def config(name, **over):
        raw = yaml.safe_load((ROOT / "kd_pointcloud_tpu" / "configs"
                              / f"{name}.yaml").read_text())
        raw.update(over)
        path = base / f"{name}_{len(list(base.glob('*.yaml')))}.yaml"
        path.write_text(yaml.safe_dump(raw))
        return str(path)

    def run(label, fn):
        if device == "cuda":
            torch.cuda.synchronize()
        kernels.reset_launches()
        result = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        out["runs"][label] = dict(launches=dict(kernels.LAUNCHES))
        return result

    def finite(label, history):
        for h in history:
            assert all(x is None or math.isfinite(x) for x in
                       (h["loss"], h["epe"], h["eval_loss"])), \
                f"{label} epoch {h['epoch']}: not finite"

    try:
        cls.TRAIN_COUNT, cls.VAL_COUNT = ft3d["train"], ft3d["val"]
        ft_root = synthetic.write_ft3d_tree(str(base / "ft3d"),
                                            ft3d["train"], ft3d["val"],
                                            ft3d["points"], seed=SEED)
        kitti_root, calib = synthetic.write_kitti_tree(
            str(base / "kitti"), kitti["mapped"], kitti["points"],
            seed=SEED)
        common = dict(data_root=ft_root, experiment_dir=str(base / "exp"),
                      num_points=n_points, full=True)
        argv = ["--device", device]

        # ---- train, then resume from the best checkpoint
        t_cfg = config("train_teacher_ft3d", epochs=2, **common)
        _, _, best, _, hist = run("train", lambda: train.main(
            [t_cfg, *argv], max_steps_per_epoch=steps))
        finite("train", hist)
        ckpt = [h["checkpoint"] for h in hist if h["checkpoint"]][-1]
        saved = load_checkpoint(ckpt)
        assert best == saved["best_epe"], "best EPE is not the checkpoint's"
        r_cfg = config("train_teacher_ft3d", epochs=saved["epoch"] + 2,
                       pretrain=ckpt, **common)
        _, _, best_r, _, hist_r = run("resume", lambda: train.main(
            [r_cfg, *argv], max_steps_per_epoch=steps))
        finite("resume", hist_r)
        assert [h["epoch"] for h in hist_r] == [saved["epoch"] + 1], \
            f"resumed at {[h['epoch'] for h in hist_r]}"
        assert best_r == min(saved["best_epe"], hist_r[0]["epe"]), \
            "the resumed run did not start from the checkpoint's best"
        out["train"] = dict(epochs=hist, resume=hist_r)

        # ---- evaluate with the trained checkpoint (KITTI, batch 1)
        e_cfg = config("evaluate_kitti", data_root=kitti_root,
                       pretrain=ckpt, num_points=n_points)
        results = run("evaluate", lambda: evaluate.main([e_cfg, *argv]))
        assert all(math.isfinite(v) for v in results.values()), results
        out["evaluate"] = dict(metrics=results)

        # ---- the device and host paths on the same points
        net = build_model(Config(), device=device)
        net.load_state_dict(load_weights(ckpt), strict=True)
        args = postprocess(Config(yaml.safe_load(Path(t_cfg).read_text())))
        e_args = postprocess(Config(yaml.safe_load(Path(e_cfg).read_text())))
        for label, a, batch, n_real in (
                ("KITTI", e_args, 1, len(kitti["mapped"])),
                ("FT3D val", args, 3, ft3d["val"])):
            sweeps = {}
            for path in ("device", "host"):
                _, val_ds = build_datasets(a, need_train=False)
                loader = DataLoader(val_ds, batch, shuffle=False,
                                    pad_last=True, num_workers=0)
                sweeps[path] = run(f"eval {label} {path}", lambda: (
                    evaluate_model(net, loader, calib_dir=calib,
                                   device_metrics=path == "device")))
            dev, host = sweeps["device"], sweeps["host"]
            assert list(dev) == list(host), f"{label}: keys differ"
            for k in dev:
                if k == "acc2d":        # counts of points, ties aside
                    diff = abs(dev[k] - host[k]) * n_points * n_real
                    assert diff <= n_real + 1e-3, \
                        f"{label} acc2d counts differ by {diff}"
                else:
                    assert abs(dev[k] - host[k]) <= EVAL_PATHS_RTOL * max(
                        abs(host[k]), 1e-6), \
                        f"{label} {k}: {dev[k]} device, {host[k]} host"
        del net

        # ---- the three distillation entries
        teacher = dict(ckpt_dir=str(Path(ckpt).parent),
                       teacher_model=Path(ckpt).name)
        out["distill"] = {}
        for label, entry, name, extra in (
                ("distill", distill, "distill_kd", teacher),
                ("distill_bridge", distill_bridge, "distill_bridge",
                 teacher),
                ("fast_distill", fast_distill, "fast_distill", {})):
            d_cfg = config(name, epochs=1, **common, **extra)
            _, _, _, _, hist_d = run(label, lambda: entry.main(
                [d_cfg, *argv], max_steps_per_epoch=steps))
            finite(label, hist_d)
            assert hist_d[0]["checkpoint"] is not None and Path(
                hist_d[0]["checkpoint"]).exists(), \
                f"{label}: no checkpoint written"
            out["distill"][label] = hist_d
    finally:
        cls.TRAIN_COUNT, cls.VAL_COUNT = counts
        shutil.rmtree(base, ignore_errors=True)
    return out


def preprocess_eval(device: str, n_points: int = N_POINTS, ft3d=None,
                    kitti=None, workers: int = 2) -> dict:
    """Raw frames to the eval: seeded raw FT3D-subset and KITTI frames
    (data.synthetic; ft3d / kitti give their counts and sizes) through the
    preprocessors' entries (data.preprocess.ft3d with the near-points
    filter, data.preprocess.kitti), into the trees the datasets read, then
    evaluate_model of a seeded teacher at batch 1 on each tree (FT3D val,
    KITTI with its calibration). Every raw PNG is one the bundled codec
    reads, so no step needs PIL. Each eval's launches are counted from 0.
    Returns what it saw; raises on a fault."""
    import numpy as np

    from kd_pointcloud_tpu_torch.data import (KITTI, DataLoader,
                                              FlyingThings3DSubset,
                                              ProcessData, synthetic)
    from kd_pointcloud_tpu_torch.data.preprocess import ft3d as ft3d_pre
    from kd_pointcloud_tpu_torch.data.preprocess import kitti as kitti_pre
    from kd_pointcloud_tpu_torch.data.preprocess import png16
    from kd_pointcloud_tpu_torch.eval import evaluate_model
    from kd_pointcloud_tpu_torch.ops import kernels

    ft3d = ft3d or RAW_FT3D
    kitti = kitti or RAW_KITTI
    base = Path(tempfile.mkdtemp(prefix="kdpc_preprocess_"))
    out = dict(scenes={}, metrics={}, launches={})
    try:
        raw_ft = synthetic.write_raw_ft3d(
            str(base / "raw_ft3d"), ft3d["train"], ft3d["val"],
            ft3d["height"], ft3d["width"], seed=SEED)
        raw_ki, calib = synthetic.write_raw_kitti(
            str(base / "raw_kitti"), kitti["frames"], kitti["height"],
            kitti["width"], seed=SEED)
        pngs = sorted(base.rglob("*.png"))
        assert pngs and all(png16.decodable(str(f)) for f in pngs), \
            "a raw PNG the codec does not read"
        ft_root = base / "ft3d"
        ki_root = base / "kitti"
        for entry, argv in (
                (ft3d_pre, ["--raw_data_path", raw_ft, "--save_path",
                            str(ft_root / FlyingThings3DSubset.DIRNAME),
                            "--only_save_near_pts"]),
                (kitti_pre, [raw_ki, str(ki_root / "kitti_processed"),
                             "--calib_root", calib])):
            entry.main(argv + ["--workers", str(workers)])
        mapped = set(kitti["frames"])
        (ki_root / "KITTI_mapping.txt").write_text("".join(
            ("mapped" if i in mapped else "") + "\n" for i in range(200)))

        teacher = model("teacher", SEED, device)
        transform = ProcessData(num_points=n_points)
        for label, ds, calib_dir in (
                ("FT3D val", FlyingThings3DSubset(
                    False, transform, str(ft_root), strict_counts=False,
                    num_points=n_points), None),
                ("KITTI", KITTI(False, transform, str(ki_root),
                                strict_counts=False, num_points=n_points),
                 calib)):
            out["scenes"][label] = [int(np.load(Path(d) / "pc1.npy",
                                                mmap_mode="r").shape[0])
                                    for d in ds.samples]
            loader = DataLoader(ds, 1, shuffle=False, pad_last=True,
                                num_workers=0)
            kernels.reset_launches()
            metrics = evaluate_model(teacher, loader, calib_dir=calib_dir)
            if device == "cuda":
                torch.cuda.synchronize()
            out["launches"][label] = dict(kernels.LAUNCHES)
            out["metrics"][label] = metrics
            assert len(metrics) == 7 and all(
                math.isfinite(v) for v in metrics.values()), \
                f"{label}: metrics {metrics}"
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return out


def mesh_phase(tmp: str, cfg, device: str = "cuda",
               n_points: int = N_POINTS) -> dict:
    """The train step of a cfg model (the teacher) on a data mesh. (a) an
    NCCL world of one rank in this process (gloo off the card) against the
    no-mesh step on the same batch and weights: loss within 1e-5 relative,
    gradients within GRAD_TOL, BatchNorm statistics within 1e-5; (b) a gloo
    world of MESH_RANKS ranks spawned by tests/torch_parallel_ranks.py, all
    on cuda:0 on the card (NCCL refuses two ranks a card), at a global
    batch of MESH_BATCH, against one step over the same rows here under
    the same gates (a gradient leaf within GRAD_TOL plus what moving pos1
    by one ulp moves that leaf of the one-device step: float32 max and kNN
    choices flip where the forward rounds differently), equal on every
    rank. Returns the launches of (a)'s step and of each rank's."""
    import torch.distributed as dist

    import torch_parallel_ranks as ranks
    from kd_pointcloud_tpu_torch.ops import kernels
    from kd_pointcloud_tpu_torch.parallel import (init_mesh,
                                                  resolve_global_batch,
                                                  shard_batch)
    from kd_pointcloud_tpu_torch.train import make_train_step

    dev = "cuda:0" if device == "cuda" else device

    def teacher():
        return model(cfg, SEED, dev)

    # (b)'s ranks start first: each takes seconds to reach the card
    started = ranks.start(MESH_RANKS, {"step": ("mesh_step", dict(
        cfg=cfg, n_points=n_points, batch=MESH_BATCH, model_seed=SEED,
        batch_seed=SEED + 5))}, f"{tmp}/gloo", device=dev)
    try:
        # (a) NCCL (gloo off the card), world 1, in this process
        mesh = init_mesh(0, 1, f"file://{tmp}/nccl", dev,
                         timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        try:
            backend = dist.get_backend(mesh.group)
            global_bs = resolve_global_batch(TRAIN_BATCH, True, mesh.size)
            assert (mesh.size, backend, global_bs) == (
                1, "nccl" if device == "cuda" else "gloo", TRAIN_BATCH)
            batch = synthetic_batches(1, global_bs, n_points, SEED + 1,
                                      dev)[0]
            m_mesh = teacher()
            m_none = copy.deepcopy(m_mesh)
            step_mesh = make_train_step(m_mesh, make_optimizer(m_mesh),
                                        mesh=mesh)
            step_none = make_train_step(m_none, make_optimizer(m_none))
            kernels.reset_launches()
            loss_m = float(step_mesh(shard_batch(mesh, batch)))
            launches = dict(kernels.LAUNCHES)
            loss_n = float(step_none(batch))
        finally:
            dist.destroy_process_group()
        assert abs(loss_m - loss_n) <= 1e-5 * abs(loss_n), \
            f"mesh step loss {loss_m}, no mesh {loss_n}"
        compare_grads(m_mesh, m_none)
        assert compare_stats(m_mesh, m_none) <= 1e-5
        del m_mesh, m_none, step_mesh, step_none

        # (b) the reference: one step over the same global batch here, and
        # the control: that step again with pos1 moved by one ulp
        whole = synthetic_batches(1, MESH_BATCH, n_points, SEED + 5, dev)[0]
        ref, control = teacher(), teacher()
        loss_r = float(make_train_step(ref, make_optimizer(ref))(whole))
        nudged = dict(whole, pos1=torch.nextafter(
            whole["pos1"], torch.full_like(whole["pos1"], math.inf)))
        make_train_step(control, make_optimizer(control))(nudged)
        spread = leaf_errors(control, ref)
    finally:
        rank_results = ranks.collect(started)
    got = ranks.result(rank_results, "step")
    for r, g in enumerate(got):
        holder = teacher()
        for n, p in holder.named_parameters():
            p.grad = g["grads"][n].to(dev)
        with torch.no_grad():
            for n, b in holder.named_buffers():
                b.copy_(g["buffers"][n])
        assert g["rows"] == MESH_BATCH // MESH_RANKS
        assert abs(g["loss"] - loss_r) <= 1e-5 * abs(loss_r), \
            f"rank {r} loss {g['loss']}, one device {loss_r}"
        compare_grads(holder, ref, allow=spread)
        assert compare_stats(holder, ref) <= 1e-5, f"rank {r} statistics"
    for g in got[1:]:
        for key in ("grads", "buffers"):
            assert all(torch.equal(got[0][key][n], g[key][n])
                       for n in got[0][key]), f"the ranks' {key} differ"
    return dict(launches=launches, rank_launches=[g["launches"] for g in got])
