"""The port's loader-driven eval sweep, epoch loops and command-line entries
against the JAX package's, on small seeded trees (data.synthetic) at
tiny_config shapes (256 points a cloud, exact kNN on both sides).

- evaluate_model: the six metrics and the eval loss over a loader with a
  padded last batch, FT3D (the fixed camera) and KITTI (calib files
  written beside the tree), the device path and the host path, against
  JAX's device path; the host paths of both packages on a sweep without
  padding. 3-D metrics and the loss within 1e-5 relative; EPE2D within
  1e-5 relative (the projection's float32 divide by z rounds apart between
  XLA and torch); ACC2D as exact counts of points.
- train_teacher: 2 epochs x 2 steps from JAX's own init_model(seed=0)
  weights (carried by params_from_jax), loaders at 0 workers so both see
  the same batches: every step's loss and each epoch's mean loss, eval
  EPE3D and eval loss within TRAIN_RTOL = 2e-3 relative. One train step
  agrees to 1e-5 (test_torch_port_train.py); Adam's first steps move each
  weight by about lr whatever the size of its gradient, so gradient
  elements that round apart in float32 move weights apart, and after 4
  steps the eval EPE3D differs by 3.2e-4 relative (measured). 2e-3 keeps a
  6x margin and stays far below what a wrong batch, step or learning rate
  moves: the mean loss falls 20 % from one epoch to the next.
- resume and distill (standard, attentive, bridge, fast), port only: the
  checkpoint exists and the state restored from it equals it.
- the five cli entries as python -m would run them, with --device cpu and
  jax made unimportable, on the same trees.

The JAX loops run single-device here (its data-parallel plan is patched
out), as the port's do without a process group; the port's data-parallel
loops are held in tests/test_torch_port_parallel.py.
"""

import dataclasses
import functools
import json
import os.path as osp
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from kd_pointcloud_tpu.data import datasets as jax_datasets
from kd_pointcloud_tpu.data import loader as jax_loader
from kd_pointcloud_tpu.data import transforms as jax_tf
from kd_pointcloud_tpu.eval import geometry as jax_geometry
from kd_pointcloud_tpu.eval import runner as jax_runner
from kd_pointcloud_tpu.models import PRESETS as JAX_PRESETS
from kd_pointcloud_tpu.models import BidPointFlowNet as JaxNet
from kd_pointcloud_tpu.models import tiny_config as jax_tiny_config
from kd_pointcloud_tpu.train import experiment as jax_exp
from kd_pointcloud_tpu_torch.cli import evaluate as cli_evaluate
from kd_pointcloud_tpu_torch.cli import train as cli_train
from kd_pointcloud_tpu_torch.data import (DataLoader, ProcessData, datasets,
                                          synthetic)
from kd_pointcloud_tpu_torch.eval import evaluate_model
from kd_pointcloud_tpu_torch.models import (PRESETS, BidPointFlowNet,
                                            params_from_jax, tiny_config)
from kd_pointcloud_tpu_torch.train import checkpoints
from kd_pointcloud_tpu_torch.train import distill_experiment as port_kd
from kd_pointcloud_tpu_torch.train import experiment as port_exp

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIGS = osp.join(ROOT, "kd_pointcloud_tpu", "configs")
N_POINTS = 256
N_TRAIN, N_VAL = 5, 3
KITTI_MAPPED = (4, 60, 199)
TINY = ("teacher", "lighttoken_res", "bifeat", "fg")
RTOL = 1e-5
TRAIN_RTOL = 2e-3


def _config(name, **over):
    with open(osp.join(CONFIGS, name + ".yaml")) as fd:
        raw = yaml.safe_load(fd)
    raw.update(over)
    return raw


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("exp")
    ft3d = synthetic.write_ft3d_tree(str(base / "ft3d"), N_TRAIN, N_VAL,
                                     320, seed=3)
    kitti, calib = synthetic.write_kitti_tree(str(base / "kt"), KITTI_MAPPED,
                                              400, seed=4)
    return dict(base=base, ft3d=ft3d, kitti=kitti, calib=calib)


@pytest.fixture(scope="module")
def patched():
    """Both packages at tiny_config (exact kNN), the FT3D counts lowered to
    the tree's, the JAX loops single-device."""
    with pytest.MonkeyPatch.context() as mp:
        for name in TINY:
            mp.setitem(PRESETS, name, tiny_config(name))
            mp.setitem(JAX_PRESETS, name, dataclasses.replace(
                jax_tiny_config(name), knn_method="exact"))
        for mod in (jax_datasets, datasets):
            mp.setattr(mod.FlyingThings3DSubset, "TRAIN_COUNT", N_TRAIN)
            mp.setattr(mod.FlyingThings3DSubset, "VAL_COUNT", N_VAL)
        mp.setattr(jax_exp, "data_parallel_plan",
                   lambda bs, logger=None: (None, None, bs))
        yield mp


def _args(tree, name, tag, **over):
    from kd_pointcloud_tpu_torch.utils import Config, postprocess

    return postprocess(Config(_config(
        name, **dict(dict(data_root=tree["ft3d"], num_points=N_POINTS,
                          experiment_dir=str(tree["base"] / tag), full=True,
                          workers=0, batch_size=2, epochs=2), **over))))


# ------------------------------------------------------------- train loop

@pytest.fixture(scope="module")
def teacher_runs(tree, patched):
    """JAX's train_teacher, then the port's from the same initial weights;
    every step's loss and each epoch's eval as each loop saw them."""
    from kd_pointcloud_tpu.utils import Config as JaxConfig
    from kd_pointcloud_tpu.utils import postprocess as jax_postprocess

    rec = dict(jax_steps=[], jax_evals=[], init=None)
    del patched
    init_model, make_step, evals = (jax_exp.init_model,
                                    jax_exp.make_train_step,
                                    jax_exp.eval_sceneflow)

    def init(model, batch, seed=0):
        rec["init"] = jax.device_get(init_model(model, batch, seed))
        return rec["init"]

    def train_step(model, tx):
        step = make_step(model, tx)

        def run(state, batch):
            state, loss = step(state, batch)
            rec["jax_steps"].append(float(loss))
            return state, loss
        return run

    def eval_sf(*a, **kw):
        rec["jax_evals"].append(evals(*a, **kw))
        return rec["jax_evals"][-1]

    with pytest.MonkeyPatch.context() as local:
        local.setattr(jax_exp, "init_model", init)
        local.setattr(jax_exp, "make_train_step", train_step)
        local.setattr(jax_exp, "eval_sceneflow", eval_sf)
        jargs = jax_postprocess(JaxConfig(_config(
            "train_teacher_ft3d", data_root=tree["ft3d"],
            num_points=N_POINTS, experiment_dir=str(tree["base"] / "jax"),
            full=True, workers=0, batch_size=2, epochs=2)))
        jax_exp.train_teacher(jargs, max_steps_per_epoch=2)

    def from_jax(args, device="cuda", **_):
        model = BidPointFlowNet(tiny_config("teacher"), device=device)
        model.load_state_dict(params_from_jax(rec["init"]), strict=True)
        return model

    port_steps = []
    port_make_step = port_exp.make_train_step

    def port_train_step(model, optimizer, mesh=None):
        step = port_make_step(model, optimizer, mesh=mesh)

        def run(batch):
            loss = step(batch)
            port_steps.append(float(loss))
            return loss
        return run

    with pytest.MonkeyPatch.context() as local:
        local.setattr(port_exp, "build_model", from_jax)
        local.setattr(port_exp, "make_train_step", port_train_step)
        args = _args(tree, "train_teacher_ft3d", "port")
        out = port_exp.train_teacher(args, device="cpu",
                                     max_steps_per_epoch=2)
    rec.update(port=out, port_steps=port_steps, args=args)
    return rec


def test_train_teacher_matches_jax(teacher_runs):
    model, optimizer, best_epe, run_dir, history = teacher_runs["port"]
    assert [h["epoch"] for h in history] == [0, 1]
    assert [h["steps"] for h in history] == [2, 2]
    assert len(teacher_runs["jax_steps"]) == len(teacher_runs["port_steps"])
    np.testing.assert_allclose(teacher_runs["port_steps"],
                               teacher_runs["jax_steps"], rtol=TRAIN_RTOL)
    jax_losses = np.mean(np.reshape(teacher_runs["jax_steps"], (2, 2)), 1)
    np.testing.assert_allclose([h["loss"] for h in history], jax_losses,
                               rtol=TRAIN_RTOL)
    jax_epe, jax_eval_loss = np.transpose(teacher_runs["jax_evals"])
    np.testing.assert_allclose([h["epe"] for h in history], jax_epe,
                               rtol=TRAIN_RTOL)
    np.testing.assert_allclose([h["eval_loss"] for h in history],
                               jax_eval_loss, rtol=TRAIN_RTOL)
    assert best_epe == min(h["epe"] for h in history)
    assert all(np.isfinite(h["loss"]) for h in history)


def test_train_teacher_checkpoints_best_epe(teacher_runs):
    model, optimizer, best_epe, run_dir, history = teacher_runs["port"]
    written = [h["checkpoint"] for h in history if h["checkpoint"]]
    assert written and history[0]["checkpoint"]
    best = checkpoints.best_checkpoint(osp.join(run_dir, "checkpoints"))
    assert best == written[-1]
    tree = checkpoints.load_checkpoint(best)
    assert tree["best_epe"] == best_epe
    assert osp.basename(best) == f"PointConv_{tree['epoch']:03d}_" \
        f"{best_epe:.4f}"
    log = osp.join(run_dir, "logs", "train_PointConv_sceneflow.txt")
    assert "Save model to" in open(log).read()


def _assert_state_equal(model, optimizer, tree):
    for k, v in model.state_dict().items():
        assert torch.equal(v, tree["model"][k]), k
    got, want = optimizer.state_dict(), tree["optimizer"]
    assert got["param_groups"][0]["lr"] == want["param_groups"][0]["lr"]
    for i, state in want["state"].items():
        for k, v in state.items():
            assert torch.equal(got["state"][i][k], v), (i, k)


def test_resume_restores_the_checkpoint(tree, teacher_runs):
    """Resume from the best checkpoint: the epoch after it, the best EPE,
    the weights, BatchNorm statistics and Adam moments as saved."""
    *_, history = teacher_runs["port"]
    ckpt = [h["checkpoint"] for h in history if h["checkpoint"]][-1]
    saved = checkpoints.load_checkpoint(ckpt)
    args = _args(tree, "train_teacher_ft3d", "resume", pretrain=ckpt)
    model, optimizer, best, _, hist = port_exp.train_teacher(
        args, device="cpu", max_epochs=saved["epoch"] + 1)
    assert hist == [] and best == saved["best_epe"]
    _assert_state_equal(model, optimizer, saved)
    *_, hist = port_exp.train_teacher(args, device="cpu",
                                      max_epochs=saved["epoch"] + 2,
                                      max_steps_per_epoch=1)
    assert [h["epoch"] for h in hist] == [saved["epoch"] + 1]
    assert port_exp.resume_epoch(7, float("inf")) == 7     # bare weights


# --------------------------------------------------------------- distill

@pytest.mark.parametrize("mode,loss", [("standard", "biDirection_loss_ht"),
                                       ("standard", "attentiveImitationLoss"),
                                       ("bridge", None), ("fast", None)])
def test_distill_checkpoint_and_resume(tree, teacher_runs, monkeypatch, mode,
                                       loss):
    """One step an epoch: the student checkpoint (with the Bridge and its
    optimizer in bridge mode) exists, and resuming from it restores it; the
    teacher comes from the trained teacher's checkpoint (standard mode).
    Fast mode evaluates epoch 0 (before FAST_FROM) and then only every
    FAST_RATIO-th epoch of the window."""
    name = {"standard": "distill_kd", "bridge": "distill_bridge",
            "fast": "fast_distill"}[mode]
    over = dict(kd_loss=loss) if loss else {}
    *_, history = teacher_runs["port"]
    teacher_ckpt = history[0]["checkpoint"]
    if mode == "standard":
        over.update(ckpt_dir=osp.dirname(teacher_ckpt),
                    teacher_model=osp.basename(teacher_ckpt))
    seen = {}
    for fn in ("make_distill_step", "make_bridge_distill_step"):
        orig = getattr(port_kd, fn)

        def capture(*a, _orig=orig, **kw):
            seen["args"] = a
            return _orig(*a, **kw)
        monkeypatch.setattr(port_kd, fn, capture)
    if mode == "fast":
        monkeypatch.setattr(port_kd, "FAST_FROM", 1)
    args = _args(tree, name, f"kd_{mode}", **over)
    epochs = 2 if mode == "fast" else 1
    s_model, opt, best, run_dir, hist = port_kd.distill(
        args, mode, device="cpu", max_epochs=epochs, max_steps_per_epoch=1)
    assert [h["steps"] for h in hist] == [1] * epochs
    assert np.isfinite(hist[0]["loss"]) and np.isfinite(hist[0]["epe"])
    if mode == "fast":
        assert hist[1]["epe"] is None and hist[1]["checkpoint"] is None
    if mode == "standard":
        t_model = seen["args"][0]
        saved_t = checkpoints.load_checkpoint(teacher_ckpt)["model"]
        for k, v in t_model.state_dict().items():
            assert torch.equal(v, saved_t[k]), k
    ckpt = hist[0]["checkpoint"]
    assert osp.basename(ckpt).startswith("S_000_")
    saved = checkpoints.load_checkpoint(ckpt)
    assert ("bridge_params" in saved) == ("bridge_opt" in saved) == (
        mode == "bridge")
    seen.clear()
    resumed = port_kd.distill(_args(tree, name, f"kd_{mode}", pretrain=ckpt,
                                    **over), mode, device="cpu",
                              max_epochs=1)
    assert resumed[4] == [] and resumed[2] == saved["best_epe"]
    _assert_state_equal(resumed[0], resumed[1], saved)
    if mode == "bridge":
        bridge, b_opt = seen["args"][2], seen["args"][4]
        for k, v in bridge.state_dict().items():
            assert torch.equal(v, saved["bridge_params"][k]), k
        assert b_opt.state_dict()["state"].keys() == \
            saved["bridge_opt"]["state"].keys()
        for i, st in saved["bridge_opt"]["state"].items():
            for k, v in st.items():
                assert torch.equal(b_opt.state_dict()["state"][i][k], v)


# ------------------------------------------------------------- eval sweep

@pytest.fixture(scope="module")
def eval_models(teacher_runs):
    """The same weights in both packages: JAX's init with non-trivial
    BatchNorm running statistics."""
    rng = np.random.RandomState(0)
    variables = dict(teacher_runs["init"])
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
        variables["batch_stats"])
    net = JaxNet(JAX_PRESETS["teacher"])
    model = BidPointFlowNet(tiny_config("teacher"), device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    return net, variables, model


def _eval_loaders(tree, kitti, n=None):
    if kitti:
        ds = datasets.KITTI(False, ProcessData(num_points=N_POINTS),
                            tree["kitti"], seed=5)
        jds = jax_datasets.KITTI(
            False, jax_tf.ProcessData(num_points=N_POINTS), tree["kitti"],
            seed=5, mapping_path=osp.join(tree["kitti"],
                                          "KITTI_mapping.txt"))
    else:
        ds = datasets.FlyingThings3DSubset(
            False, ProcessData(num_points=N_POINTS), tree["ft3d"], seed=5)
        jds = jax_datasets.FlyingThings3DSubset(
            False, jax_tf.ProcessData(num_points=N_POINTS), tree["ft3d"],
            seed=5)
    if n is not None:
        ds.samples, jds.samples = ds.samples[:n], jds.samples[:n]
    kw = dict(shuffle=False, pad_last=True, num_workers=0)
    return DataLoader(ds, 2, **kw), jax_loader.DataLoader(jds, 2, **kw)


def _assert_metrics_close(got, want, n_real):
    assert list(got) == ["epe3d", "acc3ds", "acc3dr", "outliers", "epe2d",
                         "acc2d", "loss"]
    assert set(got) == set(want)
    for k in got:
        if k == "acc2d":      # counts of points under the 2-D thresholds
            assert round(got[k] * N_POINTS * n_real) == \
                round(want[k] * N_POINTS * n_real)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=1e-7, err_msg=k)


@pytest.mark.parametrize("kitti", [False, True])
def test_evaluate_model_matches_jax(tree, patched, eval_models, kitti,
                                    monkeypatch):
    """Three scenes at batch 2: the last batch is padded. Both of the
    port's paths against JAX's device path, which masks the pad row."""
    net, variables, model = eval_models
    monkeypatch.setattr(jax_runner, "read_kitti_intrinsics", functools.partial(
        jax_geometry.read_kitti_intrinsics, calib_dir=tree["calib"]))
    want = jax_runner.evaluate_model(net, variables,
                                     _eval_loaders(tree, kitti)[1])
    got = {path: evaluate_model(model, _eval_loaders(tree, kitti)[0],
                                calib_dir=tree["calib"],
                                device_metrics=path == "device")
           for path in ("device", "host")}
    _assert_metrics_close(got["device"], want, 3)
    _assert_metrics_close(got["host"], want, 3)
    device = got["device"]
    assert 0.0 < device["epe2d"] and np.isfinite(device["epe2d"])
    no_2d = evaluate_model(model, _eval_loaders(tree, kitti)[0],
                           with_2d=False, calib_dir=tree["calib"])
    assert "epe2d" not in no_2d and no_2d["epe3d"] == device["epe3d"]


def test_host_paths_match_jax_without_padding(tree, patched, eval_models,
                                              monkeypatch):
    """On a sweep with no pad row, the port's host path against the JAX
    package's host path (which averages pad rows in: it is compared only
    where there are none)."""
    net, variables, model = eval_models
    want = jax_runner.evaluate_model(net, variables,
                                     _eval_loaders(tree, False, n=2)[1],
                                     device_metrics=False)
    got = evaluate_model(model, _eval_loaders(tree, False, n=2)[0],
                         device_metrics=False)
    _assert_metrics_close(got, {k: want[k] for k in got}, 2)


# ------------------------------------------------------------ cli entries

def test_cli_entries_refuse_without_a_card(tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tree["base"] / "refuse.yaml")
    with open(path, "w") as fd:
        yaml.safe_dump(_config("train_teacher_ft3d",
                               data_root=tree["ft3d"]), fd)
    for entry in (cli_train, cli_evaluate):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry.main([path])


CLI_ENTRIES = ("train", "evaluate", "distill", "distill_bridge",
               "fast_distill")


@pytest.fixture(scope="module")
def cli_runs(tree):
    """The five entries, each as python -m runs it, in one fresh process
    whose jax, flax and JAX package are unimportable; the presets are the
    tiny ones and the FT3D counts the tree's."""
    base = tree["base"]
    yamls = {}
    for entry, name in zip(CLI_ENTRIES, ("train_teacher_ft3d",
                                         "evaluate_kitti", "distill_kd",
                                         "distill_bridge", "fast_distill")):
        over = dict(data_root=tree["ft3d"], num_points=N_POINTS,
                    experiment_dir=str(base / "cli"), full=True, workers=2,
                    batch_size=2, epochs=1)
        if entry == "evaluate":
            over = dict(data_root=tree["kitti"], num_points=N_POINTS,
                        workers=2)
        yamls[entry] = str(base / f"cli_{entry}.yaml")
        with open(yamls[entry], "w") as fd:
            yaml.safe_dump(_config(name, **over), fd)
    code = (
        "import json, runpy, sys\n"
        "for m in ('jax', 'flax', 'kd_pointcloud_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from kd_pointcloud_tpu_torch.models import PRESETS, tiny_config\n"
        "from kd_pointcloud_tpu_torch.data import datasets\n"
        f"PRESETS.update({{n: tiny_config(n) for n in {TINY!r}}})\n"
        "cls = datasets.FlyingThings3DSubset\n"
        f"cls.TRAIN_COUNT, cls.VAL_COUNT = {N_TRAIN}, {N_VAL}\n"
        f"for entry, path in {yamls!r}.items():\n"
        "    sys.argv = [entry, path, '--device', 'cpu']\n"
        "    print('ENTRY', entry, flush=True)\n"
        "    runpy.run_module('kd_pointcloud_tpu_torch.cli.' + entry,\n"
        "                     run_name='__main__')\n"
        "print(json.dumps({'done': True}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("entry", CLI_ENTRIES)
def test_cli_entry_runs_on_cpu_without_jax(cli_runs, entry):
    out = cli_runs.split(f"ENTRY {entry}\n", 1)[1]
    nxt = [out.index(f"ENTRY {e}\n") for e in CLI_ENTRIES if
           f"ENTRY {e}\n" in out]
    out = out[:min(nxt)] if nxt else out
    if entry == "evaluate":
        for key in ("epe3d", "acc3ds", "acc3dr", "outliers", "epe2d",
                    "acc2d", "loss"):
            assert np.isfinite(float(out.split(f"\n{key}: ")[1].split()[0]))
    else:
        assert "mean loss" in out and "Save model to" in out
    assert json.loads(cli_runs.strip().splitlines()[-1]) == {"done": True}
