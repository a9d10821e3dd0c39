"""Rank processes for tests/test_torch_port_parallel*.py and the mesh
checks of tests/torch_port_checks.py.

start(world, cases, workdir) spawns `world` processes joined in a gloo
group (file:// under workdir, so concurrent test workers never share a
port; on the CPU, or every rank on one card) that run every named case of
CASES on each rank; collect() returns each rank's results. A case is a
function of the rank's mesh (and keyword inputs); the tests call the same
function in their own process with a mesh of one rank to get the
single-device answer over the global batch. This module imports torch and
the port only, never JAX, so a rank starts in about a second.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import os.path as osp
import pickle
import traceback

import numpy as np
import torch

from kd_pointcloud_tpu_torch.data import datasets
from kd_pointcloud_tpu_torch.eval import evaluate_model
from kd_pointcloud_tpu_torch.models import (PRESETS, BidPointFlowNet, Bridge,
                                            tiny_config)
from kd_pointcloud_tpu_torch.nn.pointconv import _BatchNorm, batch_stats_over
from kd_pointcloud_tpu_torch.ops import kernels
from kd_pointcloud_tpu_torch.parallel import (init_mesh, make_mesh, replicate,
                                              shard_batch)
from kd_pointcloud_tpu_torch.train import (apply_frozen, batch_to_device,
                                           compute_teacher_history,
                                           make_bridge_distill_step,
                                           make_distill_step,
                                           make_fast_distill_step,
                                           make_named_loss, make_optimizer,
                                           make_train_step)
from kd_pointcloud_tpu_torch.train import experiment as port_exp
from kd_pointcloud_tpu_torch.utils import Config, postprocess

N = 256
KD_ARGS = dict(gamma=0.3, beta=0.8, hint_layers=[2, 3])
TIMEOUT_S = 120


# ------------------------------------------------------------------ inputs

def batch_np(b: int, seed: int) -> dict:
    """b seeded scene pairs of N points (as the train tests' batches)."""
    rng = np.random.RandomState(seed)
    pc1 = rng.uniform(-2, 2, (b, N, 3)).astype(np.float32)
    pc2 = (pc1 + 0.1 * rng.standard_normal(pc1.shape)).astype(np.float32)
    return dict(pos1=pc1, pos2=pc2, norm1=pc1, norm2=pc2, flow=pc2 - pc1)


def loader_batch(b: int, seed: int, paths=None) -> tuple:
    """batch_np as a loader batch (pos1, pos2, norm1, norm2, flow, paths)."""
    d = batch_np(b, seed)
    paths = paths or [f"synthetic/{seed:03d}{i}" for i in range(b)]
    return (d["pos1"], d["pos2"], d["norm1"], d["norm2"], d["flow"], paths)


def tensors(mesh, batch: dict, dtype=torch.float64) -> dict:
    """This rank's rows of a numpy batch, as tensors of dtype."""
    return shard_batch(mesh, {k: torch.from_numpy(np.asarray(v)).to(dtype)
                              for k, v in batch.items()})


def model(name: str, seed: int, dtype=torch.float64, state=None):
    net = BidPointFlowNet(tiny_config(name), device="cpu",
                          generator=torch.Generator().manual_seed(seed))
    if state is not None:
        net.load_state_dict(state, strict=True)
    return net.to(dtype)


@contextlib.contextmanager
def plain_in_float64():
    """The plain versions compute in their inputs' dtype; their guards hold
    them to the kernels' float32, so let float64 through."""
    check = kernels.check_tensor

    def check64(name, t, dtype, ndim):
        return check(name, t, torch.float64 if dtype == torch.float32
                     else dtype, ndim)

    kernels.check_tensor = check64
    try:
        yield
    finally:
        kernels.check_tensor = check


def _grads(net) -> dict:
    return {n: p.grad.clone() for n, p in net.named_parameters()
            if p.grad is not None}


def _state(net) -> dict:
    return {k: v.clone() for k, v in net.state_dict().items()}


# ------------------------------------------------------------------- cases

def case_bn(mesh):
    """A _BatchNorm in train mode on 4 x 6 rows of 5 channels (float64):
    this rank's output rows, input gradient rows and parameter-gradient
    share under the cotangent's sum, and the running statistics."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.standard_normal((4, 6, 5)) * 3.0 + 1.0)
    cot = torch.from_numpy(rng.standard_normal((4, 6, 5)))
    bn = _BatchNorm(5, eps=1e-5, momentum=0.1).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, 5)))
        bn.bias.copy_(torch.from_numpy(rng.standard_normal(5)))
    rows = shard_batch(mesh, x).clone().requires_grad_()
    with batch_stats_over(bn, mesh):
        y = bn(rows)
    (y * shard_batch(mesh, cot)).sum().backward()
    return dict(y=y.detach(), x_grad=rows.grad, w_grad=bn.weight.grad,
                b_grad=bn.bias.grad, mean=bn.running_mean.clone(),
                var=bn.running_var.clone())


def case_train64(mesh):
    """One teacher train step at a global batch of 4 in float64: loss,
    gradients, and the state after Adam."""
    net = model("teacher", 0)
    with plain_in_float64():
        loss = make_train_step(net, make_optimizer(net), mesh=mesh)(
            tensors(mesh, batch_np(4, 1)))
    return dict(loss=float(loss), grads=_grads(net), state=_state(net))


def case_train32(mesh, state, batch, pad_to=None):
    """One teacher train step in float32 from `state` on a loader batch,
    padded to pad_to: loss, gradients, BatchNorm statistics."""
    net = model("teacher", 0, torch.float32, state)
    loss = make_train_step(net, make_optimizer(net), mesh=mesh)(
        batch_to_device(batch, "cpu", pad_to, mesh))
    return dict(loss=float(loss), grads=_grads(net), state=_state(net))


def case_kd64(mesh, kind):
    """One KD step at a global batch of 4 in float64: biDirection_loss_ht
    and attentiveImitationLoss (teacher -> lighttoken_res), the bridge step
    and the fast step (bifeat -> fg, att_iter_loss): loss, the student's
    (and the Bridge's) gradients and state."""
    fast = kind == "fast"
    teacher = model("bifeat" if fast else "teacher", 1)
    student = model("fg" if fast else "lighttoken_res", 0)
    opt = make_optimizer(student)
    batch = tensors(mesh, batch_np(4, 2))
    out = {}
    t_history = None
    if kind == "att":
        # the loaders' float32 batches, through a float32 teacher
        t_history = out["t_history"] = compute_teacher_history(
            model("teacher", 1, torch.float32),
            [loader_batch(4, s) for s in (3, 4)], mesh=mesh)
    with plain_in_float64():
        if kind in ("ht", "att"):
            name = ("biDirection_loss_ht" if kind == "ht"
                    else "attentiveImitationLoss")
            named = make_named_loss(name, KD_ARGS)
            step = make_distill_step(
                teacher, student, opt, mesh=mesh,
                loss_fn=lambda s, t, b: named(s, t, b, t_history=t_history))
        elif kind == "bridge":
            width = apply_frozen(teacher, batch)["feat1s"][3].shape[-1]
            bridge = Bridge(width, feat_ch=width, device="cpu",
                            generator=torch.Generator().manual_seed(2)
                            ).double()
            step = make_bridge_distill_step(
                teacher, student, bridge, opt, make_optimizer(bridge),
                mesh=mesh)
        else:
            step = make_fast_distill_step(teacher, student, opt, mesh=mesh)
        out["loss"] = float(step(batch))
    if kind == "bridge":
        out["bridge_grads"] = _grads(bridge)
        out["bridge_state"] = _state(bridge)
    out.update(grads=_grads(student), state=_state(student))
    return out


def case_replicate(mesh):
    """A module and a tensor seeded by the rank, after replicate: rank 0's
    values on every rank."""
    net = torch.nn.Linear(3, 2)
    with torch.no_grad():
        net.weight.fill_(float(mesh.rank + 1))
    t = torch.full((4,), float(mesh.rank + 7))
    replicate(mesh, net)
    replicate(mesh, [t])
    return dict(weight=net.weight.detach().clone(), t=t)


def case_identity(mesh):
    """Two teacher train steps and one KD step (teacher -> lighttoken_res,
    biDirection_loss_ht) in float32, on mesh and without one: every
    parameter and buffer after them, for both."""
    out = {}
    for label, m in (("mesh", mesh), ("none", None)):
        net = model("teacher", 0, torch.float32)
        step = make_train_step(net, make_optimizer(net), mesh=m)
        for seed in (5, 6):
            step(batch_to_device(loader_batch(2, seed), "cpu", mesh=m))
        student = model("lighttoken_res", 0, torch.float32)
        kd = make_distill_step(
            model("teacher", 1, torch.float32), student,
            make_optimizer(student), mesh=m,
            loss_fn=make_named_loss("biDirection_loss_ht", KD_ARGS))
        kd(batch_to_device(loader_batch(2, 7), "cpu", mesh=m))
        out[label] = dict(train=_state(net), kd=_state(student))
    return out


class Batches(list):
    """Loader batches with the attributes evaluate_model reads."""

    def __init__(self, batches, batch_size, pad_last=True):
        super().__init__(batches)
        self.batch_size, self.pad_last = batch_size, pad_last


def eval_loader(batch_size: int) -> Batches:
    """5 scenes at batch_size, the last batch padded (PAD_PATH rows)."""
    from kd_pointcloud_tpu_torch.data.loader import PAD_PATH

    out, scenes = [], []
    for i in range(5):              # in front of the camera: z in [6, 10]
        b = list(loader_batch(1, 20 + i))
        for j in range(4):
            b[j] = b[j] + np.float32([0.0, 0.0, 8.0])
        scenes.append(tuple(b))
    for i in range(0, 5, batch_size):
        part = scenes[i:i + batch_size]
        pad = batch_size - len(part)
        part = part + [part[-1]] * pad
        out.append(tuple(np.concatenate([p[j] for p in part])
                         for j in range(5))
                   + ([p[5][0] for p in part[:batch_size - pad]]
                      + [PAD_PATH] * pad,))
    return Batches(out, batch_size)


def case_eval(mesh, batch_size):
    """evaluate_model of a tiny teacher with non-trivial running statistics
    over eval_loader(batch_size); its log lines."""
    net = model("teacher", 0, torch.float32)
    rng = np.random.RandomState(5)
    with torch.no_grad():
        for k, v in net.state_dict().items():
            if ".running_" in k:
                v.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, v.shape)))
    lines = []

    class Log:
        def info(self, msg, *a):
            lines.append(msg % a)

    res = evaluate_model(net, eval_loader(batch_size), logger=Log(),
                         mesh=mesh)
    return dict(results=res, log=lines)


def case_train_teacher(mesh, tree, batch_size, per_device):
    """train_teacher at tiny_config on the synthetic tree, one epoch of 2
    steps: its history, run directory and the model's state after it."""
    saved = (dict(PRESETS), datasets.FlyingThings3DSubset.TRAIN_COUNT,
             datasets.FlyingThings3DSubset.VAL_COUNT)
    PRESETS["teacher"] = tiny_config("teacher")
    datasets.FlyingThings3DSubset.TRAIN_COUNT = tree["n_train"]
    datasets.FlyingThings3DSubset.VAL_COUNT = tree["n_val"]
    try:
        args = teacher_args(tree, f"w{mesh.size}", batch_size, per_device)
        net, _opt, best, run_dir, hist = port_exp.train_teacher(
            args, device="cpu", max_steps_per_epoch=2)
    finally:
        PRESETS.clear()
        PRESETS.update(saved[0])
        datasets.FlyingThings3DSubset.TRAIN_COUNT = saved[1]
        datasets.FlyingThings3DSubset.VAL_COUNT = saved[2]
    return dict(history=hist, best=best, run_dir=run_dir,
                state=_state(net))


def teacher_args(tree, tag, batch_size, per_device) -> Config:
    import yaml

    with open(tree["config"]) as fd:
        raw = yaml.safe_load(fd)
    raw.update(data_root=tree["root"], num_points=N, full=True, workers=0,
               experiment_dir=osp.join(tree["base"], tag), epochs=1,
               batch_size=batch_size, batch_size_per_device=per_device)
    return postprocess(Config(raw))


def case_mesh_step(mesh, cfg, n_points, batch, model_seed, batch_seed):
    """One train step of a cfg model (seeded by model_seed) in float32 on
    the mesh's device, on this rank's rows of `batch` seeded synthetic
    pairs of n_points: loss, launches, rows, gradients and buffers (on the
    CPU)."""
    from kd_pointcloud_tpu_torch.train.overfit import synthetic_batches

    net = BidPointFlowNet(cfg, device=mesh.device,
                          generator=torch.Generator().manual_seed(model_seed))
    step = make_train_step(net, make_optimizer(net), mesh=mesh)
    rows = shard_batch(mesh, synthetic_batches(1, batch, n_points,
                                               batch_seed, mesh.device)[0])
    kernels.reset_launches()
    loss = float(step(rows))
    return dict(loss=loss, launches=dict(kernels.LAUNCHES),
                rows=rows["pos1"].shape[0],
                grads={n: p.grad.cpu() for n, p in net.named_parameters()},
                buffers={n: b.cpu() for n, b in net.named_buffers()})


CASES = dict(bn=case_bn, train64=case_train64, train32=case_train32,
             kd64=case_kd64, eval=case_eval, train_teacher=case_train_teacher,
             replicate=case_replicate, identity=case_identity,
             mesh_step=case_mesh_step)


# ------------------------------------------------------------------ spawner

def _rank(rank, world, workdir, cases, device):
    torch.set_num_threads(1)
    results = {}
    try:
        mesh = init_mesh(rank, world, f"file://{workdir}/pg", device,
                         backend="gloo",
                         timeout=datetime.timedelta(seconds=TIMEOUT_S))
        for key, (name, kw) in cases.items():
            try:
                results[key] = ("ok", CASES[name](mesh, **kw))
            except Exception:                      # reported by the test
                results[key] = ("error", traceback.format_exc())
    except Exception:
        results["_init"] = ("error", traceback.format_exc())
    with open(osp.join(workdir, f"rank{rank}.pkl"), "wb") as fd:
        pickle.dump(results, fd)


def start(world: int, cases: dict, workdir: str,
          device: str = "cpu") -> tuple:
    """Spawn `world` gloo ranks on device (every rank on the one device)
    that run cases ({key: (case name, keyword inputs)});
    collect(start(...)) waits for them."""
    os.makedirs(workdir, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, workdir, cases,
                                             device))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, workdir


def collect(started: tuple) -> list:
    """Each rank's {key: ("ok", result) or ("error", traceback)}; every
    process is joined within TIMEOUT_S of the call, or killed."""
    procs, workdir = started
    world = len(procs)
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    if alive:
        raise TimeoutError(f"{len(alive)} rank(s) still running after "
                           f"{TIMEOUT_S} s")
    failed = [p.exitcode for p in procs if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"rank processes exited with {failed}")
    out = []
    for r in range(world):
        with open(osp.join(workdir, f"rank{r}.pkl"), "rb") as fd:
            out.append(pickle.load(fd))
    return out


def result(ranks: list, key: str) -> list:
    """Every rank's result of case key; raises with a rank's traceback."""
    for got in ranks:
        if "_init" in got:
            raise RuntimeError(got["_init"][1])
        status, value = got[key]
        if status != "ok":
            raise RuntimeError(value)
    return [got[key][1] for got in ranks]


def single(name: str, **kw):
    """The case on one device: a mesh of this process alone."""
    return CASES[name](make_mesh(n_devices=1, devices="cpu"), **kw)

