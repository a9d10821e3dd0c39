"""The port's data-parallel layer (kd_pointcloud_tpu_torch/parallel/) on
2-rank gloo groups on the CPU, against the single-device result over the
global batch and against the JAX package's plans.

The ranks are spawned processes (tests/torch_parallel_ranks.py, which
imports no JAX), joined in a gloo group through a file under tmp_path; each
case runs there on a 2-rank mesh and here on a mesh of this process alone,
over the same global batch:

- the plans (resolve_global_batch, data_parallel_plan,
  data_parallel_sharding) case for case against JAX's on 1, 2, 3 and 8
  devices of the suite's virtual CPU mesh, with their log lines; the cost
  model against JAX's formulas at equal constants; shard_batch against
  JAX's batch sharding; replicate;
- _BatchNorm: output rows, input and parameter gradients and running
  statistics over the global rows (float64, 1e-12 relative);
- one tiny teacher train step at global batch 4: loss, every gradient leaf
  and the BatchNorm statistics (float64, 1e-10 relative);
- one KD step each of biDirection_loss_ht, attentiveImitationLoss (with its
  t_history), the bridge step and the fast step's att_iter_loss (float64,
  1e-10 relative; t_history equal);
- evaluate_model(mesh=...) within 1e-6 relative, and its fallback with its
  log line;
- train_teacher for one epoch of 2 steps at batch_size_per_device 1 on 2
  ranks against batch_size 2 on one device, rank 0 alone writing the
  checkpoint; cli.train and cli.evaluate (data_parallel) under torchrun
  --nproc_per_node=2 --standalone (a free port) with --device cpu;
- the world-1 identity: on a mesh of one rank, with a process group and
  without, two train steps and one KD step leave every parameter and buffer
  bit-equal to the steps without a mesh.

Float64 cases differ from one device only in summation order (BatchNorm's
moments as sums over ranks, the gradient as the mean of the ranks'
shares); a gradient leaf whose true value is 0 (the Dense bias before a
flow head's BatchNorm, which the batch mean removes) is rounding noise on
both sides and is held below 1e-12 of the largest gradient instead.
"""

import functools
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from kd_pointcloud_tpu.parallel import cost_model as jax_cost
from kd_pointcloud_tpu.parallel import mesh as jax_mesh
from kd_pointcloud_tpu_torch.data import synthetic
from kd_pointcloud_tpu_torch.parallel import (Mesh, cost_model,
                                              data_parallel_plan,
                                              data_parallel_sharding,
                                              make_mesh,
                                              resolve_global_batch,
                                              shard_batch)

import torch_parallel_ranks as ranks

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(ROOT, "kd_pointcloud_tpu", "configs",
                  "train_teacher_ft3d.yaml")
KD_KINDS = ("ht", "att", "bridge", "fast")
EVAL_BATCHES = (2, 3)      # divides over 2 ranks; does not: the fallback


class _Log:
    """A logger that records (level, message) lines."""

    def __init__(self):
        self.lines = []

    def info(self, msg, *a):
        self.lines.append(("info", msg % a))

    def warning(self, msg, *a):
        self.lines.append(("warning", msg % a))


def _zero_gradient_leaf(name):
    # the Dense bias feeding a flow head's BatchNorm: the batch mean
    # removes it, so its true gradient is 0 and any value is rounding noise
    return name.startswith("flow") and ".convs." in name \
        and name.endswith("dense.bias")


def _assert_close(got, want, rtol, what):
    err = float((got.double() - want.double()).abs().max())
    assert err <= rtol * max(float(want.double().abs().max()), 1e-300), \
        (what, err)


def _assert_grads(got, want, rtol=1e-10):
    assert set(got) == set(want)
    top = max(float(g.abs().max()) for g in want.values())
    for name, w in want.items():
        if _zero_gradient_leaf(name):
            assert max(float(got[name].abs().max()),
                       float(w.abs().max())) <= 1e-12 * top, name
        else:
            _assert_close(got[name], w, rtol, name)


def _assert_stats(got, want, rtol=1e-10):
    stats = [k for k in want if ".running_" in k]
    assert stats
    for k in stats:
        _assert_close(got[k], want[k], rtol, k)


# ------------------------------------------------------------ the spawn

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("dp")
    root = synthetic.write_ft3d_tree(str(base / "ft3d"), 4, 3, 320, seed=3)
    return dict(base=str(base), root=root, n_train=4, n_val=3,
                config=CONFIG)


RUNNER = """import runpy, sys
for m in ("jax", "flax", "kd_pointcloud_tpu"):
    sys.modules[m] = None
from kd_pointcloud_tpu_torch.data import datasets
from kd_pointcloud_tpu_torch.models import PRESETS, tiny_config
PRESETS["teacher"] = tiny_config("teacher")
cls = datasets.FlyingThings3DSubset
cls.TRAIN_COUNT, cls.VAL_COUNT = {n_train}, {n_val}
for entry, path in (("train", {train!r}), ("evaluate", {evaluate!r})):
    sys.argv = [entry, path, "--device", "cpu"]
    print("ENTRY", entry, flush=True)
    runpy.run_module("kd_pointcloud_tpu_torch.cli." + entry,
                     run_name="__main__")
"""


@pytest.fixture(scope="module")
def torchrun(tree):
    """cli.train (batch_size_per_device 1) then cli.evaluate (data_parallel,
    batch 2), as torchrun --nproc_per_node=2 runs them with --device cpu,
    at tiny_config on the synthetic tree; started, not waited for."""
    base = tree["base"]
    with open(CONFIG) as fd:
        train = yaml.safe_load(fd)
    train.update(data_root=tree["root"], num_points=ranks.N, full=True,
                 workers=0, batch_size=1, batch_size_per_device=True,
                 epochs=1, experiment_dir=osp.join(base, "torchrun"))
    evaluate = dict(train, batch_size=2, data_parallel=True,
                    pretrain=None)
    paths = {}
    for name, cfg in (("train", train), ("evaluate", evaluate)):
        paths[name] = osp.join(base, f"torchrun_{name}.yaml")
        with open(paths[name], "w") as fd:
            yaml.safe_dump(cfg, fd)
    runner = osp.join(base, "torchrun_entries.py")
    with open(runner, "w") as fd:
        fd.write(RUNNER.format(n_train=tree["n_train"], n_val=tree["n_val"],
                               **paths))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([ROOT, os.environ.get(
                   "PYTHONPATH", "")]))
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", runner], cwd=base, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def spawned(tree, torchrun, tmp_path_factory):
    """Every 2-rank case in one gloo group, and the world-1 identity case in
    a group of one; started first (after the torchrun entries), so that the
    single-device runs here overlap them."""
    cases = dict(bn=("bn", {}), train64=("train64", {}),
                 replicate=("replicate", {}),
                 teacher=("train_teacher", dict(tree=tree, batch_size=1,
                                                per_device=True)))
    cases.update({f"kd_{k}": ("kd64", dict(kind=k)) for k in KD_KINDS})
    cases.update({f"eval_{b}": ("eval", dict(batch_size=b))
                  for b in EVAL_BATCHES})
    two = ranks.start(2, cases, str(tmp_path_factory.mktemp("pg2")))
    one = ranks.start(1, dict(identity=("identity", {})),
                      str(tmp_path_factory.mktemp("pg1")))
    return dict(two=two, one=one, cases=cases)


@pytest.fixture(scope="module")
def two(spawned):
    return ranks.collect(spawned["two"])


@pytest.fixture(scope="module")
def one(spawned):
    return ranks.collect(spawned["one"])


def _single(spawned, key):
    name, kw = spawned["cases"][key]
    return ranks.single(name, **kw)


# --------------------------------------------------------------- plans

@pytest.fixture
def jax_devices(monkeypatch):
    """JAX's default mesh cut to the first n devices of the virtual 8."""
    orig = jax_mesh.make_mesh

    def use(n):
        monkeypatch.setattr(jax_mesh, "make_mesh", lambda n_devices=None,
                            devices=None: orig(n if n_devices is None
                                               else n_devices, devices))
    return use


def _mesh(n):
    return Mesh(n, 0, torch.device("cpu"))


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("per_device", [False, True])
def test_resolve_global_batch_matches_jax(n, per_device):
    for bs in (1, 3, 8):
        assert resolve_global_batch(bs, per_device, n) == \
            jax_mesh.resolve_global_batch(bs, per_device, n)
    assert resolve_global_batch(3, True) == 3          # no process group


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("bs", [3, 8, 24])
def test_data_parallel_plans_match_jax(n, bs, jax_devices):
    jax_devices(n)
    logs = {side: _Log() for side in ("port", "jax")}
    _, j_sh, j_pad = jax_mesh.data_parallel_plan(bs, logs["jax"])
    mesh, p_sh, p_pad = data_parallel_plan(bs, logs["port"], _mesh(n))
    assert mesh.size == n and p_pad == j_pad
    assert (p_sh is None) == (j_sh is None)
    if p_sh is not None:
        assert p_sh.split and p_sh.mesh is mesh
    _, j_sh = jax_mesh.data_parallel_sharding(bs, logs["jax"])
    _, p_sh = data_parallel_sharding(bs, logs["port"], _mesh(n))
    assert (p_sh is None) == (j_sh is None)
    assert logs["port"].lines == logs["jax"].lines


def test_make_mesh_without_a_process_group():
    mesh = make_mesh(devices="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.is_main and make_mesh(1, ["cpu"]).device.type == "cpu"
    with pytest.raises(ValueError):
        make_mesh(2)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_cost_model_matches_jax(n, monkeypatch):
    """The port's formulas at the H100 constants against JAX's at the same
    constants; no TPU constant in the port's module."""
    bw, links = cost_model.H100_NVLINK_ONEWAY_BW, cost_model.H100_RING_LINKS
    monkeypatch.setattr(jax_cost, "allreduce_ms", functools.partial(
        jax_cost.allreduce_ms, link_bw=bw, ring_links=links))
    for nbytes in (4e6, 3.2e7):
        assert cost_model.allreduce_ms(nbytes, n) == \
            jax_cost.allreduce_ms(nbytes, n)
        assert cost_model.dp_step_model(n, nbytes, 90.0) == \
            jax_cost.dp_step_model(n, nbytes, 90.0)
    assert bw == 4.5e11 and not any(
        "V5E" in k or "ICI" in k for k in vars(cost_model))
    net = ranks.model("teacher", 0, torch.float32)
    assert cost_model.param_bytes_of(net) == \
        jax_cost.param_bytes_of([p.detach().numpy() for p in
                                 net.parameters()])


def test_shard_batch_matches_jax_sharding(jax_devices):
    """Rank r's rows are the rows JAX's batch sharding puts on device r,
    for a batch dict and a loader batch (its paths too)."""
    jax_devices(2)
    batch = ranks.batch_np(4, 0)
    jm = jax_mesh.make_mesh()
    sharded = jax_mesh.shard_batch(jm, batch)
    loader = ranks.loader_batch(4, 0)
    for r in range(2):
        mesh = Mesh(2, r, torch.device("cpu"))
        got = shard_batch(mesh, batch)
        for k, v in sharded.items():
            shard = [s for s in v.addressable_shards
                     if s.device == jm.devices.flat[r]][0]
            np.testing.assert_array_equal(got[k], np.asarray(shard.data))
        part = shard_batch(mesh, loader)
        assert part[5] == loader[5][2 * r:2 * r + 2]
        np.testing.assert_array_equal(part[0], loader[0][2 * r:2 * r + 2])
    with pytest.raises(ValueError):
        shard_batch(Mesh(2, 0, torch.device("cpu")), batch["pos1"][:3])


def test_replicate_broadcasts_rank_0(two):
    for got in ranks.result(two, "replicate"):
        assert torch.equal(got["weight"], torch.ones(2, 3))
        assert torch.equal(got["t"], torch.full((4,), 7.0))


# ----------------------------------------------------------- BatchNorm

def test_batch_norm_takes_global_statistics(spawned, two):
    """Output rows, input-gradient rows and the parameter gradients summed
    over the ranks equal one rank's over the global rows; every rank holds
    the global running statistics."""
    want = _single(spawned, "bn")
    got = ranks.result(two, "bn")
    _assert_close(torch.cat([g["y"] for g in got]), want["y"], 1e-12, "y")
    _assert_close(torch.cat([g["x_grad"] for g in got]), want["x_grad"],
                  1e-12, "x_grad")
    for k in ("w_grad", "b_grad"):
        _assert_close(got[0][k] + got[1][k], want[k], 1e-12, k)
    for g in got:
        for k in ("mean", "var"):
            _assert_close(g[k], want[k], 1e-12, k)


# ----------------------------------------------------------- the steps

def test_train_step_equals_global_batch_float64(spawned, two):
    want = _single(spawned, "train64")
    for got in ranks.result(two, "train64"):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-12)
        _assert_grads(got["grads"], want["grads"])
        _assert_stats(got["state"], want["state"])


@pytest.mark.parametrize("kind", KD_KINDS)
def test_kd_step_equals_global_batch_float64(spawned, two, kind):
    want = _single(spawned, f"kd_{kind}")
    got = ranks.result(two, f"kd_{kind}")
    for g in got:
        assert g["loss"] == pytest.approx(want["loss"], rel=1e-12)
        _assert_grads(g["grads"], want["grads"])
        _assert_stats(g["state"], want["state"])
        if kind == "bridge":
            _assert_grads(g["bridge_grads"], want["bridge_grads"])
        if kind == "att":
            np.testing.assert_allclose(g["t_history"], want["t_history"],
                                       rtol=1e-6)
    # every rank took the same update
    for k, v in got[0]["state"].items():
        assert torch.equal(v, got[1]["state"][k]), k


@pytest.mark.parametrize("batch_size", EVAL_BATCHES)
def test_evaluate_model_on_a_mesh(spawned, two, batch_size):
    want = _single(spawned, f"eval_{batch_size}")
    for got in ranks.result(two, f"eval_{batch_size}"):
        assert list(got["results"]) == list(want["results"])
        for k, v in want["results"].items():
            assert got["results"][k] == pytest.approx(v, rel=1e-6,
                                                      abs=1e-12), k
        fell_back = any("falling back" in line for line in got["log"])
        assert fell_back == (batch_size % 2 != 0)
    assert 0.0 < want["results"]["epe2d"] < 1e3


def test_train_teacher_per_device_batch(spawned, two, tree):
    """batch_size_per_device 1 on 2 ranks is batch 2 on one device: the
    same mean train loss within 1e-5 relative (float32: BatchNorm moments
    and the gradient's sums in another order; measured 1.2e-7), eval EPE3D
    and eval loss within 2e-4 (measured 1.7e-5: Adam's first steps move
    each weight by about lr whatever its gradient's size, so elements whose
    gradient is rounding noise move apart by up to 2 lr), the same state
    on both ranks, one run directory, one log and a checkpoint from rank 0
    alone."""
    want = ranks.single("train_teacher", tree=tree, batch_size=2,
                        per_device=False)
    got = ranks.result(two, "teacher")
    assert got[0]["run_dir"] == got[1]["run_dir"]
    assert osp.dirname(got[0]["run_dir"]) == osp.join(tree["base"], "w2")
    for g in got:
        assert [h["steps"] for h in g["history"]] == [2]
        for key, rtol in (("loss", 1e-5), ("epe", 2e-4), ("eval_loss", 2e-4)):
            assert g["history"][0][key] == pytest.approx(
                want["history"][0][key], rel=rtol), key
    for k, v in got[0]["state"].items():
        assert torch.equal(v, got[1]["state"][k]), k
    ckpt = got[0]["history"][0]["checkpoint"]
    assert ckpt and osp.exists(ckpt)
    assert got[1]["history"][0]["checkpoint"] is None
    ckpts = osp.join(got[0]["run_dir"], "checkpoints")
    assert os.listdir(ckpts) == [osp.basename(ckpt)]
    assert os.listdir(osp.dirname(got[0]["run_dir"])) == \
        [osp.basename(got[0]["run_dir"])]
    log = osp.join(got[0]["run_dir"], "logs",
                   "train_PointConv_sceneflow.txt")
    assert open(log).read().count("PARAMETER") == 1


def test_torchrun_entries(torchrun, tree):
    """torchrun --nproc_per_node=2 of cli.train and cli.evaluate on the CPU:
    gloo, one epoch at batch_size_per_device 1, one run directory, one log
    and one checkpoint (rank 0's), and the data-parallel sweep printed once
    (rank 0)."""
    out, _ = torchrun.communicate(timeout=ranks.TIMEOUT_S)
    assert torchrun.returncode == 0, out[-3000:]
    base = osp.join(tree["base"], "torchrun")
    (run,) = os.listdir(base)
    assert len(os.listdir(osp.join(base, run, "checkpoints"))) == 1
    log = open(osp.join(base, run, "logs",
                        "train_PointConv_sceneflow.txt")).read()
    assert log.count("PARAMETER") == 1 and log.count("mean loss") == 1
    printed = out.split("ENTRY evaluate")[-1]
    for key in ("epe3d", "acc3ds", "acc3dr", "outliers", "epe2d", "acc2d",
                "loss"):
        lines = [line for line in printed.splitlines()
                 if line.startswith(f"{key}: ")]
        assert len(lines) == 1 and np.isfinite(float(lines[0].split()[1]))


# ------------------------------------------------------- world-1 identity

def _assert_identical(out):
    for part in ("train", "kd"):
        a, b = out["mesh"][part], out["none"][part]
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (part, k)


def test_world_1_with_a_process_group_is_bit_identical(one):
    _assert_identical(ranks.result(one, "identity")[0])


def test_world_1_without_a_process_group_is_bit_identical():
    mesh = make_mesh(devices="cpu")
    assert mesh.group is None and mesh.size == 1
    _assert_identical(ranks.CASES["identity"](mesh))
