"""Guards of the port: what it, chip_smoke.py and the card tests import,
how it treats devices, that its card-only pieces (chip_smoke.py, the
ctypes kernel loader, the launchers) refuse cleanly on a machine without a
card, and the card tests' launch counts and drives
(tests/torch_port_checks.py) and chip_smoke.py's kernels line rehearsed on
the CPU."""

import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the port's test files import both frameworks)
import numpy as np
import pytest
import torch

import kd_pointcloud_tpu_torch
from kd_pointcloud_tpu_torch import device as port_device
from kd_pointcloud_tpu_torch.data import datasets
from kd_pointcloud_tpu_torch.models import (PRESETS, BidPointFlowNet,
                                            tiny_config)
from kd_pointcloud_tpu_torch.attic import cross_pool, fps_pruned
from kd_pointcloud_tpu_torch.ops import fps, kernels, knn, pool_fused
from kd_pointcloud_tpu_torch.train import overfit

import torch_port_checks as checks

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = Path(kd_pointcloud_tpu_torch.__file__).resolve().parent
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|kd_pointcloud_tpu|attic|torch\.utils\."
    r"cpp_extension)(\.|\s|$)", re.M)


# run on the card with --noconftest: tests/conftest.py imports JAX, which
# that machine does not have
CARD_FILES = ("test_torch_port_card_kernels.py",
              "test_torch_port_card_paths.py",
              "test_torch_port_eval_graph.py",
              "test_torch_port_knn_features.py",
              "test_torch_port_train_graph.py", "torch_port_checks.py",
              "torch_parallel_ranks.py")


def _port_files():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
        ROOT / "tests" / name for name in CARD_FILES]
    assert len(files) > 10
    for name in ("train/overfit.py", "train/loop.py", "train/state.py",
                 "losses/multiscale.py", "losses/kd.py", "models/bridge.py",
                 "models/torch_import.py", "train/checkpoints.py",
                 "train/distill.py", "train/distill_experiment.py",
                 "attic/fps_pruned.py", "attic/cross_pool.py",
                 "utils/config.py", "utils/logging.py", "data/native_io.py",
                 "data/transforms.py", "data/datasets.py", "data/loader.py",
                 "data/synthetic.py", "eval/geometry.py", "eval/metrics.py",
                 "eval/runner.py", "train/experiment.py", "cli/train.py",
                 "cli/evaluate.py", "cli/distill.py",
                 "cli/distill_bridge.py", "cli/fast_distill.py",
                 "losses/selfsup.py", "perf/profiling.py", "perf/trace.py",
                 "cli/profile.py", "utils/fixtures.py", "eval/licensing.py",
                 "data/preprocess/io.py", "data/preprocess/png16.py",
                 "data/preprocess/ft3d.py", "data/preprocess/kitti.py"):
        assert PACKAGE / name in files
    return files


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_no_jax_flax_or_jax_package(path):
    src = path.read_text()
    assert not FORBIDDEN.search(src), FORBIDDEN.search(src).group(0)
    assert "import cpp_extension" not in src
    if path.parent.name in ("data", "utils", "preprocess"):
        # loader workers fork after CUDA is up: they must not touch torch
        assert not re.search(r"^\s*(import|from)\s+torch", src, re.M)


def test_kernel_sources_are_plain_cuda():
    names = [p.name for p in kernels.sources()]
    assert names == ["cross_pool.cu", "fps.cu", "fps_pruned.cu", "knn.cu",
                     "knn_features.cu", "pool_fused.cu", "pool_fused_bwd.cu"]
    for p in kernels.sources():
        src = p.read_text()
        assert "torch/extension.h" not in src
        assert 'extern "C"' in src
        # what it replaces: a Pallas kernel, or (the feature kNN) none, in
        # place of the JAX package's XLA search
        if p.name == "knn_features.cu":
            assert ("Replaces no Pallas kernel" in src
                    and "kd_pointcloud_tpu/ops/knn.py" in src)
        else:
            assert re.search(r"(kd_pointcloud_tpu/ops/pallas|attic)/\w+\.py",
                             src)
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kernels.LINK_FLAGS
    assert kernels.BUILD_DIR.parts[-2:] == ("build", "kernels")


def test_model_without_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BidPointFlowNet(tiny_config("teacher"))
    with pytest.raises(RuntimeError):
        port_device.resolve_device("cuda:0")
    assert port_device.resolve_device("cpu") == torch.device("cpu")


def test_model_builds_on_cpu_when_asked():
    g = torch.Generator().manual_seed(0)
    model = BidPointFlowNet(tiny_config("teacher"), device="cpu", generator=g)
    assert next(model.parameters()).device == torch.device("cpu")
    again = BidPointFlowNet(tiny_config("teacher"), device="cpu",
                            generator=torch.Generator().manual_seed(0))
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_kernel_launchers_refuse_cpu_tensors():
    """A launcher never runs the plain version: a CPU tensor is an error."""
    x = torch.zeros(1, 64, 3)
    with pytest.raises(ValueError, match="CUDA"):
        fps._fps_cuda(x, 8)
    with pytest.raises(ValueError, match="CUDA"):
        knn._knn_cuda(3, x, x)
    u = torch.zeros(1, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        pool_fused._pool_cuda(u, torch.zeros(1, 8, 4, dtype=torch.int32), u,
                              torch.zeros(32, 32), torch.zeros(32))
    with pytest.raises(ValueError, match="CUDA"):
        fps_pruned._fps_pruned_cuda(torch.zeros(1, 1024, 3), 8)
    with pytest.raises(ValueError, match="CUDA"):
        cross_pool._cross_pool_cuda(u, u, torch.zeros(1, 8, 4,
                                                      dtype=torch.int32),
                                    [torch.zeros(32, 32)], [torch.zeros(32)])


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 64, 3, device="meta")
    with pytest.raises(ValueError):
        fps.furthest_point_sample(x, 8)
    with pytest.raises(ValueError):
        knn.knn_point(3, x, x)
    with pytest.raises(ValueError):
        pool_fused.pool_mlp_max(x, x.int(), x, x[0], x[0, 0])


def test_pool_kernel_backward_raises():
    """The backward kernel's launcher refuses CPU tensors, inside autograd's
    backward too: no plain fallback on the way back."""
    u = torch.zeros(1, 8, 32)
    idx = torch.zeros(1, 8, 4, dtype=torch.int32)
    args = (u, idx, u, torch.zeros(32, 32), torch.zeros(32))
    with pytest.raises(ValueError, match="CUDA"):
        pool_fused._pool_bwd_cuda(*args, torch.zeros(1, 8, 32))

    class Ctx:
        saved_tensors = args
        needs_input_grad = (True, False, True, True, True)

    with pytest.raises(ValueError, match="CUDA"):
        pool_fused._PoolFunction.backward(Ctx, torch.zeros(1, 8, 32))


def test_launch_counters_start_and_reset():
    kernels.LAUNCHES["knn"] += 2
    kernels.reset_launches()
    assert kernels.LAUNCHES == {"fps": 0, "knn": 0, "pool": 0, "pool_bwd": 0,
                                "fps_pruned": 0, "cross_pool": 0,
                                "knn_features": 0}


def test_launch_counts_by_width(monkeypatch):
    """launch() counts every launch under the kernel's name and, when the
    wrapper gives one, under its channel width; reset clears both."""
    class Lib:
        @staticmethod
        def kdpc_pool(*args):
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(kernels, "lib", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream)
    kernels.reset_launches()
    for width in (16, 32, 16):
        kernels.launch("pool", 0, width=width)
    kernels.launch("pool", 0)
    assert kernels.LAUNCHES["pool"] == 4
    assert kernels.WIDTH_LAUNCHES == {"pool C=16": 2, "pool C=32": 1}
    kernels.reset_launches()
    assert kernels.LAUNCHES["pool"] == 0 and kernels.WIDTH_LAUNCHES == {}


def test_train_entry_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        overfit.main(["--tiny", "--steps", "1"])


def test_train_entry_runs_on_cpu_without_jax():
    """python -m kd_pointcloud_tpu_torch.train.overfit --device cpu, with
    jax, flax and the JAX package made unimportable."""
    code = ("import runpy, sys\n"
            "for m in ('jax', 'flax', 'kd_pointcloud_tpu'):\n"
            "    sys.modules[m] = None\n"
            "sys.argv = ['overfit', '--device', 'cpu', '--tiny', '--points',"
            " '256', '--batch', '1', '--steps', '2']\n"
            "runpy.run_module('kd_pointcloud_tpu_torch.train.overfit',"
            " run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["device"] == "cpu" and summary["steps"] == 2
    assert np.isfinite(summary["loss_last"])


# each CUDA source and the JAX kernel it stands for (file:line of its
# pl.pallas_call; the feature kNN replaces the JAX package's XLA search)
KERNEL_SOURCES = {
    "fps": ("fps.cu", "kd_pointcloud_tpu/ops/pallas/fps_pallas.py:212"),
    "knn": ("knn.cu", "kd_pointcloud_tpu/ops/pallas/knn_fused.py:319"),
    "pool": ("pool_fused.cu",
             "kd_pointcloud_tpu/ops/pallas/pool_fused.py:173"),
    "pool_bwd": ("pool_fused_bwd.cu",
                 "kd_pointcloud_tpu/ops/pallas/pool_fused.py:269"),
    "fps_pruned": ("fps_pruned.cu", "attic/fps_pruned.py:329"),
    "cross_pool": ("cross_pool.cu", "attic/cross_pool.py:90"),
    "knn_features": ("knn_features.cu", "kd_pointcloud_tpu/ops/knn.py:142"),
}


@pytest.mark.parametrize("name", sorted(KERNEL_SOURCES))
def test_kernel_source_stands_for_a_jax_kernel(name):
    assert set(KERNEL_SOURCES) == set(kernels.LAUNCHES)
    source, replaces = KERNEL_SOURCES[name]
    path, line = replaces.split(":")
    assert path in (kernels.CSRC / source).read_text()
    want = ("def knn_point_dist(" if name == "knn_features"
            else "pl.pallas_call")
    assert want in (ROOT / path).read_text().splitlines()[int(line) - 1]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_runs_every_card_file():
    """chip_smoke.py runs each test file that holds a card test, and each
    of those imports no JAX (CARD_FILES above)."""
    mod = _load_chip_smoke()
    holding = {f"tests/{p.name}" for p in (ROOT / "tests").glob("*.py")
               if re.search(r"^@pytest\.mark\.card$", p.read_text(), re.M)}
    assert set(mod.CARD_FILES) == holding
    assert {f.split("/")[1] for f in mod.CARD_FILES} <= set(CARD_FILES)


def test_chip_smoke_fails_without_a_card(monkeypatch):
    """Without a card it exits non-zero before it runs a test."""
    mod = _load_chip_smoke()

    def run(_args):
        raise AssertionError("the card tests ran without a card")
    monkeypatch.setattr(pytest, "main", run)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main() == 1


@pytest.mark.parametrize("device_name, kernel", [
    ("void fps_kernel<4>(float const*, int, int, int, int*)", "fps"),
    ("void knn_kernel<32, 2>(float const*, float const*, int)", "knn"),
    ("void knn_features_kernel<64, 128>(float const*, int*)",
     "knn_features"),
    ("void pool_kernel<64, 8>(float const*, int const*, float*)", "pool"),
    ("void pool_bwd_kernel<128>(float const*, float*)", "pool_bwd"),
    ("void pool_bwd_mask_kernel<16>(float const*, int*)", "pool_bwd"),
    ("_Z11pool_kernelILi64ELi8EEvPKfPKiS1_", "pool"),
    ("void cross_pool_kernel<64>(float const*, float*)", None),
    ("void fps_pruned_kernel<2>(float const*, int*)", None),
    ("void at::native::vectorized_elementwise_kernel<4>(int)", None),
    ("ampere_sgemm_128x64_nn", None)])
def test_chip_smoke_names_each_kernel_apart(device_name, kernel):
    """The kernels line reads each path kernel's device time by its device
    name: the pool's backward is two kernels, and the attic's kernels and
    PyTorch's own are none of the path's."""
    assert _load_chip_smoke().kernel_name(device_name) == kernel


def test_chip_smoke_kernel_rows_on_cpu(monkeypatch):
    """The kernels line's rows, from the plain versions at tiny_config on
    the CPU: the calls of each KD step are its launches on the card (the
    pool's backward is autograd's here), each bound lies between the
    larger of the step's totals over the peaks and their sum, and no
    device time is read off the card."""
    from benchmark.work import PEAK_BYTES, PEAK_FLOPS

    mod = _load_chip_smoke()
    rows = mod.kernel_rows("cpu", tiny_config, batch=2, n_points=256)
    for path in mod.KD_PATHS:
        t_name, s_name = checks.KD_PATHS[path]
        want = checks.distill_launches(PRESETS[t_name], PRESETS[s_name])
        got = {r["kernel"]: r for r in rows if r["path"] == path}
        assert {k: r["launches"] for k, r in got.items()} == {
            k: n for k, n in want.items() if n and k != "pool_bwd"}
        run, _ = _step(path)
        with kernels.counting() as count:
            run()
        for name, r in got.items():
            ops = count.ops[name] / PEAK_FLOPS * 1e3
            nbytes = count.bytes[name] / PEAK_BYTES * 1e3
            assert max(ops, nbytes) <= r["bound_ms"] * (1 + 1e-9)
            assert r["bound_ms"] <= (ops + nbytes) * (1 + 1e-9)
            assert r["device_ms"] is None and r["roofline_pct"] is None


def test_card_checks_launch_counts():
    """The launches the card tests hold each path to, from the wiring."""
    zero = {"fps_pruned": 0, "cross_pool": 0, "knn_features": 0}
    assert checks.PER_FORWARD == {"fps": 1, "knn": 19, "pool": 12,
                                  "pool_bwd": 0, **zero}
    assert checks.PER_TRAIN_STEP == {"fps": 1, "knn": 19, "pool": 12,
                                     "pool_bwd": 12, **zero}
    assert checks.PER_KD_STEP == {"fps": 2, "knn": 38, "pool": 24,
                                  "pool_bwd": 12, **zero}
    assert checks.PER_SELFSUP_STEP == {"fps": 1, "knn": 35, "pool": 12,
                                       "pool_bwd": 12, **zero}
    for per in (checks.PER_FORWARD, checks.PER_TRAIN_STEP,
                checks.PER_KD_STEP, checks.PER_SELFSUP_STEP):
        assert set(per) == set(kernels.LAUNCHES)
    assert checks.forward_launches(PRESETS["teacher"]) == checks.PER_FORWARD
    for student in ("lighttoken_res", "student"):
        assert checks.distill_launches(PRESETS["teacher"],
                                       PRESETS[student]) == checks.PER_KD_STEP
    assert checks.distill_launches(PRESETS["bifeat"], PRESETS["fg"]) == dict(
        checks.PER_KD_STEP, knn=49, pool=33, knn_features=8)
    # a student KD step launches the pool pair at C = 16 at the l0 cross
    # layer's three pools, forward and backward
    assert checks.STUDENT_C16 == {"pool C=16": 3, "pool_bwd C=16": 3}
    assert PRESETS["student"].level_channels[0] == 16


def _tiny(name, seed=0):
    return checks.model(tiny_config(name), seed, "cpu")


def _tiny_batch(b=2):
    return overfit.synthetic_batches(1, b, 256, 3, "cpu")[0]


def _step(path):
    """fn() running one step of path through the plain versions at
    tiny_config, and the launches it makes on the card."""
    from kd_pointcloud_tpu_torch import losses
    from kd_pointcloud_tpu_torch.eval import make_eval_forward
    from kd_pointcloud_tpu_torch.train import make_optimizer, make_train_step

    batch = _tiny_batch()
    inputs = [batch[k] for k in ("pos1", "pos2", "norm1", "norm2")]
    if path == "eval":
        fwd = make_eval_forward(_tiny("teacher"))
        return lambda: fwd(*inputs), checks.PER_FORWARD
    if path == "train":
        net = _tiny("teacher")
        step = make_train_step(net, make_optimizer(net))
        return lambda: step(batch), checks.PER_TRAIN_STEP
    if path == "selfsup":
        net = _tiny("student").train()

        def selfsup():
            out = net(*inputs)
            losses.multi_scale_chamfer_smooth_curvature(
                out["pc1"], out["pc2"], out["flows"])[0].backward()
        return selfsup, checks.PER_SELFSUP_STEP
    t_name, s_name = checks.KD_PATHS[path]
    step = checks.kd_step(path, _tiny(t_name, checks.TEACHER_SEED),
                          _tiny(s_name, checks.STUDENT_SEED))
    return lambda: step(batch), checks.distill_launches(
        PRESETS[t_name], PRESETS[s_name])


@pytest.mark.parametrize("path", ["eval", "train", "kd", "student_kd",
                                  "fast_kd", "selfsup"])
def test_path_kernel_calls_counted_on_cpu(path, monkeypatch):
    """Each path's calls of the plain versions, counted by
    kernels.counting() at tiny_config (the pool backward's as the pool
    calls autograd differentiates), are the launches the card tests hold
    the same path to."""
    differentiated = []
    plain = pool_fused.pool_plain

    def pool(u, idx, v, weight, bias):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (u, v, weight, bias)):
            differentiated.append(1)
        return plain(u, idx, v, weight, bias)

    monkeypatch.setattr(pool_fused, "pool_plain", pool)
    run, want = _step(path)
    with kernels.counting() as count:
        run()
    got = dict(count.calls, pool_bwd=len(differentiated))
    assert {n: c for n, c in got.items() if c} == {
        n: c for n, c in want.items() if c}


@pytest.mark.parametrize("name", ["teacher", "student", "serving_v3",
                                  "student2", "non_linear", "bifeat", "fg",
                                  "no_cross", "vote"])
def test_forward_launches_follow_the_wiring(name):
    """forward_launches, which the card tests hold each preset's eval
    forward to, counts what the forward calls: the plain versions' calls
    at tiny_config."""
    from kd_pointcloud_tpu_torch.eval import make_eval_forward

    batch = _tiny_batch(1)
    fwd = make_eval_forward(_tiny(name))
    with kernels.counting() as count:
        fwd(*(batch[k] for k in ("pos1", "pos2", "norm1", "norm2")))
    want = checks.forward_launches(PRESETS[name])
    assert count.calls == {n: c for n, c in want.items() if c}
    assert want == checks.forward_launches(tiny_config(name))


def test_card_checks_tie_case_and_zero_gradient_leaves():
    """The card tests' crafted tie case ties exactly on the CPU's plain
    version, and their zero-gradient rule picks the 8 Dense biases that feed
    the flow heads' BatchNorms."""
    rng = np.random.RandomState(0)
    u = torch.from_numpy(rng.standard_normal((2, 20, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 16, 32)).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 20, (2, 16, 8)).astype(np.int32))
    w, b = torch.eye(32), torch.ones(32)
    u, idx, v, w, b, _ = checks.tie_case(u, idx, v, w, b, v)
    assert torch.equal(u[:, 0], u[:, 1]) and float(b[::4].abs().max()) == 0
    h = pool_fused.group_points(u, idx) + v[:, :, None, :]
    assert float(h[:, 4:8].abs().max()) == 0.0
    ct = torch.zeros(2, 16, 32)
    ct[:, :4] = 1.0                     # the two-row ties only
    d_u = checks.pool_bwd_plain(u, idx, v, w, b, ct)[0]
    assert float(d_u[:, 0].abs().max()) > 0
    torch.testing.assert_close(d_u[:, 0], d_u[:, 1], rtol=0, atol=0)
    model = BidPointFlowNet(tiny_config("teacher"), device="cpu")
    zero = [n for n, _ in model.named_parameters()
            if checks.zero_gradient_leaf(n)]
    assert len(zero) == 8 and all(n.endswith("dense.bias") for n in zero)


def _kernel_work(name, args):
    return kernels.kernel_work(name, *args)


def test_kernel_work_counts():
    """The pool backward's operations count d_h0, d_w and d_bias only at
    the max mask: every neighbour when all tie, one a (query, output
    channel) when none do."""
    work = _kernel_work
    B, N1, N2, K, C = 3, 50, 100, 32, 32
    u = torch.zeros(B, N2, C)
    idx = torch.zeros(B, N1, K, dtype=torch.int32)
    v = torch.zeros(B, N1, C)
    args = (u, idx, v, torch.zeros(C, C), torch.zeros(C))
    ops, nbytes = work("pool", args)
    assert ops == B * N1 * K * (2 * C * C + 5 * C)
    dense = B * N1 * K * (2 * C * C + 10 * C)
    ops_b, bytes_b = work("pool_bwd", args + (v,))
    assert ops_b == dense + B * N1 * K * C * (4 * C + 1)
    assert bytes_b > nbytes
    rng = np.random.default_rng(0)
    untied = (torch.from_numpy(rng.standard_normal((B, N2, C), np.float32)),
              torch.from_numpy(rng.permuted(
                  np.tile(np.arange(N2, dtype=np.int32), (B, N1, 1)),
                  axis=2)[..., :K].copy()),
              v, torch.from_numpy(rng.standard_normal((C, C), np.float32)),
              torch.zeros(C))
    ops_u, _ = work("pool_bwd", untied + (v,))
    assert ops_u == dense + B * N1 * C * (4 * C + 1)


def test_kernel_work_counts_attic_kernels():
    """Pruned FPS counts its sphere tests every round and FPS's work only
    at the sub-block updates the data needed; the cross pool at L = 1
    counts what the pool counts, and each further layer 2 C^2 + 2 C a
    (query, neighbour) more."""
    work = _kernel_work
    B, N, m = 2, 8192, 2048
    xyz = torch.zeros(B, N, 3)
    full, nbytes = work("fps", (xyz, m))
    ops0, bytes0 = work("fps_pruned", (xyz, m, 0))
    assert bytes0 == nbytes and ops0 == B * (m - 1) * (N // 128) * 15
    ops_all, _ = work("fps_pruned", (xyz, m, B * (m - 1) * (N // 128)))
    assert ops_all == ops0 + full
    Bp, N1, N2, K, C = 2, 40, 50, 16, 64
    u, v = torch.zeros(Bp, N2, C), torch.zeros(Bp, N1, C)
    idx = torch.zeros(Bp, N1, K, dtype=torch.int32)
    w, b = torch.zeros(C, C), torch.zeros(C)
    ops1, bytes1 = work("cross_pool", (u, v, idx, [w], [b]))
    assert (ops1, bytes1) == work("pool", (u, idx, v, w, b))
    ops2, bytes2 = work("cross_pool", (u, v, idx, [w, w], [b, b]))
    assert ops2 - ops1 == Bp * N1 * K * (2 * C * C + 2 * C)
    assert bytes2 - bytes1 == (C * C + C) * 4


def test_card_workflow_runs_on_cpu(monkeypatch):
    """The card tests' workflow end to end on the CPU at tiny_config
    and small trees: the five cli entries from the shipped YAMLs (loader
    pools of 2 workers), the resume from the best checkpoint, evaluate, and
    the device and host eval paths held against each other; the plain
    versions launch no kernel."""
    for name in ("teacher", "lighttoken_res", "bifeat", "fg"):
        monkeypatch.setitem(PRESETS, name, tiny_config(name))
    out = checks.workflow("cpu", 256, ft3d=dict(train=8, val=4, points=300),
                       kitti=dict(mapped=(0, 1, 5), points=500), steps=1)
    assert list(out["runs"]) == [
        "train", "resume", "evaluate", "eval KITTI device",
        "eval KITTI host", "eval FT3D val device", "eval FT3D val host",
        "distill", "distill_bridge", "fast_distill"]
    assert not any(any(r["launches"].values())
                   for r in out["runs"].values())
    assert [h["epoch"] for h in out["train"]["epochs"]] == [0, 1]
    assert len(out["train"]["resume"]) == 1
    assert set(out["evaluate"]["metrics"]) == {
        "epe3d", "acc3ds", "acc3dr", "outliers", "epe2d", "acc2d", "loss"}
    for label in ("distill", "distill_bridge", "fast_distill"):
        assert out["distill"][label][0]["checkpoint"]
    assert datasets.FlyingThings3DSubset.TRAIN_COUNT == 19640   # restored


def test_card_mesh_checks_run_on_cpu(tmp_path):
    """The card tests' mesh checks on the CPU at tiny_config and 256 points:
    (a) a gloo world of one rank in this process against the no-mesh step,
    (b) two gloo ranks spawned by tests/torch_parallel_ranks.py against
    one step over their global batch, under the card's gates; the plain
    versions launch no kernel."""
    out = checks.mesh_phase(str(tmp_path), tiny_config("teacher"), "cpu", 256)
    zero = dict.fromkeys(kernels.LAUNCHES, 0)
    assert out["launches"] == zero
    assert out["rank_launches"] == [zero] * checks.MESH_RANKS


def test_card_preprocess_checks_run_on_cpu(monkeypatch):
    """The card tests' raw-frames-to-eval drive on the CPU at tiny_config
    and small frames: both preprocessors' entries (one worker each), then
    the FT3D and KITTI evals, each scene's points as written and the six
    metrics and loss finite; the plain versions launch no kernel."""
    monkeypatch.setitem(PRESETS, "teacher", tiny_config("teacher"))
    out = checks.preprocess_eval(
        "cpu", 256, ft3d=dict(train=1, val=2, height=30, width=40),
        kitti=dict(frames=(0, 3), height=25, width=50), workers=1)
    assert list(out["scenes"]) == ["FT3D val", "KITTI"]
    assert len(out["scenes"]["FT3D val"]) == 2
    assert len(out["scenes"]["KITTI"]) == 2
    assert all(n > 256 for v in out["scenes"].values() for n in v)
    for label in out["metrics"]:
        assert set(out["metrics"][label]) == {
            "epe3d", "acc3ds", "acc3dr", "outliers", "epe2d", "acc2d",
            "loss"}
        assert not any(out["launches"][label].values())
