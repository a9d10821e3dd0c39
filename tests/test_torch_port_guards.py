"""Guards of the port: what it imports, how it treats devices, and that its
card-only pieces (chip_smoke.py, the ctypes kernel loader) import and refuse
cleanly on a machine without a card."""

import importlib.util
import json
import re
import shutil
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

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = Path(kd_pointcloud_tpu_torch.__file__).resolve().parent
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|kd_pointcloud_tpu|attic|torch\.utils\."
    r"cpp_extension)(\.|\s|$)", re.M)


def _port_files():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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


def _kernel_work(name, args):
    return kernels.kernel_work(name, *args)


def test_chip_smoke_takes_its_work_counts_from_the_package():
    src = (ROOT / "chip_smoke.py").read_text()
    assert "kernel_work" in src and "def work(" not in src
    assert "def mask_entries(" not in src


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_imports_without_a_card():
    mod = _load_chip_smoke()
    zero = {"fps_pruned": 0, "cross_pool": 0, "knn_features": 0}
    assert mod.PER_FORWARD == {"fps": 1, "knn": 19, "pool": 12,
                               "pool_bwd": 0, **zero}
    assert mod.PER_TRAIN_STEP == {"fps": 1, "knn": 19, "pool": 12,
                                  "pool_bwd": 12, **zero}
    # the frozen teacher's forward adds no backward
    assert mod.PER_KD_STEP == {"fps": 2, "knn": 38, "pool": 24,
                               "pool_bwd": 12, **zero}
    for per in (mod.PER_FORWARD, mod.PER_TRAIN_STEP, mod.PER_KD_STEP):
        assert set(per) == set(kernels.LAUNCHES)
    # a student KD step launches the pool pair at C = 16 at the l0 cross
    # layer's three pools, forward and backward
    assert mod.STUDENT_C16 == {"pool C=16": 3, "pool_bwd C=16": 3}
    assert set(mod.KERNEL_META) == set(kernels.LAUNCHES)
    for name, meta in mod.KERNEL_META.items():
        assert (ROOT / meta["source"]).exists()
        path, line = meta["replaces"].split(":")
        # the feature kNN stands for the JAX package's XLA search
        want = ("def knn_point_dist(" if name == "knn_features"
                else "pl.pallas_call")
        assert want in (ROOT / path).read_text().splitlines()[int(line) - 1]


def test_chip_smoke_counts_unrecorded_launches_inside_the_forward():
    """The trace check reads the launches inside the traced forward's
    annotation: a lost record of the settle before it does not count, one
    inside it does, and the report names its place and op."""
    mod = _load_chip_smoke()

    def launch(ts, corr):
        return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                "tid": 1, "args": {"correlation": corr}}

    events = [
        {"cat": "user_annotation", "name": mod.TRACED_FORWARD, "ts": 100,
         "dur": 50, "tid": 1},
        {"cat": "cpu_op", "name": "aten::cat", "ts": 118, "dur": 5,
         "tid": 1},
        launch(10, 1), launch(110, 2), launch(120, 3), launch(140, 4),
        {"cat": "kernel", "name": "k", "args": {"correlation": 2}},
        {"cat": "kernel", "name": "k", "args": {"correlation": 4}},
    ]
    assert mod.unrecorded_launches(events) == 2
    assert mod.unrecorded_launches(events, mod.TRACED_FORWARD) == 1
    assert len(mod._launches(events, mod.TRACED_FORWARD)) == 3
    assert mod.unrecorded_detail(events, mod.TRACED_FORWARD) == \
        "#1 of 3 (cudaLaunchKernel, in aten::cat)"
    assert mod.unrecorded_launches(events, "no such annotation") == 0


def test_chip_smoke_ptxas_summary():
    text = ("ptxas info    : Compiling entry function "
            "'_ZN12_GLOBAL__N_110knn_kernelILi32EEEvPKfS2_iiPiPf' for "
            "'sm_90a'\n    0 bytes stack frame, 8 bytes spill stores, "
            "4 bytes spill loads\nptxas info    : Used 96 registers, "
            "16384 bytes smem, 400 bytes cmem[0]\n")
    assert _load_chip_smoke().ptxas_summary(text) == [
        "knn_kernel<32>: 96 registers, 16384 B static smem, "
        "spill stores 8 B, loads 4 B"]


@pytest.mark.parametrize("kernel", ["fps_kernel", "fps_pruned_kernel",
                                    "knn_kernel", "pool_kernel",
                                    "pool_bwd_kernel", "pool_bwd_mask_kernel",
                                    "cross_pool_kernel"])
def test_chip_smoke_names_each_kernel_apart(kernel):
    """No kernel's name is read as the tail of another's, in ptxas's
    mangled names and in the profiler's demangled ones."""
    mod = _load_chip_smoke()
    name = kernel[:-len("_kernel")]
    mangled = (f"_ZN12_GLOBAL__N_1{len(kernel)}{kernel}ILi64EEEvPKfPKiS2_"
               "S2_S2_iiiiPf")
    text = (f"ptxas info    : Compiling entry function '{mangled}' for "
            "'sm_90a'\nptxas info    : Used 40 registers, 0 bytes smem\n")
    assert mod.ptxas_summary(text) == [
        f"{kernel}<64>: 40 registers, 0 B static smem, "]
    demangled = (f"void (anonymous namespace)::{kernel}<64>(float const*, "
                 "int const*, float*)")
    assert re.search(mod.KERNEL_RE + "<", demangled).group(1) == name


def test_chip_smoke_tie_case_and_zero_gradient_leaves():
    """The smoke run's crafted tie case ties exactly on the CPU's plain
    version, and its zero-gradient rule picks the 8 Dense biases that feed
    the flow heads' BatchNorms."""
    mod = _load_chip_smoke()
    rng = np.random.RandomState(0)
    u = torch.from_numpy(rng.standard_normal((2, 20, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 16, 32)).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 20, (2, 16, 8)).astype(np.int32))
    w, b = torch.eye(32), torch.ones(32)
    u, idx, v, w, b, _ = mod.tie_case(u, idx, v, w, b, v)
    assert torch.equal(u[:, 0], u[:, 1]) and float(b[::4].abs().max()) == 0
    h = pool_fused.group_points(u, idx) + v[:, :, None, :]
    assert float(h[:, 4:8].abs().max()) == 0.0
    ct = torch.zeros(2, 16, 32)
    ct[:, :4] = 1.0                     # the two-row ties only
    d_u = mod.pool_bwd_plain(u, idx, v, w, b, ct)[0]
    assert float(d_u[:, 0].abs().max()) > 0
    torch.testing.assert_close(d_u[:, 0], d_u[:, 1], rtol=0, atol=0)
    model = BidPointFlowNet(tiny_config("teacher"), device="cpu")
    zero = [n for n, _ in model.named_parameters()
            if mod.zero_gradient_leaf(n)]
    assert len(zero) == 8 and all(n.endswith("dense.bias") for n in zero)


def test_chip_smoke_work_counts():
    """The pool backward's operations count d_h0, d_w and d_bias only at
    the max mask: every neighbour when all tie, one a (query, output
    channel) when none do. (chip_smoke.py takes its counts from
    ops/kernels.py kernel_work.)"""
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


def test_chip_smoke_work_counts_attic_kernels():
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


def test_chip_smoke_workflow_runs_on_cpu(monkeypatch):
    """The smoke run's workflow phase end to end on the CPU at tiny_config
    and small trees: the five cli entries from the shipped YAMLs (loader
    pools of 2 workers), the resume from the best checkpoint, evaluate, and
    the device and host eval paths held against each other; the plain
    versions launch no kernel."""
    mod = _load_chip_smoke()
    for name in ("teacher", "lighttoken_res", "bifeat", "fg"):
        monkeypatch.setitem(PRESETS, name, tiny_config(name))
    out = mod.workflow("cpu", 256, ft3d=dict(train=8, val=4, points=300),
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


def test_chip_smoke_mesh_phase_runs_on_cpu(monkeypatch, tmp_path):
    """The smoke run's mesh phase on the CPU at tiny_config and 256 points:
    (a) a gloo world of one rank in this process against the no-mesh step,
    (b) two spawned gloo ranks against one step over their global batch,
    under the card's gates; the plain versions launch no kernel."""
    mod = _load_chip_smoke()
    # the spawned ranks import the module by name to find mesh_rank
    monkeypatch.setitem(sys.modules, "chip_smoke", mod)
    monkeypatch.syspath_prepend(str(ROOT))
    out = mod.mesh_phase(str(tmp_path), tiny_config("teacher"), "cpu", 256)
    zero = dict.fromkeys(kernels.LAUNCHES, 0)
    assert out["launches"] == zero
    assert out["rank_launches"] == [zero] * mod.MESH_RANKS
    assert out["ms"] > 0 and out["no_mesh_ms"] > 0


def test_chip_smoke_preprocess_phase_runs_on_cpu(monkeypatch):
    """The smoke run's raw-frames-to-eval step on the CPU at tiny_config
    and small frames: both preprocessors' entries (one worker each), then
    the FT3D and KITTI evals, each scene's points as written and the six
    metrics and loss finite; the plain versions launch no kernel."""
    mod = _load_chip_smoke()
    monkeypatch.setitem(PRESETS, "teacher", tiny_config("teacher"))
    out = mod.preprocess_eval(
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
    assert mod.PER_SELFSUP_STEP == {"fps": 1, "knn": 35, "pool": 12,
                                    "pool_bwd": 12, "fps_pruned": 0,
                                    "cross_pool": 0, "knn_features": 0}


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No card: a non-zero exit and no result line, in the checkout and in
    a directory holding chip_smoke.py alone."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown")
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
