"""Guards of the port: what it imports, how it treats devices, and that its
card-only pieces (chip_smoke.py, the ctypes kernel loader) import and refuse
cleanly on a machine without a card."""

import importlib.util
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the port's test files import both frameworks)
import pytest
import torch

import kd_pointcloud_tpu_torch
from kd_pointcloud_tpu_torch import device as port_device
from kd_pointcloud_tpu_torch.models import BidPointFlowNet, tiny_config
from kd_pointcloud_tpu_torch.ops import fps, kernels, knn, pool_fused

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = Path(kd_pointcloud_tpu_torch.__file__).resolve().parent
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|kd_pointcloud_tpu|torch\.utils\."
    r"cpp_extension)(\.|\s|$)", re.M)


def _port_files():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_no_jax_flax_or_jax_package(path):
    src = path.read_text()
    assert not FORBIDDEN.search(src), FORBIDDEN.search(src).group(0)
    assert "import cpp_extension" not in src


def test_kernel_sources_are_plain_cuda():
    names = [p.name for p in kernels.sources()]
    assert names == ["fps.cu", "knn.cu", "pool_fused.cu"]
    for p in kernels.sources():
        src = p.read_text()
        assert "torch/extension.h" not in src
        assert 'extern "C"' in src
        assert "kd_pointcloud_tpu/ops/pallas/" in src   # what it replaces
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
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


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 64, 3, device="meta")
    with pytest.raises(ValueError):
        fps.furthest_point_sample(x, 8)
    with pytest.raises(ValueError):
        knn.knn_point(3, x, x)
    with pytest.raises(ValueError):
        pool_fused.pool_mlp_max(x, x.int(), x, x[0], x[0, 0])


def test_pool_kernel_backward_raises():
    with pytest.raises(NotImplementedError, match="train-step"):
        pool_fused._PoolFunction.backward(None, torch.zeros(1))


def test_launch_counters_start_and_reset():
    kernels.LAUNCHES["knn"] += 2
    kernels.reset_launches()
    assert kernels.LAUNCHES == {"fps": 0, "knn": 0, "pool": 0}


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_imports_without_a_card():
    mod = _load_chip_smoke()
    assert mod.PER_FORWARD == {"fps": 1, "knn": 19, "pool": 12}
    assert set(mod.KERNEL_META) == set(kernels.LAUNCHES)
    for meta in mod.KERNEL_META.values():
        assert (ROOT / meta["source"]).exists()
        path, line = meta["replaces"].split(":")
        assert "pl.pallas_call" in \
            (ROOT / path).read_text().splitlines()[int(line) - 1]


def test_chip_smoke_ptxas_summary():
    text = ("ptxas info    : Compiling entry function "
            "'_ZN12_GLOBAL__N_110knn_kernelILi32EEEvPKfS2_iiPiPf' for "
            "'sm_90a'\n    0 bytes stack frame, 8 bytes spill stores, "
            "4 bytes spill loads\nptxas info    : Used 96 registers, "
            "16384 bytes smem, 400 bytes cmem[0]\n")
    assert _load_chip_smoke().ptxas_summary(text) == [
        "knn_kernel<32>: 96 registers, 16384 B static smem, "
        "spill stores 8 B, loads 4 B"]


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
