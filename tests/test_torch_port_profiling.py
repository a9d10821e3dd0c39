"""The port's profiling and tracing (perf/, cli/profile.py) on the CPU.

param_count against the JAX package's param_count(variables["params"]);
the operation count of a forward against FlopCounterMode's dense count
plus ops/kernels.py kernel_work at the kernels' call sites, assembled here
independently; the work a plain version reports against its kernel's;
latency; a Chrome trace with its annotations; the profile entry.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from kd_pointcloud_tpu.models import BidPointFlowNet as JaxNet
from kd_pointcloud_tpu.models import tiny_config as jax_tiny_config
from kd_pointcloud_tpu.utils.profiling import param_count as jax_param_count
from kd_pointcloud_tpu_torch.cli import profile as profile_cli
from kd_pointcloud_tpu_torch.eval import make_eval_forward
from kd_pointcloud_tpu_torch.models import (PRESETS, BidPointFlowNet,
                                            tiny_config)
from kd_pointcloud_tpu_torch.ops import fps, kernels, knn, pool_fused
from kd_pointcloud_tpu_torch.perf import (annotate, flop_count, latency,
                                          param_count, profile_model, trace)
from kd_pointcloud_tpu_torch.perf.trace import kernel_records

torch.set_num_threads(1)

N = 256


def _pair(seed=0, n=N):
    rng = np.random.RandomState(seed)
    pc1 = torch.from_numpy(rng.uniform(-2, 2, (1, n, 3)).astype(np.float32))
    pc2 = pc1 + 0.1 * torch.from_numpy(
        rng.standard_normal((1, n, 3)).astype(np.float32))
    return pc1, pc2, pc1, pc2


@pytest.mark.parametrize("name", ["teacher", "student", "fg"])
def test_param_count_matches_jax(name):
    pc1, pc2, _, _ = (a.numpy() for a in _pair())
    net = JaxNet(jax_tiny_config(name))
    shapes = jax.eval_shape(lambda k: net.init(k, pc1, pc2, pc1, pc2,
                                               train=False),
                            jax.random.PRNGKey(0))
    model = BidPointFlowNet(tiny_config(name), device="cpu")
    assert param_count(model) == jax_param_count(shapes["params"])
    # BatchNorm statistics are buffers, not parameters
    assert sum(b.numel() for b in model.buffers()) > 0


@pytest.mark.parametrize("name", ["teacher", "fg"])
def test_forward_count_is_dense_plus_kernel_work(name, monkeypatch):
    """flop_count of an eval forward = FlopCounterMode over the forward
    less what it counted inside the kernels' plain versions, plus
    kernel_work at each kernel call site."""
    model = BidPointFlowNet(tiny_config(name), device="cpu",
                            generator=torch.Generator().manual_seed(0))
    fwd = make_eval_forward(model)
    inputs = _pair(1)
    got = flop_count(fwd, *inputs)

    sites = []
    for mod, attr, kname in ((fps, "fps_plain", "fps"),
                             (knn, "knn_plain", "knn"),
                             (pool_fused, "pool_plain", "pool")):
        def record(*args, _plain=getattr(mod, attr), _name=kname):
            sites.append((_name, _plain, args))
            return _plain(*args)
        monkeypatch.setattr(mod, attr, record)
    with FlopCounterMode(display=False) as all_ops:
        fwd(*inputs)
    inside = 0
    for _, plain, args in sites:
        with FlopCounterMode(display=False) as fc:
            plain(*args)
        inside += fc.get_total_flops()
    work = [kernels.kernel_work(n, *a) for n, _, a in sites]
    dense = all_ops.get_total_flops() - inside
    assert inside > 0 and dense > 0        # the pool's linear is in both
    assert got["dense_flops"] == dense
    assert got["kernel_flops"] == sum(w[0] for w in work)
    assert got["kernel_bytes"] == sum(w[1] for w in work)
    assert got["flops"] == dense + sum(w[0] for w in work)
    calls = {n: sum(1 for s in sites if s[0] == n) for n in
             ("fps", "knn", "pool")}
    assert {n: v["calls"] for n, v in got["by_kernel"].items()} == calls
    assert calls["fps"] == 1 and calls["pool"] == 12


def test_plain_versions_report_their_kernels_work():
    """Inside kernels.counting() a plain version reports kernel_work of
    its arguments, once a call, and its aten ops stay out of
    FlopCounterMode; outside one nothing is counted."""
    rng = np.random.RandomState(2)
    u = torch.from_numpy(rng.standard_normal((2, 50, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 40, 32)).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 50, (2, 40, 8)).astype(np.int32))
    w, b = torch.eye(32), torch.zeros(32)
    xyz = u[..., :3].contiguous()
    with kernels.counting() as count, FlopCounterMode(display=False) as fc:
        pool_fused.pool_mlp_max(u, idx, v, w, b)
        knn.knn_point_dist(5, xyz, v[..., :3].contiguous())
        fps.furthest_point_sample(xyz, 10)
        with kernels.counting() as inner:
            knn.knn_point_dist(10, xyz, xyz)
    assert fc.get_total_flops() == 0
    assert count.calls == {"pool": 1, "knn": 1, "fps": 1}
    assert count.ops["pool"] == kernels.kernel_work("pool", u, idx, v, w,
                                                    b)[0]
    assert count.bytes["knn"] == kernels.kernel_work(
        "knn", 5, xyz, v[..., :3])[1]
    assert inner.calls == {"knn": 1}
    assert not kernels.is_counting()
    with pytest.raises(ValueError, match="no work count"):
        kernels.kernel_work("conv", u)


def test_latency_and_profile_model_on_cpu():
    model = BidPointFlowNet(tiny_config("teacher"), device="cpu",
                            generator=torch.Generator().manual_seed(0))
    ms, pps = latency(make_eval_forward(model), *_pair(), warmup=1, iters=2)
    assert ms > 0 and pps > 0 and abs(ms * pps - 1000.0) < 1e-6 * 1000
    stats = profile_model(model, *_pair(), warmup=1, iters=2)
    assert stats["params"] == param_count(model)
    assert stats["device"] == "cpu"
    assert stats["flops"] == stats["dense_flops"] + stats["kernel_flops"]
    assert stats["latency_ms"] > 0 and stats["pairs_per_sec"] > 0


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    model = BidPointFlowNet(tiny_config("teacher"), device="cpu",
                            generator=torch.Generator().manual_seed(0))
    fwd = make_eval_forward(model)
    with trace(str(tmp_path / "t")) as log_dir:
        for step in range(2):
            with annotate("eval forward"):
                fwd(*_pair(step))
    assert log_dir == str(tmp_path / "t")
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    spans = [e["name"] for e in events["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert spans.count("eval forward") == 2
    assert spans.count("eval.forward") == 2    # the eval step's own span


@pytest.mark.parametrize("name, counter", [
    ("void fps_kernel<8, 8, false>(float const*, int, int, int*)", "fps"),
    ("_Z10fps_kernelILi8ELi8ELb0EEvPKfiiPi", "fps"),
    ("void knn_kernel<16, 2>(float const*, float const*, int, int)", "knn"),
    ("void pool_kernel<64>(float const*, int const*)", "pool"),
    ("void pool_bwd_mask_kernel<64>(float const*, int const*)", "pool_bwd"),
    ("void fps_pruned_kernel<4>(float const*, int, int, int*)",
     "fps_pruned"),
    ("void cross_pool_kernel<64>(float const*, int const*)", "cross_pool"),
])
def test_kernel_records_count_each_launch_counter(name, counter):
    """A trace's kernel record counts under the launch counter
    (ops.kernels.LAUNCHES) of the wrapper that launched it; the runtime
    call's record does not count."""
    assert counter in kernels.LAUNCHES
    events = [{"cat": "kernel", "name": name},
              {"cat": "cuda_runtime", "name": name},
              {"cat": "kernel", "name": name}]
    assert kernel_records(events) == {counter: 2}


def test_kernel_records_leave_out_other_kernels():
    """The pool backward's second kernel (not run at every launch) and
    kernels whose names only end or begin like a port kernel's."""
    events = [{"cat": "kernel", "name": n} for n in (
        "void pool_bwd_kernel<64>(int const*, float const*)",
        "void my_knn_kernel<2>(float*)",
        "void fps_kernel_v2<8>(float*)",
        "void at::native::vectorized_elementwise_kernel<4>(int)")]
    assert kernel_records(events) == {}


def test_profile_entry_on_cpu(monkeypatch, capsys):
    """python -m kd_pointcloud_tpu_torch.cli.profile teacher student fg
    --device cpu, at tiny_config: one line a preset."""
    for name in ("teacher", "student", "fg"):
        monkeypatch.setitem(PRESETS, name, tiny_config(name))
    out = profile_cli.main(["teacher", "student", "fg", "--points",
                            str(N), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["teacher", "student", "fg"]
    for ln, (name, stats) in zip(lines, out.items()):
        assert f"params={stats['params'] / 1e6:.2f}M" in ln
        assert "pairs/s" in ln and ln.endswith("on cpu")
    assert out["student"]["params"] < out["teacher"]["params"]


def test_profile_entry_scales_npoints_and_needs_a_card(monkeypatch):
    cfg = profile_cli.scaled(PRESETS["teacher"], 2048)
    assert cfg.npoints == (2048, 512, 128, 64, 16)
    assert profile_cli.scaled(PRESETS["teacher"], 8192) is PRESETS["teacher"]
    assert dataclasses.replace(cfg, npoints=PRESETS["teacher"].npoints) == \
        PRESETS["teacher"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_cli.main(["teacher"])
