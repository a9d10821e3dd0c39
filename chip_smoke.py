#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (kd_pointcloud_tpu_torch) on one
NVIDIA card:

    python3 chip_smoke.py        # from the root of a checkout; needs a card

First every card test of the port, in this process: pytest -m card over
CARD_FILES with --noconftest (tests/conftest.py imports JAX, which the
card's machine does not have). Those tests hold each hand-written kernel
against its plain version at the inputs the paths hand it, and each path
through the kernels against the same path through the plain versions.

Then the main path's kernels line. One KD step teacher -> lighttoken_res
and one fast KD step bifeat -> fg (tests/torch_port_checks.py kd_step),
batch 8 of 8192-point pairs, float32 products in full float32 (no TF32),
each run once under kernels.counting() (eager: the bounds), then captured
as its CUDA graph and replayed STEPS times under torch.profiler, as the
cells run it. It prints one {"kernels": [...], "card": ...} JSON line
with a row per step and kernel: launches a step, device ms a step, bound
ms a step, and the bound's share of the device time in %. A call's bound
is its operations over the float32 peak or its bytes over the HBM
bandwidth, whichever is larger (benchmark/work.py bound_s).

It exits non-zero, printing no line, without a card or when a test fails.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import torch_port_checks as checks  # noqa: E402

CARD_FILES = ("tests/test_torch_port_card_kernels.py",
              "tests/test_torch_port_card_paths.py",
              "tests/test_torch_port_eval_graph.py",
              "tests/test_torch_port_knn_features.py",
              "tests/test_torch_port_train_graph.py")
KD_PATHS = ("kd", "fast_kd")
STEPS = 2
# the port kernel a device kernel belongs to (the pool backward is two
# kernels); not the tail of a longer name: cross_pool_kernel is not
# pool_kernel, and a mangled name puts the name's length (digits) before it
KERNEL_RE = re.compile(r"(?<![A-Za-z_])(fps|knn_features|knn|pool_bwd|pool)"
                       r"(?:_mask)?_kernel")


def kernel_name(device_name: str):
    """The port kernel (a key of kernels.LAUNCHES) that the device kernel
    of this name belongs to, or None."""
    m = KERNEL_RE.search(device_name)
    return m.group(1) if m else None


def counted(run) -> tuple:
    """(calls, bound ms) by kernel of one run(), from the work that each
    kernel call or plain-version call reports under kernels.counting()."""
    from benchmark.work import bound_s
    from kd_pointcloud_tpu_torch.ops import kernels

    bound = {}
    with kernels.counting() as count:
        add = count.add

        def add_call(name, ops, nbytes):
            add(name, ops, nbytes)
            bound[name] = bound.get(name, 0.0) + 1e3 * bound_s(ops, nbytes)
        count.add = add_call
        run()
    return dict(count.calls), bound


def device_ms(run, n: int = STEPS) -> dict:
    """Device ms a run() by port kernel, over n runs under torch.profiler
    (perf.recording); empty where the profiler saw no CUDA kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from kd_pointcloud_tpu_torch.perf import recording

    with recording([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = kernel_name(e.key)
        if name and e.device_type == DeviceType.CUDA:
            ms = e.self_device_time_total / 1e3 / n
            out[name] = out.get(name, 0.0) + ms
    return out


def kernel_rows(device: str = "cuda", cfg=str, batch: int = checks.KD_BATCH,
                n_points: int = checks.N_POINTS) -> list:
    """A row per KD path of KD_PATHS and kernel it calls: launches, device
    ms (None off the card), bound ms and the bound's share in % of a step;
    cfg(name) is the configuration of each preset name. On the card the
    step runs as the cells run it, replayed from its CUDA graph
    (train/graphs.py): two steps capture it, then STEPS replays give the
    launches (ops.kernels.LAUNCHES, which a replay adds to) and the device
    ms. The bounds come from a step under kernels.counting(), which runs
    eager and does the same work; off the card that step's calls are the
    launches."""
    from kd_pointcloud_tpu_torch.ops import kernels
    from kd_pointcloud_tpu_torch.perf import train_graph_counts
    from kd_pointcloud_tpu_torch.train.overfit import synthetic_batches

    rows = []
    for path in KD_PATHS:
        t_name, s_name = checks.KD_PATHS[path]
        teacher = checks.model(cfg(t_name), checks.TEACHER_SEED, device)
        student = checks.model(cfg(s_name), checks.STUDENT_SEED, device)
        step = checks.kd_step(path, teacher.eval(), student)
        data = synthetic_batches(1, batch, n_points, checks.SEED + 2,
                                 device)[0]
        launches, bound = counted(lambda: step(data))
        ms = {}
        if device == "cuda":
            step(data)                  # eager, on the capture's stream
            step(data)                  # captured and replayed
            kernels.reset_launches()
            ms = device_ms(lambda: step(data))
            assert train_graph_counts() == dict(captures=0, replays=STEPS,
                                                eager=0)
            replayed = {n: c // STEPS for n, c in kernels.LAUNCHES.items()
                        if c}
            assert all(c % STEPS == 0 for c in kernels.LAUNCHES.values())
            assert replayed.keys() == launches.keys(), (replayed, launches)
            launches = replayed
        for name, n in launches.items():
            t, b = ms.get(name), bound[name]
            rows.append(dict(path=path, kernel=name, launches=n,
                             device_ms=t, bound_ms=b,
                             roofline_pct=100 * b / t if t else None))
    return rows


def main() -> int:
    import pytest
    import torch

    from kd_pointcloud_tpu_torch.device import use_full_fp32

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card", file=sys.stderr)
        return 1
    rc = pytest.main(["--noconftest", "-p", "no:cacheprovider", "-q", "-m",
                      "card", "--rootdir", str(ROOT),
                      *(str(ROOT / f) for f in CARD_FILES)])
    if rc != 0:
        return int(rc)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    use_full_fp32()
    print(json.dumps({"kernels": kernel_rows(), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
