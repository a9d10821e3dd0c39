"""The traced stretch: a torch.profiler recording of a few of the window's
own calls after the window, and its reduction to what the per-layer
readers (metrics/*.py) and the result's breakdown read.

``recording`` is a frozen copy of kd_pointcloud_tpu_torch/perf/trace.py's:
on an H100 CUPTI at times loses the kernel records of the first kernels of
a profiler session and of a recorded step, so the recording starts after a
warm-up step of WARM_UP_KERNELS tiny kernels, and the recorded step opens
with SETTLE_KERNELS launches of torch.cuda._sleep's spin_kernel, waited
for, before the block. The stretch itself is the span of the STRETCH
annotation, which starts after the settle, so no settle kernel is in it.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            schedule)

WARM_UP_KERNELS = 512
SETTLE_KERNELS = 512
STRETCH = "benchmark_stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = re.compile(r"^(cuda|cu)(LaunchKernel(ExC?)?(_v\d+)?|GraphLaunch)"
                    r"(_v\d+)?$")
TOP = 10


@contextlib.contextmanager
def recording():
    """A profile of the block, CPU and CUDA activity, recorded after the
    warm-up step and the settle."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        x = torch.zeros(1, device="cuda")
        for _ in range(WARM_UP_KERNELS):
            x.add_(1)
        torch.cuda.synchronize()
        prof.step()
        for _ in range(SETTLE_KERNELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        yield prof


def trace_events(run, calls: int) -> list:
    """Run run(i) for i < calls in the STRETCH span under recording, wait
    for the device inside it, and return the Chrome trace's events."""
    with recording() as prof:
        with record_function(STRETCH):
            for i in range(calls):
                run(i)
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Stretch:
    """The traced stretch of a run, as its readers see it.

    events: Chrome trace events; pairs: the pairs its calls served; work:
    the cell's frozen counts a pair (work.py cell_work); rate: the
    untraced window's pairs a second."""

    def __init__(self, events: list, pairs: int, work: dict, rate: float):
        self.pairs, self.work, self.rate = pairs, work, rate
        spans = [e for e in events if e.get("name") == STRETCH
                 and e.get("cat") == "user_annotation"]
        if len(spans) != 1:
            raise ValueError(f"trace holds {len(spans)} {STRETCH} spans")
        self.t0 = float(spans[0]["ts"])
        self.t1 = self.t0 + float(spans[0]["dur"])
        self.events = [e for e in events if e.get("ph") == "X"
                       and self.t0 <= float(e.get("ts", -1)) <= self.t1]
        self.device = [e for e in self.events
                       if e.get("cat") in DEVICE_CATS]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self):
        return _merge((float(e["ts"]), min(float(e["ts"]) + float(e["dur"]),
                                           self.t1)) for e in self.device)

    @property
    def busy_s(self) -> float:
        """Seconds in which a kernel, copy or set ran on the device."""
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches pattern."""
        rx = re.compile(pattern)
        return sum(float(e["dur"]) for e in self.device
                   if e.get("cat") == "kernel" and rx.search(e["name"])) * 1e-6

    def launches(self) -> int:
        """Kernel launch calls on the host (runtime or driver; a graph
        launch counts as one)."""
        return sum(1 for e in self.events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and LAUNCH.match(str(e.get("name", ""))))

    def breakdown(self) -> dict:
        """The device operations that took most time, by name, and the
        longest idle gaps of the device, each named by the innermost host
        op running where it starts."""
        by_name = {}
        for e in self.device:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        host = [e for e in self.events if e.get("cat") == "cpu_op"]

        def name_at(t):
            around = [e for e in host
                      if float(e["ts"]) <= t <= float(e["ts"]) + float(e["dur"])]
            if not around:
                return "host: no op"
            return "host: " + min(around, key=lambda e: float(e["dur"]))["name"]

        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        return dict(device_ops=[[n[:160], d * 1e-6] for n, d in ops],
                    idle_gaps=[[name_at(a), (b - a) * 1e-6] for a, b in gaps])
