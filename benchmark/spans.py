"""What the span readers (metrics/feature_knn_device_ms.*.py,
metrics/host_sync_ms.*.py) share. The program opens named spans
(kd_pointcloud_tpu_torch/perf/trace.py annotate) while a profiler records;
the traced stretch holds them as user_annotation events on the host's
timeline, the clock of its CUDA runtime calls. Each reader returns a number
a pair, or None where the stretch holds no such span (a program without
spans, or a path without the code that opens them)."""

from __future__ import annotations

import re

from benchmark.tracing import LAUNCH

FEATURE_KNN = "knn_features"
SYNC = r"\.sync$"                  # a span's name: what the host waits in


def _spans(stretch, pattern) -> list:
    rx = re.compile(pattern)
    return [e for e in stretch.events if e.get("cat") == "user_annotation"
            and rx.search(str(e.get("name", "")))]


def device_ms_inside(stretch, name: str):
    """Device ms, a pair, of the kernels launched inside the spans called
    name: each runtime or driver launch call whose start falls in such a
    span on the span's thread, matched to its kernel by args.correlation."""
    spans = _spans(stretch, f"^{re.escape(name)}$")
    if not spans:
        return None
    by_thread = {}
    for e in spans:
        t = float(e["ts"])
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(
            (t, t + float(e["dur"])))
    launched = set()
    for e in stretch.events:
        if (e.get("cat") in ("cuda_runtime", "cuda_driver")
                and LAUNCH.match(str(e.get("name", "")))):
            t = float(e["ts"])
            if any(a <= t <= b for a, b in
                   by_thread.get((e.get("pid"), e.get("tid")), ())):
                launched.add(e.get("args", {}).get("correlation"))
    launched.discard(None)
    us = sum(float(e["dur"]) for e in stretch.device
             if e.get("cat") == "kernel"
             and e.get("args", {}).get("correlation") in launched)
    return us * 1e-3 / stretch.pairs


def feature_knn_device_ms(stretch):
    """Device ms, a pair, of the feature kNN's kernels (the spans
    knn_features)."""
    return device_ms_inside(stretch, FEATURE_KNN)


def host_sync_ms(stretch):
    """Host ms, a pair, inside the program's sync spans (names ending in
    .sync), where the host waits for the device to hand it a value."""
    spans = _spans(stretch, SYNC)
    if not spans:
        return None
    return sum(float(e["dur"]) for e in spans) * 1e-3 / stretch.pairs
