"""What the per-layer readers (metrics/<metric>.py) share: each reader
file names its metric and its cells in its docstring and hands the traced
stretch (tracing.py Stretch) to one of these. Each returns a number, or
None where the stretch holds nothing for it to read."""

from __future__ import annotations

from benchmark.work import PEAK_FLOPS


def idle_pct(stretch):
    """The share of the stretch in which no kernel, copy or set ran on the
    device, in %."""
    busy = stretch.busy_s
    return 100.0 * (1.0 - busy / stretch.window_s) if busy > 0 else None


def launches_per_pair(stretch):
    """Kernel launch calls on the host in the stretch, a pair served."""
    n = stretch.launches()
    return n / stretch.pairs if n else None


def mfu(stretch):
    """The frozen operations a pair (work.py cell_work) times the untraced
    window's pairs a second (the host's clock), over the H100's float32
    peak without tensor cores, in %."""
    return 100.0 * stretch.work["flops"] * stretch.rate / PEAK_FLOPS


def roofline(stretch, pattern: str, kernels):
    """The least time of the stretch's calls of the work.py kernels named
    (their bound seconds a pair times the stretch's pairs) over the device
    time of the kernels whose names match pattern, in %."""
    t = stretch.kernel_s(pattern)
    if t <= 0:
        return None
    bound = sum(stretch.work["kernels"][k][2] for k in kernels)
    return 100.0 * bound * stretch.pairs / t
