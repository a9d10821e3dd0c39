"""correlation_roofline.eval (%), a fixture: the least time of the
stretch's correlations (kernels/correlation.py) over the device time of
the kernels named below."""

from benchmark.readers import roofline

KERNELS = r"(?<![A-Za-z_])correlation_kernel\b"


def read(stretch):
    return roofline(stretch, KERNELS, ("correlation",))
