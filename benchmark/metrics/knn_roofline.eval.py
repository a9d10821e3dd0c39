"""knn_roofline.eval (%): the least time the 3-D kNN searches of the
stretch's pairs need on the H100 (work.py: per call the larger of
operations over the float32 peak and bytes over the bandwidth), over the
device time of the kernels named below.
Layer: kernels (ops/knn.py -> csrc/knn.cu). Moves eval_pairs_per_s."""

from benchmark.readers import roofline

KERNELS = r"(?<![A-Za-z_])knn_kernel\b"


def read(stretch):
    return roofline(stretch, KERNELS, ("knn",))
