"""pool_roofline.train (%): the least time the cost-volume pools of the
stretch's pairs need on the H100, forward and, at the student's sites,
backward (kernels/pool.py, kernels/pool_bwd.py: what the gradient needs,
without a recompute of the forward), over the device time of the pool
kernels, forward and backward.
Layer: kernels (ops/pool_fused.py -> csrc/pool_fused.cu,
csrc/pool_fused_bwd.cu). Moves train_pairs_per_s."""

from benchmark.readers import roofline

KERNELS = r"(?<![A-Za-z_])pool_(bwd_mask_|bwd_)?kernel\b"


def read(stretch):
    return roofline(stretch, KERNELS, ("pool", "pool_bwd"))
