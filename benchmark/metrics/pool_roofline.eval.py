"""pool_roofline.eval (%): the least time the cost-volume pools of the
stretch's pairs need on the H100 (kernels/pool.py at each call site),
over the device time of the pool kernel.
Layer: kernels (ops/pool_fused.py -> csrc/pool_fused.cu). Moves
eval_pairs_per_s."""

from benchmark.readers import roofline

KERNELS = r"(?<![A-Za-z_])pool_kernel\b"


def read(stretch):
    return roofline(stretch, KERNELS, ("pool",))
