"""cost_volume_device_ms.train (ms): device time, a pair, of the kernels
launched inside the program's model.cost_volume spans (nn/experimental.py
PointConvFlow, plain PyTorch: its two kNN searches, the gathers and the
concatenation of the grouped tensor, the MLP's products, the WeightNets
and the weighted sums) in the traced stretch of a training cell: each
launch call that starts in such a span on the span's thread, its kernel
matched by args.correlation. The forward only: the backward's kernels are
launched outside the span.
Layer: kernels. Moves train_pairs_per_s."""

from benchmark.spans import device_ms_inside

SPAN = "model.cost_volume"


def read(stretch):
    return device_ms_inside(stretch, SPAN)
