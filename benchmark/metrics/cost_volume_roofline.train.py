"""cost_volume_roofline.train (%): the least time the cost volumes of a
pair need on the H100 (kernels/cost_volume.py, per call the larger of
operations over the float32 peak and bytes over the bandwidth, the two kNN
searches included), over their device time a pair, the kernels launched
inside the program's model.cost_volume spans (the forward's; see
cost_volume_device_ms.train).
Layer: kernels (nn/experimental.py PointConvFlow). Moves
train_pairs_per_s."""

from benchmark.spans import device_ms_inside

SPAN = "model.cost_volume"


def read(stretch):
    ms = device_ms_inside(stretch, SPAN)
    bound = stretch.work["kernels"].get("cost_volume")
    if not ms or bound is None:
        return None
    return 100.0 * bound[2] / (ms * 1e-3)
