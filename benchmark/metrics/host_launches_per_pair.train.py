"""host_launches_per_pair.train (launches/pair): kernel launch calls on the
host (the CUDA runtime's or driver's LaunchKernel family; a graph launch
counts as one) in the traced stretch of a KD cell, a pair served.
Layer: host dispatch. Moves train_pairs_per_s."""

from benchmark.readers import launches_per_pair as read  # noqa: F401
