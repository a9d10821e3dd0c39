"""host_launches_per_pair.eval (launches/pair): kernel launch calls on the
host (the CUDA runtime's or driver's LaunchKernel family; a graph launch
counts as one) in the traced stretch of an eval cell, a pair served.
Layer: host dispatch. Moves eval_latency_p95_ms."""

from benchmark.readers import launches_per_pair as read  # noqa: F401
