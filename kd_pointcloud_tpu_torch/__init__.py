"""kd_pointcloud_tpu_torch -- the PyTorch / CUDA port of kd_pointcloud_tpu.

A second package beside the JAX one, which stays as the reference it is
held against. It imports torch and numpy, never jax, flax or
kd_pointcloud_tpu. Plain tensor code is PyTorch; each Pallas kernel of the
JAX package on the ported path is a hand-written CUDA kernel for Hopper
(csrc/), built with nvcc at first use and bound with ctypes (ops/kernels.py).

Slice one: the teacher's eval forward (models.BidPointFlowNet,
eval.evaluate_model), with exact kNN.
"""

__version__ = "0.1.0"
