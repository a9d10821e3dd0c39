"""kd_pointcloud_tpu_torch -- the PyTorch / CUDA port of kd_pointcloud_tpu.

A second package beside the JAX one, which stays as the reference it is
held against. It imports torch and numpy, never jax, flax or
kd_pointcloud_tpu. Plain tensor code is PyTorch; each Pallas kernel of the
JAX package on the ported path is a hand-written CUDA kernel for Hopper
(csrc/), built with nvcc at first use and bound with ctypes (ops/kernels.py).

Slices: the teacher's eval forward (models.BidPointFlowNet,
eval.evaluate_model), with exact kNN; its train step (train.make_train_step);
knowledge distillation from the frozen teacher (train.make_distill_step,
train.make_bridge_distill_step, losses.kd), with checkpoints and weight
import (train.checkpoints, models.torch_import). attic/ holds the ports of
the JAX package's attic kernels, which no path runs.
"""

__version__ = "0.1.0"
