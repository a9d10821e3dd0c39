"""kd_pointcloud_tpu_torch -- the PyTorch / CUDA port of kd_pointcloud_tpu.

A second package beside the JAX one, which stays as the reference it is
held against. It imports torch and numpy, never jax, flax or
kd_pointcloud_tpu. Plain tensor code is PyTorch; each Pallas kernel of the
JAX package on the ported path is a hand-written CUDA kernel for Hopper
(csrc/), built with nvcc at first use and bound with ctypes (ops/kernels.py).

Slices: every preset of models.BidPointFlowNet, with exact kNN; the
train step (train.make_train_step); knowledge distillation from a frozen
teacher (train.make_distill_step, make_bridge_distill_step,
make_fast_distill_step, losses.kd), with checkpoints and weight import
(train.checkpoints, models.torch_import); and the user's path: config and
logging (utils), the data pipeline (data: numpy only), the six-metric eval
sweep over a loader (eval.evaluate_model), the epoch loops
(train.train_teacher, train.distill) and their command-line entries
(python -m kd_pointcloud_tpu_torch.cli.<train|evaluate|distill|
distill_bridge|fast_distill> <config>.yaml [--device cpu]); and the
tooling around the model: the blocked-FPS relaxation (fps_blocks), the
self-supervised loss (losses.selfsup), profiling and tracing (perf, with
python -m kd_pointcloud_tpu_torch.cli.profile), the licensing band
(eval.licensing), fixtures (utils.fixtures) and the raw-data
preprocessors (data.preprocess); and the experimental inventory: the
ablation modules of nn.experimental and nn.vn_layers and the pointnet2
API of ops.pointnet2_compat (ball query, three_nn, the SA and FP
modules), on the FPS and kNN kernels; and data parallelism (parallel:
a torch.distributed mesh, the JAX package's batch plans and the
global-batch step on every rank, under torchrun). attic/ holds the ports
of the JAX package's attic kernels, which no path runs.
"""

__version__ = "0.1.0"
