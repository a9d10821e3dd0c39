"""The program's KD step train/distill.py make_distill_step, its loss
train/distill_experiment.py make_named_loss(workload["loss"]) with the
workload's gamma, beta and hint_layers."""

from kd_pointcloud_tpu_torch.train.distill import make_distill_step
from kd_pointcloud_tpu_torch.train.distill_experiment import make_named_loss


def build(teacher, student, opt, workload: dict):
    """step(batch) -> loss: one KD step of student and opt in place."""
    return make_distill_step(teacher, student, opt,
                             loss_fn=make_named_loss(workload["loss"],
                                                     workload))
