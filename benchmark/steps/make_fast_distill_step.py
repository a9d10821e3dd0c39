"""The program's fast KD step train/distill.py make_fast_distill_step (an
iterative teacher into a student through att_iter_loss), at the workload's
gamma and hint_layers."""

from kd_pointcloud_tpu_torch.train.distill import make_fast_distill_step


def build(teacher, student, opt, workload: dict):
    """step(batch) -> loss: one KD step of student and opt in place."""
    return make_fast_distill_step(teacher, student, opt,
                                  gamma=workload["gamma"],
                                  layers=tuple(workload["hint_layers"]))
