"""Training of the port: optimizer and schedules (state), the train and
eval steps (loop), and the fixed-batch trajectory with its command-line
entry (overfit, run as python -m kd_pointcloud_tpu_torch.train.overfit)."""

from .loop import (PAD_PATH, batch_to_device, eval_sceneflow,
                   make_eval_step, make_train_step, supervised_loss)
from .state import (custom_lr, lr_for_epoch, make_optimizer,
                    set_learning_rate, step_lr)

__all__ = ["PAD_PATH", "batch_to_device", "eval_sceneflow", "make_eval_step",
           "make_train_step", "supervised_loss", "custom_lr", "lr_for_epoch",
           "make_optimizer", "set_learning_rate", "step_lr"]
