"""Training of the port: optimizer and schedules (state), the train and
eval steps (loop), the fixed-batch trajectory with its command-line entry
(overfit, run as python -m kd_pointcloud_tpu_torch.train.overfit), the
knowledge-distillation steps (distill), the epoch loops of the teacher
(experiment.train_teacher) and of distillation
(distill_experiment.distill), which the cli/ entries run, and checkpoints
(checkpoints)."""

from .checkpoints import (best_checkpoint, full_state_tree, load_checkpoint,
                          load_msgpack_checkpoint, load_msgpack_tree,
                          load_weights, parse_epoch_from_name,
                          restore_train_state, save_checkpoint)
from .distill import (apply_frozen, make_bridge_distill_step,
                      make_distill_step, make_fast_distill_step)
from .distill_experiment import (compute_teacher_history, distill,
                                 make_named_loss)
from .experiment import (build_datasets, build_model, build_transforms,
                         train_teacher)
from .loop import (PAD_PATH, batch_to_device, eval_sceneflow,
                   make_eval_step, make_train_step, supervised_loss)
from .state import (custom_lr, lr_for_epoch, make_optimizer,
                    set_learning_rate, step_lr)

__all__ = ["PAD_PATH", "batch_to_device", "eval_sceneflow", "make_eval_step",
           "make_train_step", "supervised_loss", "custom_lr", "lr_for_epoch",
           "make_optimizer", "set_learning_rate", "step_lr",
           "apply_frozen", "make_distill_step", "make_fast_distill_step",
           "make_bridge_distill_step",
           "compute_teacher_history", "distill", "make_named_loss",
           "build_datasets", "build_model", "build_transforms",
           "train_teacher", "best_checkpoint", "full_state_tree",
           "load_checkpoint", "load_msgpack_checkpoint", "load_msgpack_tree",
           "load_weights", "parse_epoch_from_name", "restore_train_state",
           "save_checkpoint"]
