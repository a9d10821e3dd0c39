"""Fast / iterative KD: a bifeat teacher into an fg student with att_iter_loss
(scripts/fast_distill.py; the reference's fast_distillTrain.py): python -m
kd_pointcloud_tpu_torch.cli.fast_distill <config>.yaml [--device cpu]."""

from ..train.distill_experiment import distill
from . import parse_config


def main(argv=None, max_epochs=None, max_steps_per_epoch=None):
    args, device = parse_config(argv, __doc__)
    return distill(args, mode="fast", device=device, max_epochs=max_epochs,
                   max_steps_per_epoch=max_steps_per_epoch)


if __name__ == "__main__":
    main()
