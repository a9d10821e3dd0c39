"""Teacher training: python -m kd_pointcloud_tpu_torch.cli.train
<config>.yaml [--device cpu] (scripts/train.py; the reference's
train_bid_pointconv.py)."""

from ..train.experiment import train_teacher
from . import parse_config


def main(argv=None, max_epochs=None, max_steps_per_epoch=None):
    args, device = parse_config(argv, __doc__)
    return train_teacher(args, device=device, max_epochs=max_epochs,
                         max_steps_per_epoch=max_steps_per_epoch)


if __name__ == "__main__":
    main()
