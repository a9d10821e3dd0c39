"""Bridge KD (scripts/distill_bridge.py; the reference's distillBridge.py):
python -m kd_pointcloud_tpu_torch.cli.distill_bridge <config>.yaml [--device
cpu]."""

from ..train.distill_experiment import distill
from . import parse_config


def main(argv=None, max_epochs=None, max_steps_per_epoch=None):
    args, device = parse_config(argv, __doc__)
    return distill(args, mode="bridge", device=device, max_epochs=max_epochs,
                   max_steps_per_epoch=max_steps_per_epoch)


if __name__ == "__main__":
    main()
