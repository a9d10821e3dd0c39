"""Config and logging utilities of the port (kd_pointcloud_tpu/utils:
config.py and logging.py; its profiling and trace modules are not ported
yet)."""

from .config import Config, parse_args_from_yaml, postprocess
from .logging import (AverageMeter, MovingAverage, blue, make_experiment_dir,
                      make_logger)

__all__ = ["Config", "parse_args_from_yaml", "postprocess", "AverageMeter",
           "MovingAverage", "blue", "make_experiment_dir", "make_logger"]
