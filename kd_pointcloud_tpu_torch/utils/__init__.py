"""Config, logging and fixture utilities of the port (kd_pointcloud_tpu/
utils: config.py, logging.py and fixtures.py). Their profiling and trace
modules import torch and are perf/ here: nothing in utils/ imports torch,
since loader workers fork after CUDA is up."""

from .config import Config, parse_args_from_yaml, postprocess
from .fixtures import fixture_path, persist_fixture
from .logging import (AverageMeter, MovingAverage, blue, make_experiment_dir,
                      make_logger)

__all__ = ["Config", "parse_args_from_yaml", "postprocess",
           "fixture_path", "persist_fixture", "AverageMeter",
           "MovingAverage", "blue", "make_experiment_dir", "make_logger"]
