"""Run logging + metric aggregation.

The port's copy of kd_pointcloud_tpu/utils/logging.py (reference
main_utils.py: AverageMeter :103-119, MovingAverage :84-100, Logger
:68-81), plus the per-run experiment directory of the entry scripts
(train_bid_pointconv.py:30-55).
"""

from __future__ import annotations

import datetime
import logging
import os
import os.path as osp
import sys
from collections import deque
from typing import Optional


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class MovingAverage:
    def __init__(self, window: int = 100):
        self.window = deque(maxlen=window)

    def update(self, val: float):
        self.window.append(val)

    @property
    def avg(self) -> float:
        return sum(self.window) / max(len(self.window), 1)


def make_experiment_dir(base: str, model_name: str,
                        tag: str = "Flyingthings3d") -> str:
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M")
    run_dir = osp.join(base, f"PointConv{model_name}{tag}-{stamp}")
    for sub in ("", "checkpoints", "logs"):
        os.makedirs(osp.join(run_dir, sub), exist_ok=True)
    return run_dir


def make_logger(name: str, log_path: Optional[str] = None,
                to_stdout: bool = True) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if log_path:
        fh = logging.FileHandler(log_path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if to_stdout:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    return logger


def blue(text: str) -> str:
    return "\033[94m" + text + "\033[0m"
