"""Data pipeline of the port: dataset walkers, host-side transforms,
batching with worker processes (kd_pointcloud_tpu/data, copied). numpy and
the standard library only: nothing here imports torch, so loader workers
never touch CUDA."""

from .datasets import (DATASETS, KITTI, FlyingThings3DSubset,
                       FlyingThings3DSubsetMin)
from .loader import PAD_PATH, DataLoader, collate, pad_batch, valid_count
from .transforms import Augmentation, ProcessData

__all__ = ["DATASETS", "KITTI", "FlyingThings3DSubset",
           "FlyingThings3DSubsetMin", "DataLoader", "collate",
           "pad_batch", "valid_count", "PAD_PATH",
           "Augmentation", "ProcessData"]
