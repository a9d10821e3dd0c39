"""Dataset walkers for preprocessed FT3D-subset and KITTI (HPLFlowNet
layout: one leaf directory a scene, holding pc1.npy and pc2.npy).

The port's copy of kd_pointcloud_tpu/data/datasets.py, the reference
datasets package:
  * FlyingThings3DSubset     -- datasets/flyingthings3d_subset.py (19640 /
    3824 scenes, x/z sign flips on load, full=False takes every 4th train
    scene)
  * FlyingThings3DSubsetMin  -- datasets/flyingthings3d_subset_min.py
    (4504 / 451 scenes, '..._processed_min' root)
  * KITTI                    -- datasets/kitti.py (200 scenes filtered to
    142 by KITTI_mapping.txt, ground removal y < -1.4 on both clouds)

Samples are plain numpy; batching lives in loader.py. A sample is (pc1,
pc2, norm1, norm2, sf, path); the norms are the positions themselves, as in
the reference (flyingthings3d_subset.py:50-52). The scene counts are class
attributes and a mismatch ends the run, so a mis-rooted directory never
evaluates on the wrong scene set. Imports no torch.
"""

from __future__ import annotations

import os
import os.path as osp
import sys
from typing import Callable, List, Optional

import numpy as np

from . import native_io


class PointCloudDataset:
    """Base: walks leaf directories containing pc1.npy/pc2.npy pairs."""

    def __init__(self, root: str, transform: Callable,
                 seed: int = 0, strict_counts: bool = True):
        self.root = root
        self.transform = transform
        self.samples: List[str] = []
        self.strict_counts = strict_counts
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.samples)

    def reseed(self, seed: int):
        self._rng = np.random.default_rng(seed)

    def pc_loader(self, path: str):
        raise NotImplementedError

    def __getitem__(self, index: int):
        path = self.samples[index]
        pc1, pc2 = self.pc_loader(path)
        pc1_t, pc2_t, sf = self.transform((pc1, pc2), self._rng)
        if pc1_t is None:
            # failed sample -> resample a random index
            # (flyingthings3d_subset.py:43-46)
            return self[int(self._rng.integers(len(self)))]
        return pc1_t, pc2_t, pc1_t, pc2_t, sf, path

    @staticmethod
    def _walk_leaves(root: str) -> List[str]:
        root = osp.realpath(osp.expanduser(root))
        return sorted(d for d, subdirs, _ in os.walk(root) if not subdirs)


class FlyingThings3DSubset(PointCloudDataset):
    TRAIN_COUNT, VAL_COUNT = 19640, 3824
    DIRNAME = "FlyingThings3D_subset_processed_35m"

    def __init__(self, train: bool, transform: Callable, data_root: str,
                 full: bool = True, seed: int = 0, strict_counts: bool = True,
                 num_points: int = 8192):
        super().__init__(osp.join(data_root, self.DIRNAME), transform, seed,
                         strict_counts)
        self.train = train
        self.num_points = num_points
        split_root = osp.join(self.root, "train" if train else "val")
        paths = self._walk_leaves(split_root)
        expected = self.TRAIN_COUNT if train else self.VAL_COUNT
        if strict_counts and len(paths) != expected:
            print(f"scene-count assert failed: {len(paths)} != {expected}",
                  file=sys.stderr)
            raise SystemExit(1)
        if train and not full:
            paths = paths[::4]
        self.samples = paths

    def pc_loader(self, path: str):
        pc1, pc2 = native_io.read_batch([osp.join(path, "pc1.npy"),
                                         osp.join(path, "pc2.npy")],
                                        n_threads=2)
        # subset-dataset sign flips (flyingthings3d_subset.py:99-103)
        for pc in (pc1, pc2):
            pc[..., -1] *= -1
            pc[..., 0] *= -1
        return pc1, pc2


class FlyingThings3DSubsetMin(FlyingThings3DSubset):
    TRAIN_COUNT, VAL_COUNT = 4504, 451
    DIRNAME = "FlyingThings3D_subset_processed_min"


class KITTI(PointCloudDataset):
    """The scenes of 200 that KITTI_mapping.txt maps (142 in the reference
    checkout; datasets/kitti.py:62-86). The mapping file defaults to
    <data_root>/KITTI_mapping.txt, where the reference checkout keeps it."""

    SCENE_COUNT = 200

    def __init__(self, train: bool, transform: Callable, data_root: str,
                 remove_ground: bool = True, seed: int = 0,
                 strict_counts: bool = True, num_points: int = 8192,
                 mapping_path: Optional[str] = None):
        super().__init__(osp.join(data_root, "kitti_processed"), transform,
                         seed, strict_counts)
        self.train = train
        self.remove_ground = remove_ground
        self.num_points = num_points
        paths = self._walk_leaves(self.root)
        if strict_counts and len(paths) != self.SCENE_COUNT:
            print(f"KITTI scene count {len(paths)} != {self.SCENE_COUNT}",
                  file=sys.stderr)
            raise SystemExit(1)
        mapping_path = mapping_path or osp.join(data_root,
                                                "KITTI_mapping.txt")
        with open(mapping_path) as fd:
            lines = [line.strip() for line in fd]
        self.samples = [p for p in paths
                        if lines[int(osp.split(p)[-1])] != ""]

    def pc_loader(self, path: str):
        pc1, pc2 = native_io.read_batch([osp.join(path, "pc1.npy"),
                                         osp.join(path, "pc2.npy")],
                                        n_threads=2)
        if self.remove_ground:
            is_ground = np.logical_and(pc1[:, 1] < -1.4, pc2[:, 1] < -1.4)
            keep = np.logical_not(is_ground)
            pc1, pc2 = pc1[keep], pc2[keep]
        return pc1, pc2


DATASETS = {
    "FlyingThings3DSubset": FlyingThings3DSubset,
    "FlyingThings3DSubsetMin": FlyingThings3DSubsetMin,
    "KITTI": KITTI,
}
