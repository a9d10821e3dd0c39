"""Host-side (numpy) point-cloud transforms.

The port's copy of kd_pointcloud_tpu/data/transforms.py, the reference
transforms (transforms/transforms.py:137-331):
  * ProcessData   -- eval-time prep: depth mask, fixed-size random sampling,
    sf = pc2 - pc1 (row-wise correspondence before sampling).
  * Augmentation  -- train-time: joint scale/rot-Y/shift/jitter on both
    clouds, then pc2-only rot-Y/shift (+jitter when correspondence is kept),
    depth mask, fixed-size sampling.

All randomness flows through an explicit np.random.Generator, with the same
calls in the same order as the JAX package's, so the same seed gives the
same samples bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

Sample = Tuple[Optional[np.ndarray], Optional[np.ndarray], Optional[np.ndarray]]


def _depth_mask(pc1, pc2, threshold: float):
    if threshold > 0:
        return np.logical_and(pc1[:, 2] < threshold, pc2[:, 2] < threshold)
    return np.ones(pc1.shape[0], dtype=bool)


def _sample_indices(indices, num_points, no_corr, rng):
    """Random fixed-size sampling; falls back to with-replacement when the
    scene has fewer valid points (transforms/transforms.py:160-186)."""
    replace = len(indices) < num_points
    idx1 = rng.choice(indices, size=num_points, replace=replace)
    if no_corr:
        idx2 = rng.choice(indices, size=num_points, replace=replace)
    else:
        idx2 = idx1
    return idx1, idx2


class ProcessData:
    """Eval-time preparation (transforms/transforms.py:137-203)."""

    def __init__(self, depth_threshold: float = 35.0, no_corr: bool = True,
                 num_points: int = 8192, allow_less_points: bool = False):
        self.depth_threshold = depth_threshold
        self.no_corr = no_corr
        self.num_points = num_points
        self.allow_less_points = allow_less_points

    def __call__(self, data, rng: np.random.Generator) -> Sample:
        pc1, pc2 = data
        if pc1 is None:
            return None, None, None
        sf = pc2[:, :3] - pc1[:, :3]

        mask = _depth_mask(pc1, pc2, self.depth_threshold)
        indices = np.where(mask)[0]
        if len(indices) == 0:
            return None, None, None

        if self.num_points > 0 and not (
                self.allow_less_points and len(indices) < self.num_points):
            idx1, idx2 = _sample_indices(indices, self.num_points,
                                         self.no_corr, rng)
        else:
            idx1 = idx2 = indices
        return pc1[idx1], pc2[idx2], sf[idx1]


def _rot_y(angle, dtype=np.float32):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=dtype)


class Augmentation:
    """Train-time augmentation (transforms/transforms.py:206-331).

    together_args / pc2_args mirror the reference config keys
    (config_train_bid_pointconv.yaml:37-51)."""

    def __init__(self, aug_together: dict, aug_pc2: dict,
                 depth_threshold: float = 35.0, no_corr: bool = True,
                 num_points: int = 8192, allow_less_points: bool = False):
        self.together = aug_together
        self.pc2_args = aug_pc2
        self.depth_threshold = depth_threshold
        self.no_corr = no_corr
        self.num_points = num_points
        self.allow_less_points = allow_less_points

    def __call__(self, data, rng: np.random.Generator) -> Sample:
        pc1, pc2 = data
        if pc1 is None:
            return None, None, None
        pc1 = pc1.copy()
        pc2 = pc2.copy()
        tg = self.together

        # joint transform: scale x rotation, then shift + jitter bias
        scale = np.diag(rng.uniform(tg["scale_low"], tg["scale_high"],
                                    3).astype(np.float32))
        angle = rng.uniform(-tg["degree_range"], tg["degree_range"])
        matrix = scale.dot(_rot_y(angle).T)
        shifts = rng.uniform(-tg["shift_range"], tg["shift_range"],
                             (1, 3)).astype(np.float32)
        jitter = np.clip(
            tg["jitter_sigma"] * rng.standard_normal((pc1.shape[0], 3)),
            -tg["jitter_clip"], tg["jitter_clip"]).astype(np.float32)
        bias = shifts + jitter
        pc1[:, :3] = pc1[:, :3].dot(matrix) + bias
        pc2[:, :3] = pc2[:, :3].dot(matrix) + bias

        # pc2-only transform: rotation + shift (then sf is measured, then
        # jitter when correspondence is kept, :248-269)
        p2 = self.pc2_args
        angle2 = rng.uniform(-p2["degree_range"], p2["degree_range"])
        shifts2 = rng.uniform(-p2["shift_range"], p2["shift_range"],
                              (1, 3)).astype(np.float32)
        pc2[:, :3] = pc2[:, :3].dot(_rot_y(angle2, pc1.dtype).T) + shifts2
        sf = pc2[:, :3] - pc1[:, :3]

        if not self.no_corr:
            jitter2 = np.clip(
                p2["jitter_sigma"] * rng.standard_normal((pc1.shape[0], 3)),
                -p2["jitter_clip"], p2["jitter_clip"]).astype(np.float32)
            pc2[:, :3] += jitter2

        mask = _depth_mask(pc1, pc2, self.depth_threshold)
        indices = np.where(mask)[0]
        if len(indices) == 0:
            return None, None, None

        if self.num_points > 0 and not (
                self.allow_less_points and len(indices) < self.num_points):
            idx1, idx2 = _sample_indices(indices, self.num_points,
                                         self.no_corr, rng)
        else:
            idx1 = idx2 = indices
        return pc1[idx1], pc2[idx2], sf[idx1]
