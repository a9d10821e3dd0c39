"""Seeded synthetic scene trees in the layouts the datasets read.

No dataset ships with the repository, so tests and the smoke run on the
card write small trees of synthetic scenes instead:

  * write_ft3d_tree: <root>/FlyingThings3D_subset_processed_35m/{train,val}/
    <7 digits>/pc{1,2}.npy, stored as the HPLFlowNet preprocessing stores
    them (x and z negated, so the loader's sign flips give depth z > 0);
  * write_kitti_tree: <root>/datasets/kitti_processed/<6 digits>/ for all
    200 scenes, of which only the mapped ones hold pc{1,2}.npy (the others
    are never read), <root>/datasets/KITTI_mapping.txt, and one P_rect_02
    line a mapped scene under <root>/utils/calib_cam_to_cam/, the reference
    checkout's layout (eval.geometry.calib_dir_for).

A scene is pc1 uniform in a box in front of the camera and pc2 a small
rigid motion of it (yaw about the vertical axis and a shift) plus 1 cm of
noise, row by row, as float32; KITTI scenes also hold ground rows (y <
-1.4 in both clouds), which the KITTI loader removes.

The raw frames the preprocessors read (data.preprocess) come seeded too:

  * write_raw_ft3d: <root>/{train,val}/ disparity (PFM), disparity change
    (PFM), optical flow (.flo) and the two occlusion masks (8-bit PNGs,
    about a tenth of the pixels occluded), FT3D's 540 x 960 by default;
  * write_raw_kitti: <root>/training/{disp_occ_0,disp_occ_1,flow_occ}/
    <6 digits>_10.png (16-bit PNGs: disparity x 256, 0 where invalid; flow
    x 64 + 2^15 with a valid plane), KITTI's 375 x 1242 by default, and a
    P_rect_02 line a frame under <root>/calib_cam_to_cam.

Imports no torch.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Sequence, Tuple

import numpy as np

from .preprocess import io, png16

KITTI_SCENES = 200
# a KITTI P_rect_02 (3 x 4, row-major); each scene's differs slightly
P_RECT_02 = (721.5377, 0.0, 609.5593, 44.85728, 0.0, 721.5377, 172.854,
             0.2163791, 0.0, 0.0, 1.0, 0.002745884)


def _moved(rng, pc1: np.ndarray) -> np.ndarray:
    yaw = rng.uniform(-0.05, 0.05)
    rot = np.array([[np.cos(yaw), 0.0, np.sin(yaw)], [0.0, 1.0, 0.0],
                    [-np.sin(yaw), 0.0, np.cos(yaw)]])
    shift = rng.uniform(-0.5, 0.5, 3) * np.array([1.0, 0.04, 1.0])
    return pc1 @ rot.T + shift + 0.01 * rng.standard_normal(pc1.shape)


def _save(scene_dir: str, pc1: np.ndarray, pc2: np.ndarray) -> None:
    os.makedirs(scene_dir, exist_ok=True)
    np.save(osp.join(scene_dir, "pc1.npy"), pc1.astype(np.float32))
    np.save(osp.join(scene_dir, "pc2.npy"), pc2.astype(np.float32))


def write_ft3d_tree(root: str, n_train: int, n_val: int, n_points: int,
                    seed: int = 0,
                    dirname: str = "FlyingThings3D_subset_processed_35m"
                    ) -> str:
    """Write an FT3D-subset tree of n_train + n_val scenes of n_points rows
    under root; returns the data root (root)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array([-15.0, -8.0, 2.0]), np.array([15.0, 8.0, 40.0])
    for split, n in (("train", n_train), ("val", n_val)):
        for i in range(n):
            pc1 = rng.uniform(lo, hi, (n_points, 3))
            pc2 = _moved(rng, pc1)
            flip = np.array([-1.0, 1.0, -1.0])
            _save(osp.join(root, dirname, split, f"{i:07d}"), pc1 * flip,
                  pc2 * flip)
    return root


def write_kitti_tree(root: str, mapped: Sequence[int], n_points: int,
                     seed: int = 0) -> Tuple[str, str]:
    """Write a KITTI tree under root: 200 scene directories, scenes of
    n_points rows (a quarter of them ground rows) in the mapped ones.
    Returns (data root, calib dir)."""
    rng = np.random.default_rng(seed)
    data_root = osp.join(root, "datasets")
    calib_dir = osp.join(root, "utils", "calib_cam_to_cam")
    os.makedirs(calib_dir, exist_ok=True)
    lines = []
    for i in range(KITTI_SCENES):
        name = f"{i:06d}"
        scene_dir = osp.join(data_root, "kitti_processed", name)
        os.makedirs(scene_dir, exist_ok=True)
        if i not in mapped:
            lines.append("")
            continue
        lines.append(f"2011_09_26_drive_{i:04d}_sync 0000000{i % 10}")
        n_ground = n_points // 4
        pc1 = rng.uniform([-20.0, -1.3, 1.0], [20.0, 2.0, 40.0],
                          (n_points, 3))
        pc1[:n_ground, 1] = rng.uniform(-1.8, -1.5, n_ground)
        pc2 = _moved(rng, pc1)
        _save(scene_dir, pc1, pc2)
        P = np.asarray(P_RECT_02) * rng.uniform(0.98, 1.02, 12)
        with open(osp.join(calib_dir, name + ".txt"), "w") as fd:
            fd.write("calib_time: 09-Jan-2012 13:57:47\n")
            fd.write("P_rect_02: " + " ".join(f"{v:.6e}" for v in P) + "\n")
    with open(osp.join(data_root, "KITTI_mapping.txt"), "w") as fd:
        fd.write("\n".join(lines) + "\n")
    return data_root, calib_dir


def write_raw_ft3d(root: str, n_train: int, n_val: int, height: int = 540,
                   width: int = 960, seed: int = 0) -> str:
    """Write raw FT3D-subset frames (the layout preprocess.ft3d reads)
    under root; returns root."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        dirs = dict(disp=("disparity", "left"),
                    occ=("disparity_occlusions", "left"),
                    change=("disparity_change", "left", "into_future"),
                    flow=("flow", "left", "into_future"),
                    flow_occ=("flow_occlusions", "left", "into_future"))
        for parts in dirs.values():
            os.makedirs(osp.join(root, split, *parts), exist_ok=True)
        for i in range(n):
            name = f"{i:07d}"

            def path(key, ext):
                return osp.join(root, split, *dirs[key], name + ext)

            disp = rng.uniform(30.0, 120.0, (height, width)).astype(
                np.float32)
            io.write_pfm(path("disp", ".pfm"), disp)
            io.write_pfm(path("change", ".pfm"), rng.uniform(
                -1.0, 1.0, (height, width)).astype(np.float32))
            io.write_flo(path("flow", ".flo"), rng.uniform(
                -8.0, 8.0, (height, width, 2)).astype(np.float32))
            for key in ("occ", "flow_occ"):
                mask = (rng.random((height, width)) < 0.05) * 255
                png16.write_png16(path(key, ".png"), mask.astype(np.uint8))
    return root


def write_raw_kitti(root: str, frames: Sequence[int], height: int = 375,
                    width: int = 1242, seed: int = 0) -> Tuple[str, str]:
    """Write raw KITTI Scene Flow frames (the layout preprocess.kitti
    reads) and their calibration under root; returns (data root, calib
    root)."""
    rng = np.random.default_rng(seed)
    calib_root = osp.join(root, "calib_cam_to_cam")
    os.makedirs(calib_root, exist_ok=True)
    for sub in ("disp_occ_0", "disp_occ_1", "flow_occ"):
        os.makedirs(osp.join(root, "training", sub), exist_ok=True)
    for i in frames:
        name = f"{i:06d}"

        def path(sub):
            return osp.join(root, "training", sub, name + "_10.png")

        for sub in ("disp_occ_0", "disp_occ_1"):
            # disparities of 12-80 px: depths of 5-32 m at f = 721.5
            disp = rng.uniform(12.0, 80.0, (height, width))
            disp[rng.random((height, width)) < 0.3] = 0.0   # no return
            png16.write_png16(path(sub), np.round(disp * 256).astype(
                np.uint16))
        flow = np.round(rng.uniform(-20.0, 20.0, (height, width, 2)) * 64
                        + 2 ** 15)
        valid = (rng.random((height, width, 1)) < 0.8).astype(np.float64)
        png16.write_png16(path("flow_occ"), np.concatenate(
            [flow, valid], -1).astype(np.uint16))
        with open(osp.join(calib_root, name + ".txt"), "w") as fd:
            fd.write("calib_time: 09-Jan-2012 13:57:47\n")
            fd.write("P_rect_02: " + " ".join(f"{v:.6e}" for v in P_RECT_02)
                     + "\n")
    return root, calib_root
