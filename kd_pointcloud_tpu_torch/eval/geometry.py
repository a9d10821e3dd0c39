"""3D -> 2D projection for EPE2D / ACC2D.

The port's copy of kd_pointcloud_tpu/eval/geometry.py (reference
utils/geometry.py:6-65). KITTI scenes project through the per-scene
P_rect_02 intrinsics read from the calib_cam_to_cam files; FT3D uses the
fixed synthetic camera (f = -1050, cx = 479.5, cy = 269.5). numpy only.

The reference checkout keeps its datasets in <checkout>/datasets and the
KITTI calibration in <checkout>/utils/calib_cam_to_cam; calib_dir_for maps
a data root laid out so to its calibration directory.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

FT3D_INTRINSICS = dict(f=-1050.0, cx=479.5, cy=269.5,
                       constx=0.0, consty=0.0, constz=0.0)
INTRINSIC_KEYS = ("f", "cx", "cy", "constx", "consty", "constz")


def calib_dir_for(data_root: str) -> str:
    """<checkout>/utils/calib_cam_to_cam for data_root <checkout>/datasets."""
    parent = osp.dirname(osp.normpath(osp.abspath(data_root)))
    return osp.join(parent, "utils", "calib_cam_to_cam")


def is_kitti(path: str) -> bool:
    """A KITTI scene by its path (utils/geometry.py:7)."""
    return "KITTI" in path or "kitti" in path


def project_3d_to_2d(pc, f=-1050.0, cx=479.5, cy=269.5,
                     constx=0.0, consty=0.0, constz=0.0):
    x = (pc[..., 0] * f + cx * pc[..., 2] + constx) / (pc[..., 2] + constz)
    y = (pc[..., 1] * f + cy * pc[..., 2] + consty) / (pc[..., 2] + constz)
    return x, y


def read_kitti_intrinsics(scene_name: str, calib_dir: str):
    """Parse P_rect_02 from a KITTI calib file -> intrinsics dict
    (utils/geometry.py:14-31; f = -P[0,0], the sign mirrors the
    preprocessing's x-flip)."""
    path = osp.join(calib_dir, scene_name + ".txt")
    with open(path) as fd:
        for line in fd:
            if line.startswith("P_rect_02"):
                P = np.array([float(v) for v in line.split()[1:]],
                             dtype=np.float32).reshape(3, 4)
                return dict(f=-P[0, 0], cx=P[0, 2], cy=P[1, 2],
                            constx=P[0, 3], consty=P[1, 3], constz=P[2, 3])
    raise ValueError(f"no P_rect_02 in {path}")


def get_batch_2d_flow(pc1, pc2, predicted_pc2, paths, calib_dir=None):
    """Project batched clouds to pixel flows.

    Args:
      pc1/pc2/predicted_pc2: (B, N, 3).
      paths: per-sample scene paths; a KITTI path in paths[0] selects the
        per-scene intrinsics from calib_dir (utils/geometry.py:7).
    Returns:
      (flow_pred, flow_gt): (B, N, 2) pixel flows.
    """
    if is_kitti(paths[0]):
        if calib_dir is None:
            raise ValueError("KITTI scenes need calib_dir for the 2-D "
                             "metrics")
        intr = [read_kitti_intrinsics(osp.split(p)[-1], calib_dir)
                for p in paths]
        kw = {k: np.array([i[k] for i in intr])[:, None]
              for k in INTRINSIC_KEYS}
    else:
        kw = dict(FT3D_INTRINSICS)

    px1, py1 = project_3d_to_2d(pc1, **kw)
    px2, py2 = project_3d_to_2d(predicted_pc2, **kw)
    px2_gt, py2_gt = project_3d_to_2d(pc2, **kw)

    flow_pred = np.stack([px2 - px1, py2 - py1], axis=-1)
    flow_gt = np.stack([px2_gt - px1, py2_gt - py1], axis=-1)
    return flow_pred, flow_gt
